"""What every traffic driver shares.  A mix (``traffic/<mix>.json``) is
data: it names its driver (``"driver"``) and gives that driver's
parameters; the configuration gives the sizes.  A driver is a file of
its own, ``drivers/<driver>.py``, found by name (``spec.load_driver``),
that defines ``Driver``, a subclass of ``Mix``.  A new mix of an existing
driver is a new data file; a new driver is a new file beside the others
(it may subclass one of them through ``spec.load_driver``).

A driver makes its inputs in ``setup`` (set-up time), runs the measured
window in ``window``, drops the program's state in ``release``, and after
the window judges what the timed path produced against the plain
reference in ``check``: it returns the numbers compared, each with its
limit, the units attempted and failed, and the work done (``work``) that
the end-to-end metrics count.  Its ``units`` are the window's jobs or
calls, each with its ``start`` and ``end`` (``time.perf_counter``
seconds); ``unit`` names the harness's span around each.
"""

from __future__ import annotations

import os
import traceback

import numpy as np

from ..reference import kmer_count as ref
from . import simulate

#: checks: {name: [value, limit]}; a run is correct iff every value is at
#: most its limit
EXACT = 0


def table_words(z, k: int):
    """The live (hi, lo) uint64 words and int64 counts of a saved table,
    read with numpy from the npz layout (uint32 planes, high word first)."""
    nu = int(z["n_unique"])
    join = lambda a, b: ((z[a][:nu].astype(np.uint64) << np.uint64(32))
                         | z[b][:nu].astype(np.uint64))
    if k <= 32:
        hi, lo = np.zeros(nu, np.uint64), join("keys_hi", "keys_lo")
    else:
        hi, lo = join("keys_hi_hi", "keys_hi_lo"), join("keys_lo_hi",
                                                        "keys_lo_lo")
    return hi, lo, z["counts"][:nu].astype(np.int64)


def host_table(table):
    hi, lo, counts = table
    return (hi.cpu().numpy().view(np.uint64), lo.cpu().numpy().view(np.uint64),
            counts.cpu().numpy())


def table_differences(got, want) -> tuple:
    """(slots whose key differs, slots whose count differs) between two
    host tables; a slot that one table lacks differs in both."""
    n = min(len(got[0]), len(want[0]))
    extra = abs(len(got[0]) - len(want[0]))
    keys = int(((got[0][:n] != want[0][:n]) | (got[1][:n] != want[1][:n]))
               .sum()) + extra
    counts = int((got[2][:n] != want[2][:n]).sum()) + extra
    return keys, counts


class Mix:
    unit = "unit"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.fastq = os.path.join(ctx.workdir, "reads.fastq")
        self.units = []

    def release(self) -> None:
        """Drop the program's state before the reference runs."""

    def write_reads(self) -> None:
        c = self.cfg
        with self.ctx.part("simulate"):
            simulate.write_fastq(self.fastq, c["genome_len"], c["reads"],
                                 c["read_len"], c["sub_rate"], c["n_rate"],
                                 seed=self.ctx.seeds["reads"])

    def count_argv(self, out: str) -> list:
        c = self.cfg
        argv = ["count", self.fastq, "-k", str(c["k"]), "-o", out,
                "--capacity", str(c["capacity"]), "--batch", str(c["batch"]),
                "--length", str(c["length"]), "--device", self.ctx.device]
        return argv + list(self.ctx.traffic.get("extra_args", []))

    def run_count(self, out: str) -> int:
        """One whole job through the program's CLI; a raise is a failed
        job (exit code -1), reported on stderr."""
        from kmers_tpu_torch import __main__ as cli

        try:
            rc = cli.main(self.count_argv(out))
        except Exception:  # a job that raises fails; the window goes on
            traceback.print_exc()
            rc = -1
        self.ctx.sync()
        return rc

    def reference_table(self, canonical: bool = True):
        reads = ref.read_fastq(self.fastq)
        return host_table(ref.count_reads(reads, self.cfg["k"],
                                          self.ctx.device, canonical))
