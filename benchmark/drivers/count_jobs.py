"""Whole file-to-table jobs back to back in this process, each the
program's CLI entry ``kmers_tpu_torch.__main__.main(["count", <fastq>,
...])`` writing its table to an .npz.  The window ends with the job that
is running when its seconds have passed.

Parameters (``traffic/<mix>.json``): ``extra_args`` (more CLI
arguments), ``warm_jobs`` (whole jobs in set-up), ``keep_one_in`` (about
one job in this many keeps its table for the comparison; the first
always)."""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.harness.mixes import EXACT, Mix, table_differences, \
    table_words
from benchmark.harness.tracing import span


class Driver(Mix):
    unit = "job"

    def setup(self) -> None:
        self.write_reads()
        warm = os.path.join(self.ctx.workdir, "warm.npz")
        with self.ctx.part("warm_jobs"):
            for _ in range(self.ctx.traffic["warm_jobs"]):
                rc = self.run_count(warm)
                if rc != 0:
                    raise RuntimeError(f"a warm-up job exited {rc}")
        os.remove(warm)
        self.rng = np.random.default_rng(self.ctx.seeds["sample"])

    def window(self, seconds: float) -> None:
        """Jobs back to back until `seconds` have passed.  A job the seed
        samples (the first always) keeps its table; the others write one
        shared path, each replacing the last, so that only the last of
        them is left to compare."""
        keep_one_in = self.ctx.traffic["keep_one_in"]
        rest = os.path.join(self.ctx.workdir, "rest.npz")
        start = time.perf_counter()
        while True:
            i = len(self.units)
            kept = i == 0 or self.rng.random() * keep_one_in < 1
            out = os.path.join(self.ctx.workdir, f"job{i}.npz") if kept \
                else rest
            with span(self.unit, self.ctx.trace):
                t0 = time.perf_counter()
                rc = self.run_count(out)
                t1 = time.perf_counter()
            self.units.append(dict(start=t0, end=t1, rc=rc, out=out))
            if t1 - start >= seconds:
                return

    def check(self) -> dict:
        """Every job's exit code; the table and k-mer total of every job
        whose table is left (the sampled ones and the last of the rest)
        against the reference."""
        want = self.reference_table()
        total = int(want[2].sum())
        last_rest = max((i for i, job in enumerate(self.units)
                         if not job["out"].endswith(f"job{i}.npz")),
                        default=None)
        failed_jobs = keys_off = counts_off = kmers_off = checked = 0
        for i, job in enumerate(self.units):
            if job["rc"] != 0:
                failed_jobs += 1
                continue
            if not (job["out"].endswith(f"job{i}.npz") or i == last_rest):
                continue
            with np.load(job["out"]) as z:
                got = table_words(z, self.cfg["k"])
                kmers = int(z["kmers"])
            checked += 1
            k_off, c_off = table_differences(got, want)
            keys_off += k_off
            counts_off += c_off
            kmers_off += abs(kmers - total)
            if k_off or c_off or kmers != total:
                failed_jobs += 1
        return dict(
            checks={"jobs_failed": [failed_jobs, EXACT],
                    "keys_off": [keys_off, EXACT],
                    "counts_off": [counts_off, EXACT],
                    "kmers_off": [kmers_off, EXACT]},
            attempted=len(self.units), failed=failed_jobs,
            work=dict(kmers_per_job=total, distinct=len(want[0]),
                      tables_checked=checked))
