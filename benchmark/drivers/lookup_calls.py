"""A closed loop of one caller: each call sends one batch of query lanes
from the host through ``pipeline.make_sharded_lookup`` on a one-device
mesh (the default answer arm) and is timed from the batch's copy to the
card until its answers are on the host.  The query batches wait on the
host, in pinned memory, as a caller's incoming reads would; the card
holds the table and one call's data.

Parameters (``traffic/<mix>.json``): ``batch_lanes``, ``pool_batches``
(distinct query batches, used in turn), ``warm_calls`` (calls in
set-up), ``keep_one_in`` (about one call in this many keeps its answers
for the comparison; the first and the last always).  The queries are the
canonical k-mers of fresh reads of the table's genome (``query_reads``),
windows with an N invalid lanes."""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchmark.harness import simulate
from benchmark.harness.mixes import EXACT, Mix
from benchmark.harness.tracing import span
from benchmark.reference import kmer_count as ref


class Driver(Mix):
    unit = "lookup_call"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.kept = {}            # call index -> (pool index, host answers)
        self.overflows = []

    def setup(self) -> None:
        from kmers_tpu_torch.parallel import pipeline
        from kmers_tpu_torch.parallel.mesh import make_mesh
        from kmers_tpu_torch.parallel.stream import StreamingCounter

        c, t, ctx = self.cfg, self.ctx.traffic, self.ctx
        self.write_reads()
        table_path = os.path.join(ctx.workdir, "table.npz")
        with ctx.part("count_table"):
            rc = self.run_count(table_path)
        if rc != 0:
            raise RuntimeError(f"counting the table exited {rc}")
        with ctx.part("load_table"):
            self.tables = [StreamingCounter.load(table_path,
                                                 device=ctx.device).table]
            os.remove(table_path)
        lanes, pool = t["batch_lanes"], t["pool_batches"]
        self.lookup = pipeline.make_sharded_lookup(
            make_mesh(devices=[ctx.device]), query_capacity=lanes,
            max_k=c["k"])
        with ctx.part("queries"):
            windows = c["read_len"] - c["k"] + 1
            reads = self.query_reads(pool * math.ceil(lanes / windows))
            _, lo, valid = ref.window_keys(reads, c["k"], ctx.device)
            self.queries = lo[:pool * lanes].reshape(pool, lanes).cpu()
            self.valid = valid[:pool * lanes].reshape(pool, lanes).cpu()
            if ctx.device == "cuda":
                self.queries = self.queries.pin_memory()
                self.valid = self.valid.pin_memory()
            del lo, valid
            self.valid_lanes = self.valid.sum(1).tolist()
        with ctx.part("warm_calls"):
            for i in range(t["warm_calls"]):
                self.call(i % pool)
        self.rng = np.random.default_rng(ctx.seeds["sample"])

    def query_reads(self, n: int) -> np.ndarray:
        """`n` fresh reads of the table's genome, from a seed stream apart
        from the table's reads."""
        c, seeds = self.cfg, self.ctx.seeds
        return np.concatenate(list(simulate.iter_reads(
            c["genome_len"], n, c["read_len"], c["sub_rate"], c["n_rate"],
            seed=seeds["queries"], genome_seed=seeds["reads"])))

    def call(self, p: int):
        """One call of pool batch `p`: (answers on the host, overflow)."""
        dev = self.ctx.device
        queries = self.queries[p].to(dev, non_blocking=True)
        valid = self.valid[p].to(dev, non_blocking=True)
        counts, overflow = self.lookup(self.tables, queries, valid)
        return counts.cpu(), overflow

    def window(self, seconds: float) -> None:
        pool = self.queries.shape[0]
        keep_one_in = self.ctx.traffic["keep_one_in"]
        start = time.perf_counter()
        i = 0
        while True:
            p = i % pool
            with span(self.unit, self.ctx.trace):
                t0 = time.perf_counter()
                host, overflow = self.call(p)
                t1 = time.perf_counter()
            self.units.append(dict(start=t0, end=t1, pool=p))
            self.overflows.append(overflow)
            last = t1 - start >= seconds
            if i == 0 or last or self.rng.random() * keep_one_in < 1:
                self.kept[i] = (p, host)
            i += 1
            if last:
                return

    def release(self) -> None:
        self.tables = self.lookup = None

    def check(self) -> dict:
        dev = self.ctx.device
        want = ref.count_reads(ref.read_fastq(self.fastq), self.cfg["k"],
                               dev)
        overflow = [int(o) for o in self.overflows]
        wrong = {i for i, o in enumerate(overflow) if o}
        answers_off = 0
        expected = {}
        for i, (p, host) in sorted(self.kept.items()):
            if p not in expected:
                queries = self.queries[p].to(dev)
                expected[p] = ref.lookup(want, torch.zeros_like(queries),
                                         queries,
                                         self.valid[p].to(dev)).cpu()
            off = int((host.to(torch.int64) != expected[p]).sum())
            answers_off += off
            if off:
                wrong.add(i)
        return dict(
            checks={"answers_off": [answers_off, EXACT],
                    "overflow": [sum(overflow), EXACT]},
            attempted=len(self.units), failed=len(wrong),
            work=dict(valid_lanes=self.valid_lanes,
                      calls_checked=len(self.kept)))
