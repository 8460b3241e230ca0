"""Small runs of the harness on the CPU for the tests: the cells' own
configurations and mixes, cut to a genome of 40,000 bp, 6,000 reads and
query batches of 2^14 lanes, run by ``runner.run_cell`` past its look for
a card (``run.py`` itself refuses to run without one)."""

from __future__ import annotations

import time

from benchmark.harness import runner, spec

SMALL = dict(genome_len=40_000, reads=6_000, capacity=1 << 18, batch=512,
             length=256)
SMALL_LOOKUP = dict(batch_lanes=1 << 14, pool_batches=4, keep_one_in=4)


def small_config(cell: str, **changes) -> dict:
    bench = spec.load_benchmark()
    config = spec.load_config(bench, spec.workload(bench, cell)["config"])
    config.update(SMALL, **changes)
    return config


def run(cell: str, workdir, monkeypatch, *, seed: int = 12345,
        seconds: float = 0.5, trace: bool = False, device: str = "cpu",
        small: bool = True) -> dict:
    """One run of `cell` on `device`, at the small size or (small=False)
    at the cell's own."""
    load = spec.load_traffic

    def small_traffic(name):
        traffic = load(name)
        if traffic["driver"] == "lookup_calls":
            traffic.update(SMALL_LOOKUP)
        return traffic

    if small:
        monkeypatch.setattr(spec, "load_traffic", small_traffic)
    return runner.run_cell(cell, seed, seconds, trace, t0=time.time(),
                           device=device, workdir=str(workdir),
                           config=small_config(cell) if small else None)
