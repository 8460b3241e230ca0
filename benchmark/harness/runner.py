"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (and ``busy_s`` / ``window_s`` when traced), ``breakdown``
when traced; for the record ``trace_device_ops``, ``unit_seconds``,
``setup_parts``, ``work`` and ``bytes_written``; and last ``checks``:
each number compared with its limit.  The checks
are also standard error's last lines.  Without a card, or with fewer
cards than the cell asks for, the run prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import peaks, spec, tracing

#: top-level module names that must not be loaded in the run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "kmers_tpu")


class Context:
    """What a mix and a metric reader see of a run."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 workdir: str, trace: bool):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.trace = seed, device, trace
        self.workdir = workdir
        self.n_devices = config.get("devices", 1)
        # independent 32-bit streams of the seed (numpy's RandomState
        # takes seeds below 2^32; --seed may be larger)
        words = np.random.SeedSequence(seed).generate_state(3)
        self.seeds = dict(zip(("reads", "queries", "sample"),
                              (int(w) for w in words)))
        self.setup_parts = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.setup_parts[name] = (self.setup_parts.get(name, 0.0)
                                      + time.perf_counter() - t0)

    def cuda_devices(self) -> list:
        return list(range(self.n_devices)) if self.device == "cuda" else []

    def sync(self) -> None:
        for d in self.cuda_devices():
            torch.cuda.synchronize(d)


class Run:
    """What a metric reader is given: the context, the mix's records
    (``units``: jobs or calls, each with ``start`` / ``end`` seconds),
    the checked work (``work``), the peak memory, set-up time, and in a
    traced run the trace and the peak bandwidth of the card."""

    def __init__(self, ctx: Context, units: list, work: dict,
                 setup_s: float, peak_bytes: int, trace=None,
                 hbm_bytes_per_s: Optional[float] = None):
        self.ctx, self.config = ctx, ctx.config
        self.units, self.work = units, work
        self.setup_s, self.peak_bytes = setup_s, peak_bytes
        self.trace = trace
        self.hbm_bytes_per_s = hbm_bytes_per_s


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _bytes_written() -> Optional[int]:
    """Bytes this process passed to write() (``wchar``): the files a run
    writes, whatever the file system counts."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", root: str = spec.ROOT,
             config: Optional[dict] = None, workdir: Optional[str] = None,
             bench: Optional[dict] = None) -> dict:
    """Run one cell once and return the result (without printing it).
    `config` / `bench` / `workdir` replace the cell's files in tests."""
    started = time.time() - t0
    bench = bench or spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    config = config or spec.load_config(bench, cell["config"], root)
    traffic = spec.load_traffic(cell["traffic"])
    workdir = workdir or os.path.join(root, "build", "benchmark", workload)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ctx = Context(config, traffic, seed, device, workdir, trace)
    # the interpreter, torch and the harness, before this function
    ctx.setup_parts["start"] = started
    entries = (spec.per_layer(bench, workload) if trace
               else spec.end_to_end(bench, workload))
    readers = {m["name"]: spec.load_metric(m["name"]) for m in entries}

    with ctx.part("imports"):
        import kmers_tpu_torch  # noqa: F401  (the system under test)
        for d in ctx.cuda_devices():
            torch.zeros(1, device=f"cuda:{d}")
    card = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    mix = spec.load_driver(traffic["driver"]).Driver(ctx)
    mix.setup()
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(tracing.installed(
                tracing.span_targets(readers.values())))
            with ctx.part("profiler_start"):
                prof = tracing.profile(device == "cuda")
                prof.start()
        for d in ctx.cuda_devices():
            torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.time() - t0
        mix.window(seconds)
        ctx.sync()
        peak = max((torch.cuda.max_memory_allocated(d)
                    for d in ctx.cuda_devices()), default=0)
        if prof is not None:
            prof.stop()
    parsed = None
    if prof is not None:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        parsed = tracing.Trace.load(path)
        os.remove(path)

    mix.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    verdict = mix.check()
    run = Run(ctx, mix.units, verdict["work"], setup_s, peak, parsed,
              peaks.hbm_bytes_per_s(card))

    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = verdict["checks"]
    correct = (verdict["attempted"] > 0 and verdict["failed"] == 0
               and all(v <= limit for v, limit in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": card,
           "count": len(ctx.cuda_devices()) or 1,
           "memory_peak_bytes": int(peak)}
    if device == "cuda":
        dev["power_limit_w"] = peaks.power_limits()[:dev["count"]]
    result = {"correct": correct, "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if parsed is not None:
        window = tracing.Intervals(
            [(min(a for a, _ in parsed.span_list(mix.unit)),
              max(b for _, b in parsed.span_list(mix.unit)))]
            if parsed.span_list(mix.unit) else [])
        if window.items:
            dev["busy_s"] = parsed.busy(window,
                                        ctx.cuda_devices() or None) / 1e6
            dev["window_s"] = window.length / 1e6
            result["breakdown"] = {
                "device_ops": parsed.top_device_ops(window),
                "idle_gaps": parsed.idle_gaps(window)}
        result["trace_device_ops"] = {"ops": len(parsed.device),
                                      "launch_not_found": parsed.unmatched}
    if len(mix.units) <= 64:
        result["unit_seconds"] = [u["end"] - u["start"] for u in mix.units]
    result["setup_parts"] = ctx.setup_parts
    result["work"] = verdict["work"]
    result["bytes_written"] = _bytes_written()
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in checks.items()}
    shutil.rmtree(workdir, ignore_errors=True)
    return result


def main(argv=None, *, t0: float) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {chips} CUDA device(s), found "
              f"{have}; the benchmark does not run on the CPU",
              file=sys.stderr)
        return 1
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=t0, bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
