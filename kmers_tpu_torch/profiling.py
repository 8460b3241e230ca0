"""Tracing, timing and roofline accounting (counterpart of
``kmers_tpu/profiling.py``).

  * ``span`` / ``add`` / ``counters``: the program's own spans and
    counters at its layer boundaries (``SPANS``, ``COUNTERS``), on only
    while a torch profiler records this process.
  * ``trace(logdir)``: a ``torch.profiler`` trace of any block, every
    thread, written to ``logdir/trace.json`` (Chrome trace format: open
    it in chrome://tracing or Perfetto), and the block's counters to
    ``logdir/counters.json``.
  * ``Timer``: wall-clock rounds.
  * ``device_hbm_gbps`` / ``roofline``: a measured rate against the card's
    peak HBM bandwidth.
  * ``MetricsAccumulator``: sums the pipelines' metric dicts (reads,
    kmers_emitted, windows_skipped, route_overflow, route_bytes).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: NVIDIA's published peak HBM bandwidth (GB/s) by a substring of
#: torch.cuda.get_device_name: the H100 data sheet (SXM5 80 GB HBM3,
#: PCIe 80 GB HBM2e, NVL 94 GB HBM3)
HBM_GBPS = {"H100 80GB HBM3": 3350.0, "H100 PCIe": 2000.0,
            "H100 NVL": 3900.0}
#: the environment variable that overrides the table (GB/s)
HBM_ENV = "KMERS_TPU_TORCH_HBM_GBPS"


def device_hbm_gbps(device=None) -> float:
    """Peak HBM bandwidth (GB/s) of a CUDA device (default: the current
    one), from ``HBM_GBPS`` by the device's name; ``HBM_ENV`` overrides.

    An unknown card raises rather than borrowing another's peak (a wrong
    peak makes every roofline share fiction), and so does a CPU device:
    the table holds no figure but NVIDIA's."""
    override = os.environ.get(HBM_ENV)
    if override:
        return float(override)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"no HBM peak for a {dev.type} device: set "
                           f"{HBM_ENV}")
    name = torch.cuda.get_device_name(dev)
    for key, gbps in HBM_GBPS.items():
        if key in name:
            return gbps
    raise RuntimeError(f"unknown CUDA device {name!r}: add its peak HBM GB/s "
                       f"to profiling.HBM_GBPS or set {HBM_ENV}")


# -- spans and counters ------------------------------------------------------

#: every span the program records, by name: where it sits
SPANS = {
    "kmers.ingest.wait": "io.fastx.prefetch, consumer: the blocking get of "
                         "the parser thread's next batch",
    "kmers.ingest.parse": "io.fastx.prefetch, parser thread: one next() of "
                          "the wrapped reader (read, allocate, native pack); "
                          "a cpu_op range, seen by an all-threads trace",
    "kmers.emit": "StreamingCounter.update / update_packed up to _absorb: "
                  "one batch's upload and count (a sharded counter's: "
                  "its split, windows, routing and shard tables)",
    "kmers.emit.upload": "kmers.emit's host-to-device copies (_to_device)",
    "kmers.emit.count": "kmers.emit's pipeline.count_reads* (windows, unit "
                        "or run-length table)",
    "kmers.shard.split": "a sharded step's batch_sharding: this process's "
                         "rows cut into one block a local shard, each "
                         "copied to its device",
    "kmers.shard.windows": "a sharded count step's windows and canonical "
                           "words, every local shard's in turn",
    "kmers.route.bucket": "route / route_wide / route_payload, senders: the "
                          "owner mix and sort, and each pass's send buffers",
    "kmers.route.exchange": "route's exchange: one pass's mesh.all_to_all "
                            "(copies between the shards' devices, or one "
                            "all_to_all_single across processes)",
    "kmers.route.unmix": "route, receivers: feistel_unmix of the words each "
                         "local shard received",
    "kmers.shard.table": "a sharded count step's _shard_table: each local "
                         "shard's table of its received lanes",
    "kmers.consolidate.gather": "ShardedStreamingCounter._consolidate: "
                                "pipeline.gather_tables of the pending shard "
                                "tables onto the table's device, before "
                                "kmers.consolidate",
    "kmers.consolidate": "StreamingCounter._consolidate: pending tables "
                         "into the table",
    "kmers.consolidate.sort": "the pending unit keys' sort (_sort_units, "
                              "_sort_units_wide)",
    "kmers.consolidate.merge": "merge_table_with_sorted_units(_wide) (K3 / "
                               "K6, K4), or merge_many(_wide)",
    "kmers.consolidate.bound": "_bound_table: the slice, or eviction past "
                               "capacity",
    "kmers.save": "StreamingCounter.save after its consolidation",
    "kmers.save.fetch": "convert.table_to_numpy: the table's copy home",
    "kmers.save.write": "np.savez of the temp file and os.replace",
    "kmers.lookup.route": "make_sharded_lookup's step: batch_sharding and "
                          "route.route_queries (graphed: the batch's copy "
                          "into the graphs' buffers and their replay)",
    "kmers.lookup.answer": "make_sharded_lookup's step: each shard's "
                           "count.lookup / lookup_merge and where (graphed: "
                           "their replay; one shard: the search kernel over "
                           "the whole batch)",
    "kmers.lookup.reply": "make_sharded_lookup's step: reply, the answers' "
                          "concatenation on mesh[0], the overflow psum "
                          "(graphed: their replay and the results' copies)",
}
#: every counter the program keeps, by name: what it adds up
COUNTERS = {
    "kmers.ingest.batches": "items prefetch's consumer took from the queue",
    "kmers.ingest.ready": "of those, items already queued when asked",
    "kmers.ingest.parse_ns": "wall ns inside kmers.ingest.parse "
                             "(time.perf_counter_ns)",
    "kmers.ingest.parse_cpu_ns": "the parser thread's CPU ns inside "
                                 "kmers.ingest.parse (time.thread_time_ns)",
    "kmers.route.exchanges": "route's exchanges (kmers.route.exchange): "
                             "mesh.all_to_all calls, one a routing pass",
    "kmers.route.cross_bytes": "bytes of the exchanges' send-buffer rows "
                               "bound for another shard than their sender "
                               "(from the shapes: each local sender's D - 1 "
                               "rows, every plane and the mask)",
    "kmers.route.recv_bytes_max": "the most such bytes any one shard "
                                  "received in an exchange (D - 1 rows; "
                                  "the buffers have one shape), summed "
                                  "over the exchanges",
    "kmers.lookup.calls": "make_sharded_lookup's steps run",
    "kmers.lookup.direct": "of those, steps answered by the one-shard "
                           "search kernel, without routing",
    "kmers.lookup.replays": "of those, steps answered by replaying their "
                            "CUDA graphs (one card, binary search)",
}

_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def _known(name: str, table: dict) -> str:
    if name not in table:
        raise KeyError(f"{name!r} is not in profiling's table")
    return name


class _TimedSpan:
    """A span that also adds its wall and thread-CPU ns to two counters.
    Its range is a ``_RecordFunctionFast`` (a ``cpu_op`` in the trace),
    which keeps the interpreter lock: ``record_function``'s op call
    releases it on entry and exit, and a thread working beside a busy
    one then waits a switch interval (5 ms) to get it back, each time."""

    __slots__ = ("_span", "_wall_ns", "_cpu_ns", "_t0", "_c0")

    def __init__(self, name: str, wall_ns: str, cpu_ns: str):
        from torch._C._profiler import _RecordFunctionFast

        self._span = _RecordFunctionFast(name)
        self._wall_ns = _known(wall_ns, COUNTERS)
        self._cpu_ns = _known(cpu_ns, COUNTERS)

    def __enter__(self):
        self._span.__enter__()
        self._t0, self._c0 = time.perf_counter_ns(), time.thread_time_ns()

    def __exit__(self, *exc):
        add(self._wall_ns, time.perf_counter_ns() - self._t0)
        add(self._cpu_ns, time.thread_time_ns() - self._c0)
        return self._span.__exit__(*exc)


def span(name: str, wall_ns: Optional[str] = None,
         cpu_ns: Optional[str] = None):
    """A ``record_function`` range named `name` (a key of ``SPANS``)
    while a torch profiler records (torch's process-wide flag, true on
    every thread), else a shared no-op context: no ``record_function``,
    clock read or allocation.  With `wall_ns` and
    `cpu_ns` (keys of ``COUNTERS``) it also adds its wall time and its
    thread's CPU time to them."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    _known(name, SPANS)
    if wall_ns is None:
        return torch.profiler.record_function(name)
    return _TimedSpan(name, wall_ns, cpu_ns)


def add(name: str, n: int = 1) -> None:
    """Add `n` to the process-wide counter `name` (a key of
    ``COUNTERS``) while a profiler records; any thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    _known(name, COUNTERS)
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A snapshot of every counter's total since the process started
    (each grows only while a profiler records)."""
    with _counts_lock:
        return dict(_counts)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed block (CPU on every thread,
    so the parser's ``kmers.ingest.parse`` too, and CUDA where a card is
    present), written to ``logdir/trace.json`` on exit, and what the
    block added to each counter to ``logdir/counters.json``."""
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    with torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        yield
    after = counters()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump({name: after.get(name, 0) - before.get(name, 0)
                   for name in COUNTERS}, f, indent=1)


class Timer:
    """Wall-clock rounds.  Warm up first, and end each round on a value
    read back from the device (or ``torch.cuda.synchronize()``): the host
    clock alone times the enqueue."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def round(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    def rate(self, items: int) -> float:
        """items/s at the best round."""
        return items / self.best


def roofline(rate_items_per_s: float, bytes_per_item: float,
             device=None) -> Dict[str, float]:
    """Achieved against peak HBM bandwidth for a measured op."""
    peak = device_hbm_gbps(device) * 1e9
    achieved = rate_items_per_s * bytes_per_item
    return {
        "achieved_gbps": achieved / 1e9,
        "peak_gbps": peak / 1e9,
        "fraction": achieved / peak,
    }


class MetricsAccumulator:
    """Sums the metric dicts that pipeline steps return."""

    def __init__(self):
        self.totals: Dict[str, int] = {}
        self.steps = 0

    def update(self, metrics: Dict) -> None:
        for k, v in metrics.items():
            self.totals[k] = self.totals.get(k, 0) + int(v)
        self.steps += 1

    def __getitem__(self, key: str) -> int:
        return self.totals.get(key, 0)

    def summary(self) -> Dict[str, int]:
        return dict(self.totals, steps=self.steps)
