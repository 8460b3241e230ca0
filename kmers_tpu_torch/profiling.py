"""Tracing, timing and roofline accounting (counterpart of
``kmers_tpu/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of any block,
    written to ``logdir/trace.json`` (Chrome trace format: open it in
    chrome://tracing or Perfetto).
  * ``Timer``: wall-clock rounds.
  * ``device_hbm_gbps`` / ``roofline``: a measured rate against the card's
    peak HBM bandwidth.
  * ``MetricsAccumulator``: sums the pipelines' metric dicts (reads,
    kmers_emitted, windows_skipped, route_overflow, route_bytes).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed block (CPU, and CUDA where a
    card is present), written to ``logdir/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
