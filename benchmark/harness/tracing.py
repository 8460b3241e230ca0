"""Spans and the device trace of a traced run (``--trace 1``).

Spans are the harness's own: in a traced run only, ``installed`` wraps the
program functions that the cell's metric readers name (their ``SPANS``)
in ``torch.profiler.record_function`` ranges, so that each call is a
``user_annotation`` event on the host's timeline.  A target is
``"module:Attr.path"``; ``"iter:module:attr"`` names a function that
returns an iterator, whose every ``next`` is the span (the time the
caller waits for an item).  Nothing of the program is edited, and an
untraced run wraps nothing.

Device time comes from torch.profiler's CUDA activity (kernels, copies,
memsets).  A device operation belongs to a span when the host call that
launched it (the CUDA API event of the same correlation id) lies
inside that span.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
from typing import Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# -- spans ------------------------------------------------------------------

def _resolve(target: str):
    """(owner object, attribute name) of "module:Attr.path"."""
    module_name, path = target.split(":")
    owner = importlib.import_module(module_name)
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    return owner, parts[-1]


def _call_span(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _iter_span(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        inner = fn(*args, **kwargs)
        try:
            while True:
                with torch.profiler.record_function(name):
                    try:
                        item = next(inner)
                    except StopIteration:
                        return
                yield item
        finally:
            close = getattr(inner, "close", None)
            if close is not None:
                close()
    return wrapper


def span_targets(readers: Iterable) -> Dict[str, List[str]]:
    """The union of the readers' SPANS: {span name: [targets]}."""
    out: Dict[str, List[str]] = {}
    for reader in readers:
        for name, targets in getattr(reader, "SPANS", {}).items():
            for t in targets:
                if t not in out.setdefault(name, []):
                    out[name].append(t)
    return out


@contextlib.contextmanager
def installed(spans: Dict[str, List[str]]):
    """Wrap every target in its span for the duration of the block."""
    undo = []
    try:
        for name, targets in spans.items():
            for target in targets:
                is_iter = target.startswith("iter:")
                owner, attr = _resolve(target[5:] if is_iter else target)
                # a method the class inherits is wrapped where it is defined
                original = (owner.__dict__[attr] if isinstance(owner, type)
                            else getattr(owner, attr))
                wrap = _iter_span if is_iter else _call_span
                setattr(owner, attr, wrap(original, name))
                undo.append((owner, attr, original))
        yield
    finally:
        for owner, attr, original in reversed(undo):
            setattr(owner, attr, original)


def span(name: str, on: bool):
    """A span of the harness's own (a job, a call) in a traced run."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def profile(cuda: bool):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


# -- the trace --------------------------------------------------------------

def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(a, b) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Intervals:
    """A merged, sorted interval list with a membership test."""

    def __init__(self, intervals):
        self.items = _merge(list(intervals))
        self._starts = [a for a, _ in self.items]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self._starts, t) - 1
        return i >= 0 and t <= self.items[i][1]

    @property
    def length(self) -> float:
        return _length(self.items)

    def overlap(self, other: "Intervals") -> float:
        return _overlap(self.items, other.items)


class Trace:
    """A Chrome trace of torch.profiler, times in microseconds.

    spans[name]    every user_annotation (host) event of that name,
                   (start, end), in start order
    device         device operations: (cat, name, start, end, device,
                   launch time or None)
    """

    def __init__(self, events: List[dict]):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        launches: Dict[int, float] = {}
        raw_device = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat == "user_annotation":
                self.spans.setdefault(ev["name"], []).append((ts, ts + dur))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat in DEVICE_CATS:
                raw_device.append((cat, ev["name"], ts, ts + dur,
                                   int(args.get("device", 0)),
                                   args.get("correlation")))
        for v in self.spans.values():
            v.sort()
        self.device = [(cat, name, a, b, dev, launches.get(corr))
                       for cat, name, a, b, dev, corr in raw_device]
        self.unmatched = sum(1 for d in self.device if d[5] is None)

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return Trace(data["traceEvents"] if isinstance(data, dict) else data)

    def span_list(self, name: str) -> List[Tuple[float, float]]:
        return self.spans.get(name, [])

    def intervals(self, name: str) -> Intervals:
        return Intervals(self.span_list(name))

    def device_time(self, within: str, outside: Optional[str] = None,
                    cats: Tuple[str, ...] = DEVICE_CATS) -> float:
        """Microseconds of device operations of `cats` launched inside a
        `within` span and not inside an `outside` span."""
        inside = self.intervals(within)
        excluded = self.intervals(outside) if outside else Intervals([])
        total = 0.0
        for cat, _, a, b, _, launch in self.device:
            if cat in cats and launch is not None and launch in inside \
                    and launch not in excluded:
                total += b - a
        return total

    def device_count(self, within: str, cats: Tuple[str, ...]) -> int:
        """Device operations of `cats` launched inside a `within` span."""
        inside = self.intervals(within)
        return sum(1 for cat, _, _, _, _, launch in self.device
                   if cat in cats and launch is not None and launch in inside)

    def devices(self) -> List[int]:
        return sorted({d[4] for d in self.device})

    def busy(self, over, devices: Optional[List[int]] = None) -> float:
        """Microseconds inside `over` (an Intervals) in which an operation
        ran on the device, the mean over `devices` (default: every device
        in the trace)."""
        devices = self.devices() if devices is None else devices
        if not devices:
            return 0.0
        total = 0.0
        for dev in devices:
            ops = Intervals((a, b) for _, _, a, b, d, _ in self.device
                            if d == dev)
            total += _overlap(ops.items, over.items)
        return total / len(devices)

    def top_device_ops(self, over, n: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time
        inside `over`, summed by name."""
        by_name: Dict[str, float] = {}
        for _, name, a, b, _, _ in self.device:
            t = _length(_clip([(a, b)], over.items[0][0], over.items[-1][1]))
            if t:
                by_name[name] = by_name.get(name, 0.0) + t
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t / 1e6] for name, t in top]

    def idle_gaps(self, over, n: int = 10) -> List[list]:
        """[what the host was doing, seconds] of the device's idle time
        inside `over` (no operation on any device), each gap named by the
        innermost span around its middle, summed by name."""
        ops = Intervals((a, b) for _, _, a, b, _, _ in self.device)
        # spans nest (a job holds its batches, a batch its consolidation):
        # the name whose spans are shortest on average is the innermost
        names = sorted(self.spans, key=lambda name: _length(
            self.spans[name]) / len(self.spans[name]))
        members = [(name, self.intervals(name)) for name in names]
        by_name: Dict[str, float] = {}
        for lo, hi in over.items:
            t = lo
            for a, b in _clip(ops.items, lo, hi) + [(hi, hi)]:
                if a > t:
                    mid = (t + a) / 2
                    what = next((name for name, iv in members if mid in iv),
                                "harness")
                    by_name[what] = by_name.get(what, 0.0) + (a - t)
                t = max(t, b)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, t / 1e6] for name, t in top]
