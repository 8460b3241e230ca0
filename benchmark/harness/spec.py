"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout names the cells and metrics; each configuration, traffic mix and
metric is a file of its own under ``benchmark/``:

  configs/<config>.json     the deployment (sizes, k, capacity, devices)
  traffic/<mix>.json        the mix: its driver's name and parameters
  drivers/<driver>.py       a driver of traffic (``Driver``, see mixes.py)
  metrics/<metric>.py       a reader: read(run) -> number or None

A new cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as BENCHMARK.json's `file` names it."""
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load_module(folder: str, name: str):
    """<folder>/<name>.py as a module (names may hold dots and dashes, so
    it is loaded by path)."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name: str):
    """metrics/<name>.py: the reader of one metric."""
    return _load_module("metrics", name)


def load_driver(name: str):
    """drivers/<name>.py: a driver of traffic, which defines ``Driver``."""
    return _load_module("drivers", name)


def _reports(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def end_to_end(bench: dict, cell: str) -> list:
    """The end-to-end metric entries that `cell` reports."""
    return [m for m in bench["end_to_end"] if _reports(m, cell)]


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metric entries that `cell` reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if ("workloads" in m and cell in m["workloads"])
            or ("workloads" not in m and m["moves"] in moved)]


def entry(bench: dict, name: str) -> Optional[dict]:
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == name:
            return m
    return None
