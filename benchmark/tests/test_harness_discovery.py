"""Cells, configurations, mixes and metrics are found by name from their
files, and BENCHMARK.json keeps to the shape the harness reads."""

import json
import os
import re

import pytest

from benchmark.harness import mixes, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_are_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    config = spec.load_config(BENCH, w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert config["name"] == w["config"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    traffic = spec.load_traffic(w["traffic"])
    driver = spec.load_driver(traffic["driver"])
    assert issubclass(driver.Driver, mixes.Mix)
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(BENCH, cell)
    assert layers and all(m["moves"] in e2e for m in layers)
    for m in spec.end_to_end(BENCH, cell) + layers:
        assert callable(spec.load_metric(m["name"]).read)


def test_every_metric_has_its_reader_and_every_reader_its_metric():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR,
                                                     "metrics"))
             if f.endswith(".py")}
    assert listed == files


def test_every_config_file_lies_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("benchmark/configs/") for f in files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_a_new_cell_needs_only_entries_and_files():
    """A cell added by entries alone reports the metrics that list it, and
    those without a list whose end-to-end metric it reports."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ecoli-k31.count-evict",
                               "config": "ecoli-k31", "traffic": "count",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "evict_device_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "evict", "moves": "peak_mem_mib",
                               "workloads": ["ecoli-k31.count",
                                             "ecoli-k31.count-evict"]})
    bench["per_layer"].append({"name": "route_ms.lookup", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "lookup",
                               "moves": "lookup_queries_per_s"})
    e2e = {m["name"] for m in spec.end_to_end(bench, "ecoli-k31.count-evict")}
    assert e2e == {"peak_mem_mib", "setup_s"}
    layers = {m["name"] for m in spec.per_layer(bench,
                                                 "ecoli-k31.count-evict")}
    assert layers == {"evict_device_ms"}
    assert "evict_device_ms" in {m["name"] for m in spec.per_layer(
        bench, "ecoli-k31.count")}
    lookup = {m["name"] for m in spec.per_layer(bench, "ecoli-k31.lookup")}
    assert "route_ms.lookup" in lookup and "evict_device_ms" not in lookup


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.workload(BENCH, "no-such.cell")
    with pytest.raises(KeyError):
        spec.load_config(BENCH, "no-such-config")
