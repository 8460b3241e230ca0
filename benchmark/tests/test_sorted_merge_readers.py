"""The readers of the k = 32 consolidation's merge of sorted tables:
``sorted_merge_device_ms.k32`` on a synthetic trace,
``sorted_merge_pct.k32`` and ``sorted_merge_lanes.k32`` on synthetic
counter snapshots, and nothing from each on a program without the span
or the counters (the parent of the merge, which re-counts)."""

import pytest

from benchmark.harness import tracing
from benchmark.harness.spec import load_benchmark, load_metric, per_layer
from benchmark.tests.test_harness_metrics import dev, host, job_trace, \
    launch, run_of

CELL = "ecoli-k32.count"
DEVICE = "sorted_merge_device_ms.k32"
PCT = "sorted_merge_pct.k32"
LANES = "sorted_merge_lanes.k32"


def merge_trace():
    """Two jobs of 1000 us, each with one kmers.consolidate.sorted_merge
    (a compaction kernel of 5 / 7 us, merge kernels of 10 + 20 / 30 us, a
    reduction of 15 / 0 us, a copy) and a kernel outside it."""
    return tracing.Trace([
        host("job", 0, 1000), host("job", 1000, 1000),
        host("kmers.consolidate", 390, 200),
        host("kmers.consolidate.sorted_merge", 400, 150),
        launch(405, 1), dev("kernel", "compress", 410, 5, 1),
        launch(420, 2), dev("kernel", "merge", 425, 10, 2),
        launch(440, 3), dev("kernel", "merge", 445, 20, 3),
        launch(470, 4), dev("kernel", "reduce", 480, 15, 4),
        launch(500, 5), dev("gpu_memcpy", "DtoH", 510, 3, 5),
        launch(600, 6), dev("kernel", "save", 610, 100, 6),
        host("kmers.consolidate.sorted_merge", 1400, 100),
        launch(1405, 7), dev("kernel", "compress", 1410, 7, 7),
        launch(1420, 8), dev("kernel", "merge", 1425, 30, 8),
    ])


def test_the_cell_reports_the_three():
    names = {m["name"] for m in per_layer(load_benchmark(), CELL)}
    assert {DEVICE, PCT, LANES} <= names
    for m in load_benchmark()["per_layer"]:
        if m["name"] in (DEVICE, PCT, LANES):
            assert (m["layer"], m["moves"], m["workloads"]) == \
                ("consolidation", "peak_mem_mib", [CELL])


def test_device_reader():
    got = load_metric(DEVICE).read(run_of(merge_trace()))
    assert got == pytest.approx((5 + 10 + 20 + 15 + 7 + 30) / 1e3 / 2)


def test_device_reader_without_the_span():
    """No trace, an empty one, or a program without the span (the count
    cells' trace) leaves the metric out."""
    reader = load_metric(DEVICE)
    assert reader.read(run_of()) is None
    assert reader.read(run_of(tracing.Trace([]))) is None
    assert reader.read(run_of(job_trace())) is None
    assert reader.read(run_of(tracing.Trace([
        host("job", 0, 1000), host("kmers.consolidate.sorted_merge", 10,
                                   5)]))) is None


def counted(monkeypatch, name, snapshot):
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot),
                        raising=False)
    return load_metric(name).read(run_of(job_trace()))


@pytest.mark.parametrize("merges, reduced, want", [
    (16, 16, 100.0), (16, 0, 0.0), (5, 3, 60.0)])
def test_pct_reader(monkeypatch, merges, reduced, want):
    got = counted(monkeypatch, PCT, {
        "kmers.consolidate.sorted_merges": merges,
        "kmers.consolidate.sorted_reduced": reduced,
        "kmers.consolidate.merges": 7, "kmers.consolidate.reduced": 0})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("merges, lanes", [
    (16, 16 * 16_100_000), (3, 3 * 1_310_720), (2, 100 + 301)])
def test_lanes_reader(monkeypatch, merges, lanes):
    got = counted(monkeypatch, LANES, {
        "kmers.consolidate.sorted_merges": merges,
        "kmers.consolidate.sorted_lanes": lanes,
        "kmers.consolidate.recounts": 4,
        "kmers.consolidate.recount_lanes": 33_554_432})
    assert got == pytest.approx(lanes / merges)


@pytest.mark.parametrize("name", [PCT, LANES])
@pytest.mark.parametrize("snapshot", [
    {},
    {"kmers.consolidate.recounts": 16,
     "kmers.consolidate.recount_lanes": 16 * 33_554_432},
    {"kmers.consolidate.sorted_merges": 0,
     "kmers.consolidate.sorted_reduced": 0,
     "kmers.consolidate.sorted_lanes": 0},
    {"kmers.consolidate.sorted_reduced": 16,
     "kmers.consolidate.sorted_lanes": 16},
])
def test_counter_readers_without_their_counters(monkeypatch, name,
                                                snapshot):
    assert counted(monkeypatch, name, snapshot) is None


@pytest.mark.parametrize("name", [PCT, LANES])
def test_counter_readers_without_a_counters_function(monkeypatch, name):
    from kmers_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_metric(name).read(run_of(job_trace())) is None
