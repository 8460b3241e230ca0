"""The cell ``ecoli-k64.count`` (full 128-bit keys: wide run-length batch
tables and weighted re-counts) past the look for its card: at the small
size on the CPU its jobs are correct, traced or not; the forward-word
control and the count faults come out not correct; its readers on a
synthetic trace and counter snapshot, and nothing without the program's
spans or counters.  At the cell's own size on the card (``-m cuda``) the
control fails too."""

import pytest
import torch

from benchmark.harness import spec, tracing
from benchmark.harness.spec import load_metric
from benchmark.tests import tiny
from benchmark.tests.test_harness_control import SEEDS, run_control
from benchmark.tests.test_harness_faults import half_the_batch, \
    state_unchanged
from benchmark.tests.test_harness_metrics import dev, host, job_trace, \
    launch, run_of

CELL = "ecoli-k64.count"
SPAN_READERS = ["runs_device_ms.k64", "recount_device_ms.k64",
                "recount_sort_device_ms.k64", "recount_join_device_ms.k64"]
IDLE = "device_idle_pct.k64"
LANES = "recount_lanes.k64"
#: a re-count's lanes at the small size: the table's 2^18 slots and
#: auto_merge_every's 8 pending tables of 512 x 256 lanes (a row's
#: windows keep its 256 lanes, the last 63 invalid)
SMALL_RECOUNT_LANES = (1 << 18) + 8 * 512 * 256


def numbers(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


def test_the_cell_is_the_k63_deployment_at_k64():
    bench = spec.load_benchmark()
    cell = spec.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("ecoli-k64", "count", 1)
    config = spec.load_config(bench, "ecoli-k64")
    wide = spec.load_config(bench, "ecoli-k63")
    assert config["k"] == 64 and config["reduced"] == []
    assert config["reference"] == "kmer_count"
    shared = set(wide) - {"name", "source", "deployment", "k"}
    assert set(config) == set(wide)
    assert {key: config[key] for key in shared} == \
        {key: wide[key] for key in shared}
    assert {m["name"] for m in spec.per_layer(bench, CELL)} == \
        set(SPAN_READERS) | {IDLE, LANES}
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == \
        {"peak_mem_mib", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_runs_are_correct(tmp_path, monkeypatch, trace):
    from kmers_tpu_torch import profiling

    # the counters are the process's totals: count this run's alone
    monkeypatch.setattr(profiling, "_counts", {})
    result = tiny.run(CELL, tmp_path, monkeypatch, seed=2 ** 32 + 64,
                      trace=trace)
    assert result["correct"] and result["attempted"] >= 1
    assert set(numbers(result).values()) == {0}
    assert result["work"]["distinct"] > 50_000
    if trace:
        # on the CPU the counter reads; the device metrics read nothing
        assert result["metrics"] == {
            LANES: {"value": float(SMALL_RECOUNT_LANES), "unit": "lanes"}}
    else:
        # no card: no peak memory to read
        assert set(result["metrics"]) == {"setup_s"}


def test_control_fails_small(tmp_path, monkeypatch):
    result = run_control(CELL, tmp_path, monkeypatch, "cpu", SEEDS[0], True)
    assert not result["correct"]
    assert numbers(result)["keys_off"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch])
def test_count_faults_are_caught(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = tiny.run(CELL, tmp_path, monkeypatch)
    assert not result["correct"]
    assert result["failed"] == result["work"]["tables_checked"] >= 1
    assert any(numbers(result).values())


# -- the readers ---------------------------------------------------------------

def k64_trace():
    """Two jobs of 1000 us.  Each has one kmers.emit.runs (a sort kernel
    of 20 / 30 us, and in job 1 a copy) and one kmers.consolidate.recount
    holding a .recount.join (a join kernel of 10 / 15 us, and in job 1 a
    memset) and then a .recount.sort (a sort kernel of 40 / 60 us), and
    after the sort a cumsum kernel of 5 / 5 us; one kernel launched
    outside every program span, and one device op whose launch the trace
    lacks."""
    return tracing.Trace([
        host("job", 0, 1000), host("job", 1000, 1000),
        host("kmers.emit.count", 290, 60), host("kmers.emit.runs", 300, 40),
        launch(310, 1), dev("kernel", "sort", 320, 20, 1),
        launch(315, 2), dev("gpu_memcpy", "DtoD", 345, 5, 2),
        host("kmers.consolidate.recount", 400, 100),
        host("kmers.consolidate.recount.join", 402, 16),
        launch(405, 3), dev("kernel", "join", 415, 10, 3),
        launch(410, 8), dev("gpu_memset", "fill", 426, 2, 8),
        host("kmers.consolidate.recount.sort", 420, 30),
        launch(430, 4), dev("kernel", "sort", 440, 40, 4),
        launch(460, 9), dev("kernel", "cumsum", 480, 5, 9),
        launch(600, 7), dev("kernel", "save", 610, 100, 7),
        host("kmers.emit.count", 1290, 60), host("kmers.emit.runs", 1300, 40),
        launch(1310, 5), dev("kernel", "sort", 1320, 30, 5),
        host("kmers.consolidate.recount", 1400, 100),
        host("kmers.consolidate.recount.join", 1402, 16),
        launch(1405, 10), dev("kernel", "join", 1410, 15, 10),
        host("kmers.consolidate.recount.sort", 1420, 30),
        launch(1430, 6), dev("kernel", "sort", 1440, 60, 6),
        launch(1460, 11), dev("kernel", "cumsum", 1500, 5, 11),
        dev("kernel", "lost", 1700, 50, 99),
    ])


@pytest.mark.parametrize("name, want", [
    ("runs_device_ms.k64", (20 + 30) / 1e3 / 2),
    ("recount_device_ms.k64", (10 + 40 + 5 + 15 + 60 + 5) / 1e3 / 2),
    ("recount_sort_device_ms.k64", (40 + 60) / 1e3 / 2),
    ("recount_join_device_ms.k64", (10 + 15) / 1e3 / 2),
])
def test_span_readers(name, want):
    assert load_metric(name).read(run_of(k64_trace())) == pytest.approx(want)


def test_idle_reader():
    """Busy: 20 + 5 + 10 + 2 + 40 + 5 + 100 + 30 + 15 + 60 + 5 + 50 us of
    2000 (every op on the card counts, whether or not its launch is
    known)."""
    busy = 20 + 5 + 10 + 2 + 40 + 5 + 100 + 30 + 15 + 60 + 5 + 50
    assert load_metric(IDLE).read(run_of(k64_trace())) == \
        pytest.approx(100.0 * (1 - busy / 2000))


@pytest.mark.parametrize("name", SPAN_READERS + [IDLE])
def test_device_readers_without_the_spans(name):
    """No trace, or an empty one, leaves every device metric out; a
    program without the span (the count cells' trace) leaves out its
    span's metric."""
    reader = load_metric(name)
    assert reader.read(run_of()) is None
    assert reader.read(run_of(tracing.Trace([]))) is None
    if name != IDLE:
        assert reader.read(run_of(job_trace())) is None


def test_join_reader_on_a_program_without_the_join_span():
    """A trace with the re-count and its sort but no .recount.join (this
    cell's program before the span came) reads nothing for the join and
    the re-count's whole time for the others."""
    t = k64_trace()
    del t.spans["kmers.consolidate.recount.join"]
    assert load_metric("recount_join_device_ms.k64").read(run_of(t)) is None
    assert load_metric("recount_device_ms.k64").read(run_of(t)) == \
        pytest.approx((10 + 40 + 5 + 15 + 60 + 5) / 1e3 / 2)


def counted(monkeypatch, snapshot):
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot),
                        raising=False)
    return load_metric(LANES).read(run_of(job_trace()))


@pytest.mark.parametrize("recounts, lanes", [
    (16, 16 * 33_554_432),
    (3, 3 * SMALL_RECOUNT_LANES),
    (2, 100 + 301),
])
def test_recount_lanes_reader(monkeypatch, recounts, lanes):
    got = counted(monkeypatch, {"kmers.consolidate.recounts": recounts,
                                "kmers.consolidate.recount_lanes": lanes,
                                "kmers.consolidate.merges": 5})
    assert got == pytest.approx(lanes / recounts)


@pytest.mark.parametrize("snapshot", [
    {},
    {"kmers.consolidate.merges": 16, "kmers.consolidate.reduced": 16},
    {"kmers.consolidate.recounts": 0,
     "kmers.consolidate.recount_lanes": 0},
    {"kmers.consolidate.recount_lanes": 33_554_432},
    {"kmers.consolidate.recounts": 16},
])
def test_recount_lanes_without_its_counters(monkeypatch, snapshot):
    assert counted(monkeypatch, snapshot) is None


def test_recount_lanes_without_a_counters_function(monkeypatch):
    from kmers_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_metric(LANES).read(run_of(job_trace())) is None


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_cell_size(seed, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the GPU machine: "
                    "python -m pytest -m cuda benchmark/tests)")
    result = run_control(CELL, tmp_path, monkeypatch, "cuda", seed, False)
    assert not result["correct"]
    assert numbers(result)["keys_off"] > 0
