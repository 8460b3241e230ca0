"""The readers of the program's own spans and counters (``kmers.*``,
recorded by ``kmers_tpu_torch.profiling``), from synthetic traces that
hold the harness's spans with the program's nested inside them and from
a synthetic counter snapshot; and the same readers on a program that
records none of them, where each leaves its metric out."""

import pytest

from benchmark.harness import tracing
from benchmark.harness.spec import load_metric
from benchmark.tests.test_harness_metrics import dev, host, launch, run_of


def job_trace():
    """The two jobs of ``test_harness_metrics.job_trace`` (harness spans
    and device operations alike), with the program's spans nested in the
    harness's: kmers.emit 305-345 and 1105-1150 (one kernel, one copy,
    one kernel), a kmers.consolidate.sort around the first merge launch,
    and each save's kmers.save.fetch and kmers.save.write (100 and 80
    us, 60 and 200 us)."""
    return tracing.Trace([
        host("job", 0, 1000), host("job", 1000, 1000),
        host("ingest_wait", 0, 300), host("ingest_wait", 1000, 50),
        host("update_packed", 300, 100), host("consolidate", 350, 40),
        host("save", 600, 300), host("consolidate", 650, 50),
        host("update_packed", 1100, 100), host("save", 1500, 300),
        launch(310, 1), dev("kernel", "k1", 320, 10, 1),
        launch(312, 2), dev("gpu_memcpy", "HtoD", 335, 5, 2),
        launch(360, 3), dev("kernel", "merge", 370, 20, 3),
        launch(660, 4), dev("kernel", "merge", 700, 30, 4),
        launch(1110, 5), dev("kernel", "k1", 1120, 10, 5),
        dev("kernel", "orphan", 1900, 40, 99),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
        host("kmers.emit", 305, 40), host("kmers.emit", 1105, 45),
        host("kmers.consolidate.sort", 355, 10),
        host("kmers.save.fetch", 710, 100), host("kmers.save.write", 810, 80),
        host("kmers.save.fetch", 1500, 60),
        host("kmers.save.write", 1560, 200),
    ])


def call_trace():
    """The three calls of ``test_harness_metrics.call_trace``, each with
    the program's kmers.lookup.route span around the first kernel's
    launch (8 us of device time)."""
    events = []
    for i in range(3):
        t0 = 1000 * i
        events += [host("lookup_call", t0, 100),
                   host("kmers.lookup.route", t0 + 5, 6),
                   launch(t0 + 10, 10 * i + 1),
                   dev("kernel", "search", t0 + 20, 8, 10 * i + 1),
                   launch(t0 + 12, 10 * i + 2),
                   dev("kernel", "scatter", t0 + 30, 2, 10 * i + 2),
                   launch(t0 + 14, 10 * i + 3),
                   dev("gpu_memcpy", "DtoH", t0 + 40, 5, 10 * i + 3)]
    events += [launch(500, 77), dev("kernel", "between", 500, 50, 77)]
    return tracing.Trace(events)


@pytest.mark.parametrize("name, want", [
    ("emit_host_ms.count", (40 + 45) / 1e3 / 2),
    ("emit_kernels_per_batch.count", 2 / 2),
    ("sort_device_ms.count", 20 / 1e3 / 2),
    ("save_fetch_ms.count", (100 + 60) / 1e3 / 2),
    ("save_write_ms.count", (80 + 200) / 1e3 / 2),
    # the harness's readers read as on the harness's spans alone
    ("emit_device_ms.count", 20 / 1e3 / 2),
    ("consolidate_device_ms.count", 50 / 1e3 / 2),
    ("save_ms.count", (600 - 50) / 1e3 / 2),
    ("ingest_wait_pct.count", 100 * 350 / 2000),
    ("device_idle_pct.count", 100 * (1 - 115 / 2000)),
])
def test_count_span_readers(name, want):
    got = load_metric(name).read(run_of(job_trace()))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("route_device_ms.lookup", 8 / 1e3),
    ("route_kernels_per_call.lookup", 1),
    # the harness's readers read as on the harness's spans alone
    ("lookup_device_ms.lookup", 15 / 1e3),
    ("lookup_kernels_per_call.lookup", 2),
    ("device_idle_pct.lookup", 100 * (1 - 45 / 300)),
])
def test_lookup_span_readers(name, want):
    assert load_metric(name).read(run_of(call_trace())) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("parse_ms.count", 3e9 / 1e6 / 2),
    ("parse_cpu_pct.count", 100 * 2.4e9 / 3e9),
    ("ingest_ready_pct.count", 100 * 45 / 60),
])
def test_counter_readers(monkeypatch, name, want):
    """The program's counters after a window of two jobs: 3 s of parse,
    2.4 s of it on the parser thread's CPU, 45 of 60 batches ready."""
    from kmers_tpu_torch import profiling

    snapshot = {"kmers.ingest.parse_ns": 3 * 10 ** 9,
                "kmers.ingest.parse_cpu_ns": 24 * 10 ** 8,
                "kmers.ingest.batches": 60, "kmers.ingest.ready": 45}
    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot))
    jobs = [dict(start=0.0, end=1.0, rc=0), dict(start=1.0, end=2.0, rc=0)]
    got = load_metric(name).read(run_of(job_trace(), units=jobs))
    assert got == pytest.approx(want)


PROGRAM_READERS = ("parse_ms.count", "parse_cpu_pct.count",
                   "ingest_ready_pct.count", "emit_host_ms.count",
                   "emit_kernels_per_batch.count", "sort_device_ms.count",
                   "save_fetch_ms.count", "save_write_ms.count",
                   "route_device_ms.lookup", "route_kernels_per_call.lookup")


@pytest.mark.parametrize("name", PROGRAM_READERS)
def test_program_readers_without_spans_or_counters(monkeypatch, name):
    """Nothing without a trace, on an empty trace, on a trace of the
    harness's spans alone (a program without the spans), and with no
    counters or a profiling module that keeps none."""
    from kmers_tpu_torch import profiling

    jobs = [dict(start=0.0, end=1.0, rc=0)]
    monkeypatch.setattr(profiling, "counters", dict, raising=False)
    reader = load_metric(name)
    harness_only = tracing.Trace([
        host("job", 0, 1000), host("lookup_call", 0, 100),
        host("update_packed", 300, 100), host("save", 600, 300),
        launch(310, 1), dev("kernel", "k1", 320, 10, 1)])
    for trace in (None, tracing.Trace([]), harness_only):
        assert reader.read(run_of(trace, units=jobs)) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(run_of(harness_only, units=jobs)) is None
