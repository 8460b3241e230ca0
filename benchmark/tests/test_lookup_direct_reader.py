"""The reader of ``lookup_direct_pct.lookup``: the program's counters
``kmers.lookup.direct`` over ``kmers.lookup.calls`` from a synthetic
counter snapshot, and nothing on a program that keeps neither."""

import pytest

from benchmark.harness.spec import load_metric
from benchmark.tests.test_harness_metrics import run_of
from benchmark.tests.test_program_span_readers import call_trace

NAME = "lookup_direct_pct.lookup"
CALLS = [dict(start=float(i), end=i + 0.5, pool=i) for i in range(3)]


def counted(monkeypatch, snapshot):
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot),
                        raising=False)
    return load_metric(NAME).read(run_of(call_trace(), units=CALLS))


@pytest.mark.parametrize("calls, direct, want", [
    (3950, 3950, 100.0),
    (40, 39, 100 * 39 / 40),
    (40, 0, 0.0),
])
def test_reads_the_share_of_direct_steps(monkeypatch, calls, direct, want):
    got = counted(monkeypatch, {"kmers.lookup.calls": calls,
                                "kmers.lookup.direct": direct,
                                "kmers.lookup.replays": 0,
                                "kmers.ingest.batches": 7})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("snapshot", [
    {},
    {"kmers.ingest.batches": 60, "kmers.ingest.ready": 45},
    {"kmers.lookup.calls": 0, "kmers.lookup.direct": 0},
    {"kmers.lookup.direct": 5},
    {"kmers.lookup.calls": 2600, "kmers.lookup.replays": 2600},
])
def test_none_without_its_counters(monkeypatch, snapshot):
    """A program without the counter (the parent of the one-shard step,
    whose calls replay graphs instead), or a window with no step, leaves
    the metric out."""
    assert counted(monkeypatch, snapshot) is None


def test_none_without_a_counters_function(monkeypatch):
    from kmers_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_metric(NAME).read(run_of(call_trace(), units=CALLS)) is None
