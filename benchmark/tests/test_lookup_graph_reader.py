"""The reader of ``lookup_graph_pct.lookup``: the program's counters
``kmers.lookup.replays`` over ``kmers.lookup.calls`` from a synthetic
counter snapshot, and nothing on a program that keeps neither."""

import pytest

from benchmark.harness.spec import load_metric
from benchmark.tests.test_harness_metrics import run_of
from benchmark.tests.test_program_span_readers import call_trace

NAME = "lookup_graph_pct.lookup"
CALLS = [dict(start=float(i), end=i + 0.5, pool=i) for i in range(3)]


def counted(monkeypatch, snapshot):
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot),
                        raising=False)
    return load_metric(NAME).read(run_of(call_trace(), units=CALLS))


@pytest.mark.parametrize("calls, replays, want", [
    (2600, 2600, 100.0),
    (40, 39, 100 * 39 / 40),
    (40, 0, 0.0),
])
def test_reads_the_share_of_replayed_steps(monkeypatch, calls, replays,
                                           want):
    got = counted(monkeypatch, {"kmers.lookup.calls": calls,
                                "kmers.lookup.replays": replays,
                                "kmers.ingest.batches": 7})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("snapshot", [
    {},
    {"kmers.ingest.batches": 60, "kmers.ingest.ready": 45},
    {"kmers.lookup.calls": 0, "kmers.lookup.replays": 0},
    {"kmers.lookup.replays": 5},
    {"kmers.lookup.calls": 5},
])
def test_none_without_its_counters(monkeypatch, snapshot):
    """A program without the counters (the parent of the graphed step), or
    a window with no step, leaves the metric out."""
    assert counted(monkeypatch, snapshot) is None


def test_none_without_a_counters_function(monkeypatch):
    from kmers_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_metric(NAME).read(run_of(call_trace(), units=CALLS)) is None
