"""The reader of ``merge_kernel_pct.count``: the program's counters
``kmers.consolidate.reduced`` over ``kmers.consolidate.merges`` from a
synthetic counter snapshot, and nothing on a program that keeps neither."""

import pytest

from benchmark.harness.spec import load_metric
from benchmark.tests.test_harness_metrics import job_trace, run_of

NAME = "merge_kernel_pct.count"


def counted(monkeypatch, snapshot):
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot),
                        raising=False)
    return load_metric(NAME).read(run_of(job_trace()))


@pytest.mark.parametrize("merges, reduced, want", [
    (51, 51, 100.0),
    (16, 12, 100 * 12 / 16),
    (17, 0, 0.0),
])
def test_reads_the_share_of_reduced_merges(monkeypatch, merges, reduced,
                                           want):
    got = counted(monkeypatch, {"kmers.consolidate.merges": merges,
                                "kmers.consolidate.reduced": reduced,
                                "kmers.ingest.batches": 245,
                                "kmers.lookup.calls": 3})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("snapshot", [
    {},
    {"kmers.ingest.batches": 245, "kmers.ingest.ready": 200},
    {"kmers.consolidate.merges": 0, "kmers.consolidate.reduced": 0},
    {"kmers.consolidate.reduced": 16},
    {"kmers.consolidate.merges": 16},
])
def test_none_without_its_counters(monkeypatch, snapshot):
    """A program without the counters (the parent of K13), or a window
    with no table merge, leaves the metric out."""
    assert counted(monkeypatch, snapshot) is None


def test_none_without_a_counters_function(monkeypatch):
    from kmers_tpu_torch import profiling

    monkeypatch.delattr(profiling, "counters")
    assert load_metric(NAME).read(run_of(job_trace())) is None
