"""The whole run, past the look for a card, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have (a step that returns its state unchanged, half of each batch left
out, an answer altered where it is produced), and true unbroken.  Small
sizes on the CPU (``tiny``)."""

import pytest
import torch

from benchmark.tests import tiny
from kmers_tpu_torch import convert
from kmers_tpu_torch.parallel import count as count_ops
from kmers_tpu_torch.parallel import pipeline
from kmers_tpu_torch.parallel.stream import StreamingCounter

COUNT_CELLS = ["ecoli-k31.count", "ecoli-k63.count"]


def numbers(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("cell", COUNT_CELLS + ["ecoli-k31.lookup"])
def test_unbroken_runs_are_correct(cell, tmp_path, monkeypatch):
    result = tiny.run(cell, tmp_path, monkeypatch, seed=2 ** 32 + 17)
    assert result["correct"] and result["attempted"] >= 1
    assert set(numbers(result).values()) == {0}
    assert list(result)[-1] == "checks"


# -- count: the table that the CLI saves ------------------------------------

def state_unchanged(monkeypatch):
    monkeypatch.setattr(StreamingCounter, "update_packed",
                        lambda self, words, validbits: None)


def half_the_batch(monkeypatch):
    update = StreamingCounter.update_packed

    def first_half(self, words, validbits):
        n = words.shape[0] // 2
        update(self, words[:n], validbits[:n])
    monkeypatch.setattr(StreamingCounter, "update_packed", first_half)


def count_altered(monkeypatch):
    to_numpy = convert.table_to_numpy

    def altered(table):
        out = to_numpy(table)
        out["counts"][0] += 1
        return out
    monkeypatch.setattr(convert, "table_to_numpy", altered)


@pytest.mark.parametrize("cell", COUNT_CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   count_altered])
def test_count_faults_are_caught(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = tiny.run(cell, tmp_path, monkeypatch)
    assert not result["correct"]
    assert result["failed"] == result["work"]["tables_checked"] >= 1
    assert any(numbers(result).values())


# -- lookup: the answers of the calls ----------------------------------------

def lookup_unchanged(monkeypatch):
    """The owner's answer step returns its zero state."""
    monkeypatch.setattr(count_ops, "lookup",
                        lambda table, words: torch.zeros(
                            words.shape, dtype=torch.int32,
                            device=words.device))


def _wrap_calls(monkeypatch, change):
    make = pipeline.make_sharded_lookup

    def factory(*args, **kwargs):
        fn = make(*args, **kwargs)

        def call(tables, queries, valid):
            return change(fn, tables, queries, valid)
        return call
    monkeypatch.setattr(pipeline, "make_sharded_lookup", factory)


def lookup_half(monkeypatch):
    def first_half(fn, tables, queries, valid):
        n = queries.shape[0] // 2
        counts, overflow = fn(tables, queries[:n], valid[:n])
        return torch.cat([counts, counts.new_full((queries.shape[0] - n,),
                                                  -1)]), overflow
    _wrap_calls(monkeypatch, first_half)


def lookup_altered(monkeypatch):
    def altered(fn, tables, queries, valid):
        counts, overflow = fn(tables, queries, valid)
        counts = counts.clone()
        counts[int(valid.nonzero()[0])] += 1
        return counts, overflow
    _wrap_calls(monkeypatch, altered)


@pytest.mark.parametrize("fault", [lookup_unchanged, lookup_half,
                                   lookup_altered])
def test_lookup_faults_are_caught(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    result = tiny.run("ecoli-k31.lookup", tmp_path, monkeypatch)
    assert not result["correct"]
    assert result["failed"] >= 1
    assert numbers(result)["answers_off"] > 0


def test_lookup_overflow_is_caught(tmp_path, monkeypatch):
    """Queries dropped in routing (a send budget of a quarter of the
    lanes) read on `overflow`, and on the answers they leave at -1."""
    make = pipeline.make_sharded_lookup

    def small_budget(mesh, *, query_capacity, **kwargs):
        return make(mesh, query_capacity=query_capacity // 4, **kwargs)
    monkeypatch.setattr(pipeline, "make_sharded_lookup", small_budget)
    result = tiny.run("ecoli-k31.lookup", tmp_path, monkeypatch)
    assert not result["correct"]
    assert numbers(result)["overflow"] > 0
    assert numbers(result)["answers_off"] > 0
