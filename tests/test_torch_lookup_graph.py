"""make_sharded_lookup's step as CUDA graphs: on one card (one shard, and
four shards of the card) the replayed step against the CPU step and
count.lookup, lane for lane; where the graphs engage, by the mesh, the
devices and the answer arm; and the step counters.

Imports no JAX, so the card's tests run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_graph.py

Without a card those skip; the CPU tests run everywhere."""

import numpy as np
import pytest
import torch

from kmers_tpu_torch import profiling
from kmers_tpu_torch.core import u64
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline

K, ROWS, LENGTH, LANES = 21, 64, 96, 4096


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def cpu_tables(d, seed=3):
    """make_sharded_counter's k = 21 tables of one random read batch over
    a CPU mesh of d shards."""
    rng = np.random.default_rng(seed)
    rows = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (ROWS,
                                                                LENGTH))]
    m = tmesh.make_mesh(devices=["cpu"] * d)
    res = pipeline.make_sharded_counter(m, K, route_capacity=1 << 13)(
        torch.from_numpy(np.ascontiguousarray(rows)))
    assert int(res.metrics["route_overflow"]) == 0
    return res.table


def to_card(tables, device):
    return [tcount.CountTable(t.keys_hi.to(device), t.keys_lo.to(device),
                              t.counts.to(device), t.n_unique)
            for t in tables]


def empty_tables(d, cap=256):
    z = torch.zeros(cap, dtype=torch.int32)
    return [tcount.CountTable(z, z, z, 0) for _ in range(d)]


def batch(tables, seed, n=LANES):
    """n query lanes: keys of the tables, absent words, a fifth invalid
    (lanes 0-4 among them) and lane 5 the real word whose routing mix is
    MAX, which must stay in the valid prefix ahead of them."""
    rng = np.random.default_rng(seed)
    keys = torch.cat([u64.join_planes(t.keys_hi[:t.n_unique],
                                      t.keys_lo[:t.n_unique])
                      for t in tables])
    words = torch.from_numpy(rng.integers(0, 1 << (2 * K), n))
    if keys.numel():
        hit = torch.from_numpy(rng.random(n) < 0.6)
        pick = torch.from_numpy(rng.integers(0, keys.numel(), n))
        words = torch.where(hit, keys[pick], words)
    valid = torch.from_numpy(rng.random(n) >= 0.2)
    valid[:5] = False
    words[5] = u64.feistel_unmix(torch.tensor([-1]), 0)[0]
    valid[5] = True
    return words, valid


def cpu_step(d, capacity):
    return pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"] * d), query_capacity=capacity,
        max_k=K)


def card_step(device, d, capacity):
    return pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=[device] * d), query_capacity=capacity,
        max_k=K)


def direct(tables, words, valid, d):
    """count.lookup in each query's owner's table, -1 where invalid."""
    return torch.where(valid, pipeline.lookup_sharded(tables, words, d), -1)


class Captures:
    """Counts _LookupGraphs._capture's calls (one a key)."""

    def __init__(self, monkeypatch):
        self.n = 0
        capture = pipeline._LookupGraphs._capture

        def counted(graphs, *args):
            self.n += 1
            return capture(graphs, *args)

        monkeypatch.setattr(pipeline._LookupGraphs, "_capture", counted)


def step_counts(fn):
    """(fn's result, what it added to kmers.lookup.calls and .replays)
    under a profiler."""
    names = ("kmers.lookup.calls", "kmers.lookup.replays")
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    after = profiling.counters()
    return out, tuple(after.get(n, 0) - before.get(n, 0) for n in names)


# -- where the graphs engage (CPU) -------------------------------------------

@pytest.mark.parametrize("devices, kw, engaged", [
    (["cuda"], {}, True),
    (["cuda:0"] * 4, {}, True),
    (["cuda:0"] * 4, {"seq_shards": 2}, True),
    (["cuda"], {"merge_lookup": False}, True),
    (["cuda"], {"merge_lookup": True}, False),
    (["cuda:0", "cuda:1"], {}, False),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], {}, False),
    (["cpu"], {}, False),
    (["cpu"] * 4, {}, False),
    (["cuda"], {"process_count": 2}, False),
])
def test_graphs_engage_by_mesh_devices_and_arm(monkeypatch, devices, kw,
                                               engaged):
    """One process, every shard on one card, the binary search: the step
    keeps graphs.  Several cards, the CPU, several processes or the merge
    arm: none, and the step runs eagerly."""
    made, kw = [], dict(kw)
    monkeypatch.setattr(pipeline, "_LookupGraphs",
                        lambda *args: made.append(args) or object())
    merge = kw.pop("merge_lookup", None)
    mesh = tmesh.Mesh(devices, **kw)
    pipeline.make_sharded_lookup(mesh, query_capacity=64, max_k=K,
                                 merge_lookup=merge)
    assert len(made) == int(engaged)
    if engaged:
        assert made[0][0] == mesh[0]


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("merge", [None, True])
def test_cpu_step_stays_eager(d, merge):
    """On the CPU, at both answer arms, every step counts as a call and
    none as a replay, and answers as it does with no profiler."""
    tables = cpu_tables(d)
    words, valid = batch(tables, 11, 256)
    step = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"] * d), query_capacity=256, max_k=K,
        merge_lookup=merge)
    want, want_ov = step(tables, words, valid)
    got, (calls, replays) = step_counts(
        lambda: [step(tables, words, valid) for _ in range(3)])
    assert (calls, replays) == (3, 0)
    for counts, overflow in got:
        assert torch.equal(counts, want) and int(overflow) == int(want_ov)
    assert torch.equal(want, direct(tables, words, valid, d))


# -- the graphed step on the card ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_batches_through_one_capture(card, monkeypatch, d):
    """Several query batches of one shape through one capture: each equal,
    lane for lane, to the CPU step and to count.lookup in the owners'
    tables, the word whose mix is MAX answered, invalid lanes -1."""
    captures = Captures(monkeypatch)
    tables = cpu_tables(d)
    step, ref = card_step(card, d, LANES), cpu_step(d, LANES)
    on_card = to_card(tables, card)
    for seed in range(4):
        words, valid = batch(tables, seed)
        counts, overflow = step(on_card, words.to(card), valid.to(card))
        want, want_ov = ref(tables, words, valid)
        assert counts.device.type == "cuda" and counts.dtype == torch.int32
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov) == 0
        assert torch.equal(counts.cpu(), direct(tables, words, valid, d))
        assert int(counts[5]) >= 0 and (counts[:5] == -1).all()
    assert captures.n == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_overflowing_capacity(card, d):
    """A query_capacity below a sender's load to one owner: the dropped
    lanes answer -1 and the overflow is summed, as the CPU step's, over
    two batches of one capture."""
    cap = LANES // d // d // 4
    tables = cpu_tables(d)
    step, ref = card_step(card, d, cap), cpu_step(d, cap)
    on_card = to_card(tables, card)
    for seed in (7, 8):
        words, valid = batch(tables, seed)
        counts, overflow = step(on_card, words.to(card), valid.to(card))
        want, want_ov = ref(tables, words, valid)
        assert int(want_ov) > 0
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_empty_tables(card, d):
    """Tables with no live key: 0 for every valid query, -1 elsewhere."""
    tables = empty_tables(d)
    words, valid = batch(tables, 5)
    counts, overflow = card_step(card, d, LANES)(
        to_card(tables, card), words.to(card), valid.to(card))
    assert torch.equal(counts.cpu(), torch.where(valid, 0, -1).to(
        torch.int32))
    assert int(overflow) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_results_are_not_aliased(card, d):
    """Two results held at once: the second call's replay leaves the
    first's answers and overflow as they were."""
    cap = LANES // d // d // 4
    tables = cpu_tables(d)
    step, ref = card_step(card, d, cap), cpu_step(d, cap)
    on_card = to_card(tables, card)
    (w1, v1), (w2, v2) = batch(tables, 21), batch(tables, 22)
    first = step(on_card, w1.to(card), v1.to(card))
    second = step(on_card, w2.to(card), v2.to(card))
    for (counts, overflow), (w, v) in zip((first, second),
                                          ((w1, v1), (w2, v2))):
        want, want_ov = ref(tables, w, v)
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov)
    assert first[0].data_ptr() != second[0].data_ptr()
    assert first[1].data_ptr() != second[1].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_new_table_or_shape_recaptures(card, monkeypatch, d):
    """A new table, or a batch of a new length, is captured anew and
    answers as the CPU step; a key seen before replays its capture."""
    captures = Captures(monkeypatch)
    t1, t2 = cpu_tables(d, 3), cpu_tables(d, 4)
    step, ref = card_step(card, d, LANES), cpu_step(d, LANES)
    c1, c2 = to_card(t1, card), to_card(t2, card)
    calls = [(t1, c1, LANES), (t2, c2, LANES), (t1, c1, LANES // 2),
             (t1, c1, LANES), (t2, c2, LANES)]
    for i, (tables, on_card, n) in enumerate(calls):
        words, valid = batch(tables, 30 + i, n)
        counts, overflow = step(on_card, words.to(card), valid.to(card))
        want, want_ov = ref(tables, words, valid)
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov)
    assert captures.n == 3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_replays_counted_under_a_profiler(card, d):
    """Under a profiler every call is a replay of the capture the first
    call (outside it) made; sharded rows run eagerly and count as calls
    only."""
    tables = cpu_tables(d)
    step = card_step(card, d, LANES)
    on_card = to_card(tables, card)
    words, valid = batch(tables, 40)
    words, valid = words.to(card), valid.to(card)
    want, _ = step(on_card, words, valid)
    got, counted = step_counts(
        lambda: [step(on_card, words, valid) for _ in range(5)])
    assert counted == (5, 5)
    assert all(torch.equal(c, want) for c, _ in got)
    mesh = tmesh.make_mesh(devices=[card] * d)
    rows = (tmesh.ShardedRows(tmesh.batch_sharding(words, mesh)),
            tmesh.ShardedRows(tmesh.batch_sharding(valid, mesh)))
    (counts, _), counted = step_counts(lambda: step(on_card, *rows))
    assert counted == (1, 0)
    assert torch.equal(counts, want)


@pytest.mark.cuda
def test_two_axis_mesh_on_one_card(card):
    """A (2, 2) mesh of the card answering over "s": graphed, equal to the
    CPU's two-axis step over tables of a counter over the same axis."""
    rng = np.random.default_rng(50)
    rows = torch.from_numpy(np.ascontiguousarray(np.frombuffer(
        b"ACGT", np.uint8)[rng.integers(0, 4, (ROWS, LENGTH))]))
    steps = []
    for dev in ("cpu", card):
        m = tmesh.make_mesh(devices=[dev] * 4, seq_shards=2)
        tables = pipeline.make_sharded_counter(
            m, K, route_capacity=1 << 13, axis="s")(rows.to(dev)).table
        step = pipeline.make_sharded_lookup(m, query_capacity=LANES,
                                            max_k=K, axis="s")
        steps.append((step, tables))
    words, valid = batch(steps[0][1], 51)
    want, want_ov = steps[0][0](steps[0][1], words, valid)
    step, tables = steps[1]
    for _ in range(2):
        (counts, overflow), counted = step_counts(
            lambda: step(tables, words.to(card), valid.to(card)))
        assert counted == (1, 1)
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov)
