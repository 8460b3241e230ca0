"""make_sharded_lookup's step and the search kernel K12 (kernels/lookup.py):
which of its two paths the step takes (K12 alone, or the routed step), by
the mesh, the arm, the batch's width and form; the short path's answers
against count.lookup and against the routed step of a two-shard mesh over
the same reads; the routed step's answers against lookup_sharded at an
overflowing query_capacity and over empty tables; the step counters;
search_counts' plain version at the edges of a table; and, on the card,
the step against the CPU step and the kernel against its plain version
lane for lane, in a CUDA graph too.

Imports no JAX, so the card's tests run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_direct.py

Without a card those skip; the CPU tests run everywhere."""

import numpy as np
import pytest
import torch

from kmers_tpu_torch import kernels, profiling
from kmers_tpu_torch.core import u64
from kmers_tpu_torch.kernels import lookup as klookup
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline

K, ROWS, LENGTH, LANES = 21, 64, 96, 4096
COUNTERS = ("kmers.lookup.calls", "kmers.lookup.direct")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def reads(seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.ascontiguousarray(np.frombuffer(
        b"ACGT", np.uint8)[rng.integers(0, 4, (ROWS, LENGTH))]))


def cpu_tables(d, seed=3):
    """make_sharded_counter's k = 21 tables of one random read batch over
    a CPU mesh of d shards."""
    m = tmesh.make_mesh(devices=["cpu"] * d)
    res = pipeline.make_sharded_counter(m, K, route_capacity=1 << 13)(
        reads(seed))
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
    MAX, which the routed step must keep ahead of the invalid lanes."""
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


def step_counts(fn):
    """(fn's result, what it added to the step counters) under a
    profiler."""
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    after = profiling.counters()
    return out, tuple(after.get(n, 0) - before.get(n, 0) for n in COUNTERS)


def lookup_step(device, d, capacity, **kw):
    return pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=[device] * d), query_capacity=capacity,
        max_k=K, **kw)


def owners(tables, words, valid, d):
    """count.lookup in each query's owner's table, -1 where invalid."""
    return torch.where(valid, pipeline.lookup_sharded(tables, words, d), -1)


# -- which path a step takes (CPU) ---------------------------------------------

class _Routed(Exception):
    pass


def _fail_route(*args, **kwargs):
    raise _Routed


@pytest.mark.parametrize("devices, kw, lanes, rows, want", [
    (["cpu"], {}, 64, False, "direct"),
    (["cpu"], {"merge_lookup": False}, 64, False, "direct"),
    (["cpu"], {}, 32, False, "direct"),
    (["cpu"], {"shape": (8, 8)}, 64, False, "direct"),
    (["cpu"], {}, 65, False, "routed"),
    (["cpu"], {"merge_lookup": True}, 64, False, "routed"),
    (["cpu"], {}, 64, True, "routed"),
    (["cpu"] * 2, {}, 64, False, "routed"),
    (["cpu"], {"merge_lookup": False}, 65, False, "routed"),
    (["cpu"], {"merge_lookup": True}, 65, False, "routed"),
    (["cpu"] * 4, {}, 64, False, "routed"),
    (["cpu"] * 4, {"seq_shards": 2, "axis": "d"}, 64, False, "routed"),
    (["cpu"] * 4, {"seq_shards": 2, "axis": "s"}, 64, False, "routed"),
    (["cpu"], {"process_count": 2}, 64, False, "routed"),
])
def test_path_by_mesh_arm_width_and_form(monkeypatch, devices, kw, lanes,
                                         rows, want):
    """One shard in one process, the binary search, a plain batch of at
    most query_capacity (64) lanes: the search kernel alone.  A wider
    batch, the merge arm, sharded rows, several shards of one device, a
    two-axis mesh over either axis or two processes: the routed step."""
    kw = dict(kw)
    shape = kw.pop("shape", (lanes,))
    merge = kw.pop("merge_lookup", None)
    axis = kw.pop("axis", "d")
    mesh = tmesh.Mesh(devices, **kw)
    monkeypatch.setattr(pipeline.route_ops, "route_queries", _fail_route)
    searched = []
    monkeypatch.setattr(pipeline.klookup, "search_counts",
                        lambda *args: searched.append(args) or "direct")
    step = pipeline.make_sharded_lookup(mesh, query_capacity=64, max_k=K,
                                        axis=axis, merge_lookup=merge)
    queries = torch.arange(lanes, dtype=torch.int64).reshape(shape)
    valid = torch.ones(shape, dtype=torch.bool)
    if rows:
        queries, valid = (tmesh.ShardedRows([x]) for x in (queries, valid))
    table = tcount.empty_table(16, "cpu")
    try:
        got = step([table] * len(mesh), queries, valid)
    except _Routed:
        got = "routed"
    assert (got if isinstance(got, str) else got[0]) == want
    assert len(searched) == int(want == "direct")


# -- the short path's answers (CPU) ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_short_path_equals_lookup_and_the_two_shard_step(seed):
    """One shard's step, lane for lane: count.lookup and -1 on invalid
    lanes (the MAX-mix word answered), overflow an int64 0; and the routed
    step of a two-shard mesh counting the same reads."""
    (table,) = cpu_tables(1, seed)
    tables2 = cpu_tables(2, seed)
    words, valid = batch([table], 10 + seed)
    counts, overflow = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"]), query_capacity=LANES, max_k=K)(
            [table], words, valid)
    assert counts.dtype == torch.int32 and counts.shape == words.shape
    assert overflow.dtype == torch.int64 and overflow.shape == ()
    assert int(overflow) == 0
    assert torch.equal(counts, torch.where(
        valid, tcount.lookup(table, words), -1))
    assert (counts[:5] == -1).all() and int(counts[5]) >= 0
    assert (counts[valid] > 0).sum() > LANES // 3
    routed, routed_ov = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"] * 2), query_capacity=LANES,
        max_k=K)(tables2, words, valid)
    assert torch.equal(counts, routed)
    assert int(routed_ov) == 0


def test_short_path_keeps_the_batch_shape():
    """A [rows, lanes] batch answers in its shape, as the routed step."""
    (table,) = cpu_tables(1)
    words, valid = batch([table], 4, 64 * 16)
    words, valid = words.reshape(64, 16), valid.reshape(64, 16)
    step = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"]), query_capacity=64 * 16, max_k=K)
    counts, _ = step([table], words, valid)
    assert counts.shape == (64, 16)
    assert torch.equal(counts.reshape(-1), torch.where(
        valid.reshape(-1), tcount.lookup(table, words.reshape(-1)), -1))


@pytest.mark.parametrize("d, lanes, want", [
    (1, LANES, (3, 3)),
    (1, LANES + 1, (3, 0)),
    (2, LANES, (3, 0)),
])
def test_direct_steps_counted_under_a_profiler(d, lanes, want):
    """kmers.lookup.direct counts the steps the search kernel answered
    alone, among kmers.lookup.calls."""
    tables = cpu_tables(d)
    words, valid = batch(tables, 8, lanes)
    step = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"] * d), query_capacity=LANES, max_k=K)
    first, _ = step(tables, words, valid)
    got, counted = step_counts(
        lambda: [step(tables, words, valid) for _ in range(3)])
    assert counted == want
    assert all(torch.equal(c, first) for c, _ in got)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("merge", [None, True])
def test_cpu_step_counts_and_answers(d, merge):
    """On the CPU, at both answer arms, every step counts as a call, the
    one-shard binary search's as direct too, and answers as it does with
    no profiler: count.lookup in each query's owner's table."""
    tables = cpu_tables(d)
    words, valid = batch(tables, 11, 256)
    fn = lookup_step("cpu", d, 256, merge_lookup=merge)
    want, want_ov = fn(tables, words, valid)
    got, counted = step_counts(
        lambda: [fn(tables, words, valid) for _ in range(3)])
    assert counted == (3, 3 if d == 1 and not merge else 0)
    for counts, overflow in got:
        assert torch.equal(counts, want) and int(overflow) == int(want_ov)
    assert torch.equal(want, owners(tables, words, valid, d))


# -- the routed step's answers (CPU) --------------------------------------------

@pytest.mark.parametrize("d", [1, 4])
def test_batches_through_one_step(d):
    """Several query batches through one step: each equal, lane for lane,
    to count.lookup in the owners' tables, the word whose mix is MAX
    answered, invalid lanes -1, overflow 0."""
    tables = cpu_tables(d)
    fn = lookup_step("cpu", d, LANES)
    for seed in range(4):
        words, valid = batch(tables, seed)
        counts, overflow = fn(tables, words, valid)
        assert counts.dtype == torch.int32
        assert torch.equal(counts, owners(tables, words, valid, d))
        assert int(overflow) == 0
        assert int(counts[5]) >= 0 and (counts[:5] == -1).all()


@pytest.mark.parametrize("d", [1, 4])
def test_overflowing_capacity_on_the_cpu(d):
    """A query_capacity below a sender's load to one owner (one shard: a
    batch four times its capacity, which the routed step answers): every
    lane answers its owner's count or -1, invalid lanes -1, and the
    overflow counts the valid lanes dropped."""
    cap = LANES // d // d // 4
    tables = cpu_tables(d)
    fn = lookup_step("cpu", d, cap)
    for seed in (7, 8):
        words, valid = batch(tables, seed)
        counts, overflow = fn(tables, words, valid)
        want = owners(tables, words, valid, d)
        dropped = counts != want
        assert int(overflow) > 0
        assert (counts[dropped] == -1).all() and valid[dropped].all()
        assert int(dropped.sum()) == int(overflow)


@pytest.mark.parametrize("d", [1, 4])
def test_empty_tables_on_the_cpu(d):
    """Tables with no live key, routed (one shard: a batch wider than
    query_capacity, whose valid lanes fit it): 0 for every valid query,
    -1 elsewhere, as lookup_sharded answers."""
    tables = empty_tables(d)
    words, valid = batch(tables, 5)
    cap = int(valid.sum())
    assert cap < LANES
    counts, overflow = lookup_step("cpu", d, cap)(tables, words, valid)
    assert torch.equal(counts, torch.where(valid, 0, -1).to(torch.int32))
    assert torch.equal(counts, owners(tables, words, valid, d))
    assert int(overflow) == 0


@pytest.mark.parametrize("axis", ["d", "s"])
def test_two_axis_mesh_equals_two_shards(axis):
    """A (2, 2) CPU mesh answering over either axis, its tables a
    counter's over the same axis: equal to the two-shard step."""
    rows = reads(50)
    m = tmesh.make_mesh(devices=["cpu"] * 4, seq_shards=2)
    tables = pipeline.make_sharded_counter(
        m, K, route_capacity=1 << 13, axis=axis)(rows).table
    tables2 = pipeline.make_sharded_counter(
        tmesh.make_mesh(devices=["cpu"] * 2), K,
        route_capacity=1 << 13)(rows).table
    words, valid = batch(tables2, 51)
    counts, overflow = pipeline.make_sharded_lookup(
        m, query_capacity=LANES, max_k=K, axis=axis)(tables, words, valid)
    assert torch.equal(counts, owners(tables2, words, valid, 2))
    assert int(overflow) == 0


# -- search_counts at the edges of a table -------------------------------------

def edge_case(name):
    """(keys_hi, keys_lo, counts, n_unique, queries, valid, want) on the
    CPU; want, each query's count whatever its valid lane, from a dict of
    the live keys as unsigned 64-bit ints."""
    rng = np.random.default_rng(len(name))
    top = 1 << 64
    if name == "empty":
        keys = []
    elif name == "one":
        keys = [0x0000_0123_0000_0456]
    elif name == "k32_bit63":
        keys = sorted(set(int(x) for x in rng.integers(
            0, top, 300, dtype=np.uint64)) | {top - 1, 1 << 63, 0})
    elif name == "hi_ties":
        keys = sorted(set((int(h) << 32) | int(l) for h, l in zip(
            rng.integers(0, 3, 200), rng.integers(0, 1 << 32, 200))))
    else:                                         # "padded": k = 31 keys
        keys = sorted(set(int(x) for x in rng.integers(0, 1 << 62, 500)))
    nu, cap = len(keys), len(keys) + 9
    counts = [int(c) for c in rng.integers(1, 1000, nu)]
    table = dict(zip(keys, counts))
    probes = [0, 1, top - 1, 1 << 63, (1 << 63) - 1]
    if keys:
        probes += [keys[0], keys[-1], keys[0] - 1 if keys[0] else 0,
                   (keys[-1] + 1) % top]
        probes += [keys[i] for i in rng.integers(0, nu, 64)]
        probes += [(keys[i] + 1) % top for i in rng.integers(0, nu, 32)]
    probes += [int(x) for x in rng.integers(0, top, 64, dtype=np.uint64)]
    valid = [i % 7 != 3 for i in range(len(probes))]
    want = [table.get(p, 0) for p in probes]

    def plane(vals, shift):
        out = np.zeros(cap, np.uint32)
        out[:nu] = [(v >> shift) & 0xFFFFFFFF for v in vals]
        return torch.from_numpy(out.view(np.int32))

    counts_t = torch.zeros(cap, dtype=torch.int32)
    counts_t[:nu] = torch.tensor(counts, dtype=torch.int32)
    signed = np.array(probes, dtype=np.uint64).view(np.int64)
    return (plane(keys, 32), plane(keys, 0), counts_t, nu,
            torch.from_numpy(signed), torch.tensor(valid),
            torch.tensor(want, dtype=torch.int32))


EDGES = ["empty", "one", "padded", "k32_bit63", "hi_ties"]


@pytest.mark.parametrize("name", EDGES)
@pytest.mark.parametrize("with_valid", [True, False])
def test_plain_search_at_the_edges(name, with_valid):
    """n_unique 0 and 1, zero padding past n_unique, queries below the
    first key, equal to the last and above it, k = 32 words with bit 63
    set, keys that tie on hi: the count of each live key, 0 elsewhere, -1
    on invalid lanes; without valid, no -1."""
    hi, lo, counts, nu, queries, valid, want = edge_case(name)
    got = klookup.search_counts(hi, lo, counts, nu, queries,
                                valid if with_valid else None)
    if with_valid:
        want = torch.where(valid, want, -1)
    assert torch.equal(got, want)
    assert (got > 0).any() == (nu > 0)
    assert torch.equal(got, klookup.search_counts_plain(
        hi, lo, counts, nu, queries, valid if with_valid else None))


@pytest.mark.parametrize("bad, error", [
    ({"n_unique": 99}, ValueError),
    ({"n_unique": -1}, ValueError),
    ({"queries": "int32"}, TypeError),
    ({"valid": "uint8"}, TypeError),
    ({"valid": "short"}, ValueError),
    ({"keys_lo": "short"}, ValueError),
])
def test_search_counts_refuses(bad, error):
    """A count past the planes, query words not int64, a valid plane not
    bool or not the queries' shape, planes of other lengths: raise."""
    hi, lo, counts, nu, queries, valid, _ = edge_case("one")
    args = dict(keys_hi=hi, keys_lo=lo, counts=counts, n_unique=nu,
                queries=queries, valid=valid)
    (key, how), = bad.items()
    if key == "n_unique":
        args[key] = how
    elif how == "short":
        args[key] = args[key][:-1]
    else:
        args[key] = args[key].to(getattr(torch, how))
    with pytest.raises(error):
        klookup.search_counts(**args)


# -- the kernel on the card -----------------------------------------------------

def _to(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGES)
@pytest.mark.parametrize("with_valid", [True, False])
def test_kernel_at_the_edges(card, name, with_valid):
    """K12 against its plain version, lane for lane, at the edges."""
    hi, lo, counts, nu, queries, valid, _ = edge_case(name)
    v = valid if with_valid else None
    want = klookup.search_counts_plain(hi, lo, counts, nu, queries, v)
    kernels.reset_launch_counts()
    got = klookup.search_counts(*_to((hi, lo, counts, nu, queries, v), card))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert kernels.launch_counts()["search_counts"] == 1


def big_case(device, seed=0, nu=1 << 23, lanes=1 << 20):
    """2^20 query lanes over a 2^23-key k = 31 table (2^24 slots): 60 %
    live keys, the rest random 62-bit words, 0.3 % invalid."""
    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.unique(torch.randint(0, 1 << 62, (nu + nu // 64,),
                                      generator=g, device=device))[:nu]
    assert keys.numel() == nu
    hi, lo = u64.split_word(keys)
    cap = 1 << 24
    planes = [torch.zeros(cap, dtype=torch.int32, device=device)
              for _ in range(3)]
    planes[0][:nu], planes[1][:nu] = hi, lo
    planes[2][:nu] = torch.randint(1, 1 << 20, (nu,), generator=g,
                                   device=device, dtype=torch.int32)
    pick = torch.randint(0, nu, (lanes,), generator=g, device=device)
    other = torch.randint(0, 1 << 62, (lanes,), generator=g, device=device)
    hit = torch.rand(lanes, generator=g, device=device) < 0.6
    queries = torch.where(hit, keys[pick], other)
    valid = torch.rand(lanes, generator=g, device=device) >= 0.003
    return (*planes, nu, queries, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("with_valid", [True, False])
def test_kernel_at_the_cells_shape(card, with_valid):
    """2^20 lanes over a 2^23-key table: equal to the plain version."""
    hi, lo, counts, nu, queries, valid = big_case(card)
    v = valid if with_valid else None
    got = klookup.search_counts(hi, lo, counts, nu, queries, v)
    want = klookup.search_counts_plain(hi, lo, counts, nu, queries, v)
    assert torch.equal(got, want)
    assert int((got > 0).sum()) > (1 << 19)


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(card):
    """Captured once and replayed over new queries copied into its input:
    each replay equal to the plain version."""
    hi, lo, counts, nu, queries, valid = big_case(card, seed=1,
                                                  lanes=1 << 16)
    q, v = queries.clone(), valid.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        klookup.search_counts(hi, lo, counts, nu, q, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = klookup.search_counts(hi, lo, counts, nu, q, v)
    for seed in (2, 3):
        g = torch.Generator(device=card).manual_seed(seed)
        q.copy_(torch.where(torch.rand(q.shape, generator=g, device=card)
                            < 0.5, queries.flip(0), queries ^ seed))
        v.copy_(torch.rand(v.shape, generator=g, device=card) >= 0.1)
        graph.replay()
        assert torch.equal(out, klookup.search_counts_plain(
            hi, lo, counts, nu, q, v))


@pytest.mark.cuda
def test_one_card_step_is_one_kernel(card):
    """The one-card step of a batch within query_capacity: one launch of
    K12, answers equal to the CPU's step, overflow 0 on the card."""
    (table,) = cpu_tables(1)
    on_card = [tcount.CountTable(table.keys_hi.to(card),
                                 table.keys_lo.to(card),
                                 table.counts.to(card), table.n_unique)]
    step = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=[card]), query_capacity=LANES, max_k=K)
    ref = pipeline.make_sharded_lookup(
        tmesh.make_mesh(devices=["cpu"]), query_capacity=LANES, max_k=K)
    words, valid = batch([table], 60)
    kernels.reset_launch_counts()
    (counts, overflow), counted = step_counts(
        lambda: step(on_card, words.to(card), valid.to(card)))
    assert counted == (1, 1)
    assert kernels.launch_counts()["search_counts"] == 1
    assert torch.equal(counts.cpu(), ref([table], words, valid)[0])
    assert overflow.device == counts.device and int(overflow) == 0


# -- the routed step on the card ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_batches_through_one_step_on_the_card(card, d):
    """Several query batches through one step on the card (one shard: the
    search kernel alone, its batches fit query_capacity; four shards of
    the card: the routed step): each equal, lane for lane, to the CPU step
    and to count.lookup in the owners' tables."""
    tables = cpu_tables(d)
    fn, ref = lookup_step(card, d, LANES), lookup_step("cpu", d, LANES)
    on_card = to_card(tables, card)
    for seed in range(4):
        words, valid = batch(tables, seed)
        counts, overflow = fn(on_card, words.to(card), valid.to(card))
        want, want_ov = ref(tables, words, valid)
        assert counts.device.type == "cuda" and counts.dtype == torch.int32
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov) == 0
        assert torch.equal(counts.cpu(), owners(tables, words, valid, d))
        assert int(counts[5]) >= 0 and (counts[:5] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_overflowing_capacity(card, d):
    """A query_capacity below a sender's load to one owner: the dropped
    lanes answer -1 and the overflow is summed, as the CPU step's, over
    two batches."""
    cap = LANES // d // d // 4
    tables = cpu_tables(d)
    fn, ref = lookup_step(card, d, cap), lookup_step("cpu", d, cap)
    on_card = to_card(tables, card)
    for seed in (7, 8):
        words, valid = batch(tables, seed)
        counts, overflow = fn(on_card, words.to(card), valid.to(card))
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
    counts, overflow = lookup_step(card, d, LANES)(
        to_card(tables, card), words.to(card), valid.to(card))
    assert torch.equal(counts.cpu(), torch.where(valid, 0, -1).to(
        torch.int32))
    assert int(overflow) == 0


@pytest.mark.cuda
def test_two_axis_mesh_on_one_card(card):
    """A (2, 2) mesh of the card answering over "s": routed, equal to the
    CPU's two-axis step over tables of a counter over the same axis."""
    rows = reads(50)
    steps = []
    for dev in ("cpu", card):
        m = tmesh.make_mesh(devices=[dev] * 4, seq_shards=2)
        tables = pipeline.make_sharded_counter(
            m, K, route_capacity=1 << 13, axis="s")(rows.to(dev)).table
        fn = pipeline.make_sharded_lookup(m, query_capacity=LANES,
                                          max_k=K, axis="s")
        steps.append((fn, tables))
    words, valid = batch(steps[0][1], 51)
    want, want_ov = steps[0][0](steps[0][1], words, valid)
    fn, tables = steps[1]
    for _ in range(2):
        (counts, overflow), counted = step_counts(
            lambda: fn(tables, words.to(card), valid.to(card)))
        assert counted == (1, 0)
        assert torch.equal(counts.cpu(), want)
        assert int(overflow) == int(want_ov)
