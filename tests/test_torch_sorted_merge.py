"""Consolidation of key-sorted count tables by merging
(count.merge_sorted_tables): each pending table's live lanes, merged
pairwise by K3 with B's weights (kernels/merge.py: merge_sorted_weighted),
then with the table's live prefix, then K13 with every lane valid
(reduce_runs(all_valid=True)).  On the CPU, through the plain versions:
the merge and _bound_table against merge_many's re-count and _bound_table,
bit for bit, on keys with bit 63 set, key 0, keys shared by many tables,
padding tables, an empty table, stacked [D, cap] shard tables, counts
that wrap past 2^32 and eviction past capacity; both plain versions
against brute force; the k = 32 counters, one-card and sharded, without
merge_many; the span and counters.  On the card, both variants against
their plain versions at odd lengths and at the k = 32 count cell's
shapes, and one consolidation's peak device memory there.

Imports no JAX, so the card's tests run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_sorted_merge.py

Without a card those skip; the CPU tests run everywhere."""

import numpy as np
import pytest
import torch

from kmers_tpu_torch import kernels, profiling
from kmers_tpu_torch.core import u64
from kmers_tpu_torch.io import fastx
from kmers_tpu_torch.kernels import merge as kmerge
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import stream

MiB = 1 << 20
# K3 WEIGHTED_B's tile and K13's tile at two key planes (csrc/merge.cu)
MERGE_TILE, RUN_TILE = 1536, 2048
COUNTERS = ("kmers.consolidate.sorted_merges",
            "kmers.consolidate.sorted_reduced",
            "kmers.consolidate.sorted_lanes")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- inputs -------------------------------------------------------------------

def full_words(n, g, device, pool=None):
    """n int64 words over the whole 64-bit range (bit 63 in about half),
    or drawn from `pool`."""
    if pool is not None:
        at = torch.randint(0, pool.shape[0], (n,), generator=g, device=device)
        return pool[at]
    return torch.randint(-2**63, 2**63 - 1, (n,), generator=g, device=device,
                         dtype=torch.int64)


def unsigned_unique(words):
    """The distinct int64 words in unsigned order."""
    return u64.to_unsigned_order(torch.unique(u64.to_unsigned_order(words)))


def compact_table(cap, words, counts=None, g=None):
    """A compact k = 32 CountTable of the distinct words (unsigned order),
    random counts unless given, zeros past n_unique."""
    keys = unsigned_unique(words)
    nu = keys.shape[0]
    if counts is None:
        counts = torch.randint(1, 100, (nu,), generator=g,
                               device=keys.device, dtype=torch.int32)
    pad = lambda p: torch.cat([p, p.new_zeros(cap - nu)])
    hi, lo = u64.split_word(keys)
    return tcount.CountTable(pad(hi), pad(lo), pad(counts), nu)


def runlength_table(words, valid):
    """A batch's k = 32 table: sorted with duplicates, counts at run
    starts, invalid lanes last (count_words' run-length form)."""
    return tcount.count_words(words, valid, max_k=32, compact=False)


def batch_tables(n, lanes, g, device, pool=None, valid_frac=0.5,
                 dup_frac=0.75):
    """n run-length batch tables of `lanes` lanes: dup_frac of the lanes
    draw from `pool` (the table's keys, say), the rest any word."""
    out = []
    for _ in range(n):
        words = full_words(lanes, g, device)
        if pool is not None and pool.numel():
            dup = torch.rand(lanes, generator=g, device=device) < dup_frac
            words = torch.where(dup, full_words(lanes, g, device, pool),
                                words)
        valid = torch.rand(lanes, generator=g, device=device) < valid_frac
        out.append(runlength_table(words, valid))
    return out


def live_words(table):
    nu = table.n_unique
    return u64.join_planes(table.keys_hi[:nu], table.keys_lo[:nu])


def both(table, pending, capacity):
    """(merge_sorted_tables, merge_many) of the tables, each bounded."""
    got = stream._bound_table(
        tcount.merge_sorted_tables(table, pending, capacity), capacity)
    want = stream._bound_table(
        tcount.merge_many([table] + list(pending), max_k=32), capacity)
    return got, want


def assert_bit_for_bit(got, want):
    """The same table (every plane over the whole capacity, n_unique) and
    the same dropped keys and mass."""
    (gt, gdu, gdk), (wt, wdu, wdk) = got, want
    assert (gt.n_unique, gdu, gdk) == (wt.n_unique, wdu, wdk)
    for g_, w_ in zip(tuple(gt.keys) + (gt.counts,),
                      tuple(wt.keys) + (wt.counts,)):
        assert g_.shape == w_.shape
        assert torch.equal(g_.cpu(), w_.cpu())


# -- against the re-count, on the CPU -----------------------------------------

# (table capacity, table keys, pending tables, lanes a table, key pool
# size or 0 for the whole range): a steady state, an empty table, many
# tables sharing few keys, one pending table, tables of one lane
CASES = [
    (8192, 3000, 16, 1024, 0),
    (4096, 0, 5, 2048, 0),
    (2048, 200, 9, 512, 300),
    (4096, 2500, 1, 4096, 0),
    (256, 30, 7, 1, 0),
]


@pytest.mark.parametrize("cap,n_table,n_pending,lanes,pool_size", CASES)
def test_matches_merge_many(cap, n_table, n_pending, lanes, pool_size):
    g = torch.Generator().manual_seed(cap + n_table + n_pending + lanes)
    pool = unsigned_unique(full_words(pool_size, g, "cpu")) if pool_size \
        else None
    table = compact_table(cap, full_words(n_table, g, "cpu", pool), g=g)
    pending = batch_tables(n_pending, lanes, g, "cpu",
                           pool if pool is not None else live_words(table))
    got, want = both(table, pending, cap)
    assert_bit_for_bit(got, want)
    assert got[0].n_unique > 0


def test_bit_63_and_key_0():
    """Keys with bit 63 set sort after every key without it, key 0
    (A^32) and (0x80000000, 0) are keys like any other."""
    g = torch.Generator().manual_seed(63)
    special = torch.tensor([0, u64.SIGN_BIT, -1, 1, u64.SIGN_BIT + 1,
                            (1 << 63) - 1], dtype=torch.int64)
    table = compact_table(1024, torch.cat([special[:3],
                                           full_words(200, g, "cpu")]), g=g)
    pending = [runlength_table(torch.cat([special.repeat(5),
                                          full_words(100, g, "cpu")]),
                               torch.ones(130, dtype=torch.bool))
               for _ in range(4)]
    got, want = both(table, pending, 1024)
    assert_bit_for_bit(got, want)
    words = u64.to_unsigned_order(live_words(got[0]))
    assert torch.equal(words, torch.sort(words).values)
    assert int(live_words(got[0])[0]) == 0
    assert (live_words(got[0]) < 0).sum() > 50


def test_padding_tables_drop_out():
    """All-dead padding tables (empty_like_table, n_unique 0), as
    _consolidate adds them, merge as nothing."""
    g = torch.Generator().manual_seed(7)
    table = compact_table(2048, full_words(500, g, "cpu"), g=g)
    real = batch_tables(3, 512, g, "cpu", live_words(table))
    pad = [tcount.empty_like_table(real[0])] * 5
    got, want = both(table, real[:2] + pad + real[2:], 2048)
    assert_bit_for_bit(got, want)
    assert_bit_for_bit(got, both(table, real, 2048)[0])


def test_everything_empty():
    table = tcount.empty_table(64, "cpu")
    pad = tcount.empty_like_table(batch_tables(
        1, 32, torch.Generator().manual_seed(1), "cpu")[0])
    got, want = both(table, [pad, pad], 64)
    assert_bit_for_bit(got, want)
    assert got[0].n_unique == 0 and got[0].capacity == 64


def stacked(tables):
    """[D, cap] planes of D compact shard tables, as gather_tables
    stacks them."""
    return tcount.CountTable(
        torch.stack([t.keys_hi for t in tables]),
        torch.stack([t.keys_lo for t in tables]),
        torch.stack([t.counts for t in tables]),
        sum(t.n_unique for t in tables))


@pytest.mark.parametrize("d", [1, 4])
def test_stacked_shard_tables(d):
    """Pending [D, cap] compact shard tables (a sharded counter's gathered
    batches), some shards empty, and a padding stack: one list a shard."""
    g = torch.Generator().manual_seed(d)
    table = compact_table(4096, full_words(900, g, "cpu"), g=g)
    pool = live_words(table)
    pending = []
    for b in range(5):
        shards = [compact_table(600, full_words(
            0 if (b + s) % 3 == 0 else 400, g, "cpu", pool), g=g)
            for s in range(d)]
        pending.append(stacked(shards))
    pending.append(tcount.empty_like_table(pending[0]))
    got, want = both(table, pending, 4096)
    assert_bit_for_bit(got, want)


def test_counts_wrap_past_2_to_the_32():
    """Three tables' counts near 2^31 on shared keys: the sums pass 2^32
    and come out mod 2^32, as the re-count's do."""
    g = torch.Generator().manual_seed(32)
    words = full_words(40, g, "cpu")
    big = lambda n: torch.full((n,), 2**31 - 5, dtype=torch.int32)
    keys = unsigned_unique(words)
    n = keys.shape[0]
    table = compact_table(128, words, counts=big(n))
    pending = [compact_table(64, keys[i::2], counts=big(keys[i::2].shape[0]))
               for i in (0, 1)] + [compact_table(64, keys, counts=big(n))]
    got, want = both(table, pending, 128)
    assert_bit_for_bit(got, want)
    # each key: three counts of 2^31 - 5, mod 2^32
    assert got[0].counts[:n].tolist() == [2**31 - 15] * n


@pytest.mark.parametrize("cap", [100, 37])
def test_eviction_past_capacity_with_ties(cap):
    """More keys than capacity, counts from {1, 2, 3} so that many tie:
    the same keys are evicted, the same mass dropped."""
    g = torch.Generator().manual_seed(cap)
    table = compact_table(cap, full_words(cap - 10, g, "cpu"),
                          counts=None, g=torch.Generator().manual_seed(3))
    table.counts[:table.n_unique] = torch.randint(
        1, 4, (table.n_unique,), generator=g, dtype=torch.int32)
    pending = batch_tables(6, 64, g, "cpu", live_words(table), dup_frac=0.3)
    got, want = both(table, pending, cap)
    assert got[1] > 0 and got[2] > 0
    assert_bit_for_bit(got, want)


def test_result_capacity_is_the_merge_capacity():
    """Unbounded, the merge gives max(capacity, n_unique) slots, zero past
    n_unique."""
    g = torch.Generator().manual_seed(5)
    table = compact_table(64, full_words(50, g, "cpu"), g=g)
    pending = batch_tables(3, 64, g, "cpu")
    out = tcount.merge_sorted_tables(table, pending, 64)
    assert out.capacity == max(64, out.n_unique) > 64
    out = tcount.merge_sorted_tables(table, pending[:0], 64)
    assert out.capacity == 64 and out.n_unique == table.n_unique
    assert not out.counts[out.n_unique:].any()


# -- the plain versions against brute force -------------------------------------

def brute_merge(a, b):
    """Python's stable sort of A then B by the unsigned key."""
    lanes = [tuple(p.tolist()) for p in a]
    rows = list(zip(*lanes)) + list(zip(*(tuple(p.tolist()) for p in b)))
    key = lambda r: ((r[0] & 0xFFFFFFFF) << 32) | (r[1] & 0xFFFFFFFF)
    return sorted(rows, key=key)


def sorted_list(n, g, pool=None):
    """A key-sorted weighted list (hi, lo, w) of n lanes with repeats."""
    words = u64.to_unsigned_order(torch.sort(u64.to_unsigned_order(
        full_words(n, g, "cpu", pool))).values)
    w = torch.randint(-2**31, 2**31, (n,), generator=g, dtype=torch.int64)
    return u64.split_word(words) + (w.to(torch.int32),)


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 5), (7, 0), (1, 1),
                                   (300, 41), (1537, 2000)])
def test_plain_weighted_merge_is_a_stable_merge(na, nb):
    g = torch.Generator().manual_seed(na * 7 + nb)
    pool = full_words(50, g, "cpu")
    a, b = sorted_list(na, g, pool), sorted_list(nb, g, pool)
    got = kmerge.merge_sorted_weighted(*a, *b)
    assert [tuple(r) for r in zip(*(p.tolist() for p in got))] == \
        brute_merge(a, b)


@pytest.mark.parametrize("n,n_keys", [(0, 1), (1, 1), (9, 2), (5000, 3),
                                      (2049, 2000)])
def test_plain_all_valid_reduction_sums_every_run(n, n_keys):
    """Every lane counts, bit 31 of the hi plane set or not."""
    g = torch.Generator().manual_seed(n + n_keys)
    hi, lo, w = sorted_list(n, g, full_words(n_keys, g, "cpu"))
    keys, counts, nu = kmerge.reduce_runs((hi, lo), w, 16, all_valid=True)
    sums = {}
    for key, wt in zip(zip(hi.tolist(), lo.tolist()), w.tolist()):
        sums[key] = (sums.get(key, 0) + (wt & 0xFFFFFFFF)) & 0xFFFFFFFF
    signed = lambda v: v - (1 << 32) if v >> 31 else v
    assert nu == len(sums)
    assert list(zip(keys[0][:nu].tolist(), keys[1][:nu].tolist())) == \
        list(sums)
    assert counts[:nu].tolist() == [signed(v) for v in sums.values()]
    assert counts.shape == (max(16, nu),) and not counts[nu:].any()
    if n > 100:
        assert (keys[0][:nu] < 0).any()


# -- the counters that take it, on the CPU -------------------------------------

def no_recount(*_args, **_kwargs):
    raise AssertionError("merge_many's re-count ran")


def packed_batches(n, rows, seed, length=128):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        reads = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, (rows, length))]
        reads[rng.random(reads.shape) < 0.01] = ord("N")
        reads[:, :40] = reads[0, :40]          # shared k-mers across rows
        out.append(fastx.pack_batch_np(reads))
    return out


def test_k32_counter_merges_and_matches_the_recount(monkeypatch):
    """The one-card k = 32 counter consolidates without merge_many, to the
    table the re-count gives (the re-count run beside it by hand)."""
    batches = packed_batches(7, 16, 32)
    want = stream.StreamingCounter(32, 1 << 12, merge_every=3, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(stream, "_merge_bounded", lambda t, p, c, max_k=None:
                  stream._bound_table(tcount.merge_many(
                      [t] + list(p), max_k=max_k), c))
        for wv in batches:
            want.update_packed(*wv)
        want_pairs = want.to_pairs()
    monkeypatch.setattr(tcount, "merge_many", no_recount)
    sc = stream.StreamingCounter(32, 1 << 12, merge_every=3, device="cpu")
    for wv in batches:
        sc.update_packed(*wv)
    assert sc.to_pairs() == want_pairs
    assert (sc.kmers, sc.dropped_unique) == (want.kmers, want.dropped_unique)
    assert any(w >= 1 << 63 for w, _ in want_pairs)


def test_sharded_k32_counter_merges_shard_tables(monkeypatch):
    """The sharded k = 32 counter (hash partition, four CPU shards) gives
    the one-card counter's table with merge_many out of the way."""
    batches = packed_batches(5, 16, 64)
    one = stream.StreamingCounter(32, 1 << 12, merge_every=2, device="cpu")
    for wv in batches:
        one.update_packed(*wv)
    monkeypatch.setattr(tcount, "merge_many", no_recount)
    sc = stream.ShardedStreamingCounter(
        32, 1 << 12, merge_every=2,
        mesh=tmesh.make_mesh(devices=["cpu"] * 4), route_capacity=1024)
    for wv in batches:
        sc.update_packed(*wv)
    assert sc.to_pairs() == one.to_pairs()
    assert sc.route_overflow == 0 and sc.kmers == one.kmers


def test_span_and_counters_on_the_cpu():
    """Under a profiler one sorted_merge span and one merge a call, none
    reduced on the card, and the lanes of the last merge; without one
    nothing moves."""
    g = torch.Generator().manual_seed(11)
    table = compact_table(2048, full_words(700, g, "cpu"), g=g)
    pending = batch_tables(4, 256, g, "cpu", live_words(table))
    pending.append(tcount.empty_like_table(pending[0]))
    before = profiling.counters()
    tcount.merge_sorted_tables(table, pending, 2048)
    assert all(profiling.counters().get(n) == before.get(n)
               for n in COUNTERS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tcount.merge_sorted_tables(table, pending, 2048)
    after = profiling.counters()
    moved = [after.get(n, 0) - before.get(n, 0) for n in COUNTERS]
    assert moved == [1, 0, table.n_unique + sum(t.n_unique for t in pending)]
    names = [e.name for e in prof.events()]
    assert names.count("kmers.consolidate.sorted_merge") == 1


# -- on the card ----------------------------------------------------------------

def check_merge(a, b):
    kernels.reset_launch_counts()
    got = kmerge.merge_sorted_weighted(*a, *b)
    assert kernels.launch_counts()["merge_sorted_weighted"] == \
        (1 if a[0].is_cuda else 0)
    want = kmerge.merge_sorted_weighted_plain(*a, *b)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and torch.equal(g_, w_)


def on(device, planes):
    return tuple(p.to(device) for p in planes)


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,n_keys", [
    (0, 0, 1), (0, 7, 5), (9, 0, 5), (1, 1, 1), (MERGE_TILE, 1, 3),
    (MERGE_TILE - 1, MERGE_TILE + 1, 2000), (5000, 3, 10),
    ((1 << 20) + 3, 480_001, 1 << 19), (70_001, 900_007, 0)])
def test_weighted_merge_kernel_matches_plain_at_odd_lengths(card, na, nb,
                                                            n_keys):
    g = torch.Generator().manual_seed(na + nb + n_keys)
    pool = full_words(n_keys, g, "cpu") if n_keys else None
    a, b = sorted_list(na, g, pool), sorted_list(nb, g, pool)
    check_merge(on(card, a), on(card, b))


def check_reduce(hi, lo, w, capacity):
    kernels.reset_launch_counts()
    got = kmerge.reduce_runs((hi, lo), w, capacity, all_valid=True)
    assert kernels.launch_counts()["reduce_runs_all_valid"] == 1
    assert kernels.launch_counts()["reduce_runs"] == 0
    want = kmerge.reduce_runs_plain((hi, lo), w, capacity, all_valid=True)
    assert got[2] == want[2]
    for g_, w_ in zip(got[0] + (got[1],), want[0] + (want[1],)):
        assert g_.shape == w_.shape and torch.equal(g_, w_)
    return got[2]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_keys", [
    (0, 1), (1, 1), (5, 1), (RUN_TILE, 1), (RUN_TILE + 1, RUN_TILE),
    (4097, 1), (7000, 4000), ((1 << 20) + 3, 1 << 19), ((1 << 20) + 3, 50)])
def test_all_valid_reduce_kernel_matches_plain_at_odd_lengths(card, n,
                                                              n_keys):
    g = torch.Generator().manual_seed(n + n_keys)
    lanes = on(card, sorted_list(n, g, full_words(n_keys, g, "cpu")))
    check_reduce(*lanes, 4096)
    check_reduce(*lanes, 0)


def cell_state(card, seed):
    """The k = 32 count cell's steady consolidation: a 2^24-slot table of
    8.4M live keys and 16 run-length batch tables of 2^20 lanes, about
    46 % of them valid, 75 % of those the table's keys."""
    g = torch.Generator(device=card).manual_seed(seed)
    table = compact_table(1 << 24, full_words(8_700_000, g, card)[:8_400_000],
                          g=g)
    pending = batch_tables(16, 1 << 20, g, card, live_words(table),
                           valid_frac=0.46)
    return table, pending


@pytest.mark.cuda
def test_kernels_and_merge_at_the_cells_shapes(card):
    """Both variants against their plain versions on the cell's lanes, and
    the consolidation against merge_many's, bit for bit."""
    table, pending = cell_state(card, 32)
    lists = list(tcount._live_lists(pending))
    assert len(lists) == 16
    check_merge(lists[0], lists[1])
    nu = table.n_unique
    live = tuple(p[:nu] for p in table.keys) + (table.counts[:nu],)
    tree = kmerge.merge_sorted_weighted(*lists[0], *lists[1])
    for x in lists[2:]:
        tree = kmerge.merge_sorted_weighted(*tree, *x)
    check_merge(live, tree)
    merged = kmerge.merge_sorted_weighted(*live, *tree)
    del lists, tree
    assert check_reduce(*merged, 1 << 24) > nu
    del merged
    got, want = both(table, pending, 1 << 24)
    assert_bit_for_bit(got, want)


@pytest.mark.cuda
def test_one_k32_consolidation_peak_memory(card):
    """One consolidation of the cell's 16 pending run-length tables into
    its 2^24-slot table: the device memory it peaks at, table and pending
    tables included, and no re-count."""
    sc = stream.StreamingCounter(32, 1 << 24, merge_every=16, device=card)
    sc.table, sc._pending = cell_state(card, 24)
    sc._pending_kmers = [torch.tensor(1 << 19, device=card)] * 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sc._consolidate()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = kernels.launch_counts()
    assert launched["reduce_runs_all_valid"] == 1
    assert launched["merge_sorted_weighted"] == 16
    assert launched["compress_flagged"] == 16
    assert sc.table.capacity == 1 << 24 and sc.dropped_unique == 0
    assert sc.table.n_unique > 8_400_000
    assert peak < 1400 * MiB, f"{peak / MiB:.1f} MiB"
