"""The consolidation's table merge: K3 / K6 over the table's live prefix,
then the run-reduce kernel K13 (kernels/merge.py: reduce_runs).  On the
CPU, K13's plain version and the merge against merge_many (the
sort-based re-count) and against the merge's earlier form (the table's
dead slots as MAX sentinels, run starts, a cumsum, K4 and differences),
both key widths, at the edges of a table and of K13's tiles; eviction
past capacity; the smoke counts' digests; the merge counters.  On the
card, K13 against its plain version bit for bit at the count cells'
shape and at odd lengths, the merge against its earlier form, and the
peak device memory of one consolidation at the cells' size.

Imports no JAX, so the card's tests run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_reduce_runs.py

Without a card those skip; the CPU tests run everywhere."""

import functools
import operator

import pytest
import torch

from kmers_tpu_torch import kernels, profiling, smoke
from kmers_tpu_torch.core import u64, u128
from kmers_tpu_torch.kernels import merge as kmerge
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import stream

# K13's tile: lanes a block, by key planes (csrc/merge.cu, rr_tile)
TILE = {2: 2048, 4: 1024}
MAX_K = {2: 31, 4: 63}
MiB = 1 << 20


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- inputs -------------------------------------------------------------------

def rand_words(n, nk, g, device, top=1 << 62):
    """n random keys below 2^124 / 2^62 as int64 words, most significant
    first: (word,) or (hi, lo)."""
    r = lambda: torch.randint(0, top, (n,), generator=g, device=device)
    return (r(),) if nk == 2 else (r(), r())


def unique_sorted(words):
    """The distinct keys of int64 words (non-negative), ascending."""
    if len(words) == 1:
        return (torch.unique(words[0]),)
    u = torch.unique(torch.stack(words, 1), dim=0)
    return u[:, 0].contiguous(), u[:, 1].contiguous()


def planes_of(words):
    return tuple(p for w in words for p in u64.split_word(w))


def make_table(nk, cap, n_live, g, device, top=1 << 62, weights=None):
    """A compact CountTable(Wide) of n_live random distinct keys (fewer if
    the draw repeats), random counts, zeros past n_unique."""
    live = tuple(w[:n_live] for w in unique_sorted(
        rand_words(n_live + n_live // 8 + 8, nk, g, device, top)))
    # the draw is in key order; shuffle which keys survive the cut
    n = live[0].shape[0]
    if n > n_live:
        keep = torch.sort(torch.randperm(n, generator=g, device=device)
                          [:n_live]).values
        live = tuple(w[keep] for w in live)
    nu = live[0].shape[0]
    pad = lambda p: torch.cat([p, p.new_zeros(cap - nu)])
    if weights is None:
        weights = torch.randint(1, 100, (nu,), generator=g, device=device,
                                dtype=torch.int32)
    return tcount.make_table(tuple(pad(p) for p in planes_of(live)),
                             pad(weights), nu)


def table_words(table):
    nu = table.n_unique
    p = [x[:nu] for x in table.keys]
    return (u64.join_planes(*p),) if len(p) == 2 else u128.join_planes(*p)


def make_units(nk, n, table, g, device, valid_frac=0.97, dup_frac=0.75,
               top=1 << 62):
    """A unit table of n lanes, unsorted: dup_frac of the valid lanes
    draw a table key, the rest fresh keys; the rest flagged invalid."""
    words = rand_words(n, nk, g, device, top)
    old = table_words(table)
    if old[0].numel():
        pick = torch.randint(0, old[0].shape[0], (n,), generator=g,
                             device=device)
        dup = torch.rand(n, generator=g, device=device) < dup_frac
        words = tuple(torch.where(dup, o[pick], w) for o, w in zip(old, words))
    valid = torch.rand(n, generator=g, device=device) < valid_frac
    if nk == 2:
        return tcount.unit_table(words[0], valid)
    return tcount.unit_table_wide(words, valid)


def sorted_units(units):
    pending = units if isinstance(units, list) else [units]
    if isinstance(pending[0], tcount.UnitTable):
        return stream._sort_units(pending)
    return stream._sort_units_wide(pending)


def new_merge(table, s_keys):
    if len(s_keys) == 2:
        return tcount.merge_table_with_sorted_units(table, *s_keys)
    return tcount.merge_table_with_sorted_units_wide(table, s_keys)


def earlier_merge(table, s_keys):
    """The table merge as it was before K13: the table's dead slots as
    MAX sentinels through K3 / K6, run starts, an int64 cumsum, K4 three
    planes a pass and the compacted prefixes' differences; capacity
    table.capacity + unit lanes."""
    merge = (lambda a, w, b: (lambda o: (o[:2], o[2]))(
        kmerge.merge_sorted(*a, w, *b))) if len(s_keys) == 2 else (
            kmerge.merge_sorted_wide)
    cap = table.capacity
    device = table.counts.device
    live = torch.arange(cap, device=device) < table.n_unique
    a_keys = tuple(torch.where(live, p, -1) for p in table.keys)
    m_keys, m_w = merge(a_keys, torch.where(live, table.counts, 0),
                        tuple(s_keys))
    n = m_w.shape[0]
    pos = torch.arange(n, device=device)
    valid = m_keys[0] >= 0
    first = [m_keys[0][:1] ^ 1] + [p[:1] for p in m_keys[1:]]
    starts = valid & functools.reduce(operator.or_, (
        p != torch.cat([f, p[:-1]]) for p, f in zip(m_keys, first)))
    mw = torch.where(valid, u64.as_uint32(m_w), 0)
    csum = torch.cumsum(mw, 0)
    planes = list(m_keys) + [u64.low32_as_int32(csum - mw)]
    keep = starts.to(torch.uint8)
    compact = []
    for i in range(0, len(planes), 3):
        chunk = planes[i:i + 3]
        out = kmerge.compress_flagged(*(chunk + [chunk[0]] * (3 - len(chunk))),
                                      keep)
        compact += out[:len(chunk)]
    n_unique = int(starts.sum())
    counts = tcount._counts_from_positions(
        u64.as_uint32(compact[-1]), pos, n_unique, csum[-1] & u64.LOW32)
    return tcount.make_table(
        tuple(torch.where(pos < n_unique, c, 0) for c in compact[:-1]),
        counts, n_unique)


def assert_same_table(got, want, capacity=None):
    """Equal n_unique, keys and counts over it; zeros past it in got."""
    nu = got.n_unique
    assert nu == want.n_unique
    if capacity is not None:
        assert got.capacity == capacity
    for g_, w_ in zip(tuple(got.keys) + (got.counts,),
                      tuple(want.keys) + (want.counts,)):
        assert torch.equal(g_[:nu].cpu(), w_[:nu].cpu())
        assert not g_[nu:].any()


# (nk, capacity, table keys, unit lanes, valid share of the units): a
# steady state, an empty table, a full one, all-invalid units, units of
# one lane, and table keys that exceed capacity's half (new keys past it)
MERGE_CASES = [
    (2, 8192, 3000, 8192, 0.97),
    (2, 4096, 0, 5000, 0.8),
    (2, 2048, 2048, 4096, 0.9),
    (2, 4096, 1500, 4096, 0.0),
    (2, 1024, 700, 1, 1.0),
    (2, 1024, 900, 3000, 1.0),
    (4, 8192, 3000, 8192, 0.97),
    (4, 4096, 0, 5000, 0.8),
    (4, 2048, 2048, 4096, 0.9),
    (4, 4096, 1500, 4096, 0.0),
    (4, 1024, 900, 3000, 1.0),
]


@pytest.mark.parametrize("nk,cap,n_live,n_units,valid_frac", MERGE_CASES)
def test_table_merge_matches_merge_many_and_its_earlier_form(
        nk, cap, n_live, n_units, valid_frac):
    g = torch.Generator().manual_seed(cap + n_live + n_units + nk)
    table = make_table(nk, cap, n_live, g, "cpu")
    units = make_units(nk, n_units, table, g, "cpu", valid_frac)
    got = new_merge(table, sorted_units(units))
    want = tcount.merge_many([table, units], max_k=MAX_K[nk])
    assert_same_table(got, want, capacity=max(cap, want.n_unique))
    assert_same_table(got, earlier_merge(table, sorted_units(units)))


def merged_lanes(nk, n, n_invalid, n_keys, g, device, big=False):
    """K3 / K6's output form: n lanes of keys ascending as unsigned words
    with repeats (drawn from n_keys values), the last n_invalid flagged,
    and random weights (any 32 bits when big)."""
    words = rand_words(n - n_invalid, nk, g, device, top=max(1, n_keys))
    if nk == 2:
        key = torch.sort(words[0]).values
        flag = torch.full((n_invalid,), u64.SIGN_BIT, device=device)
        planes = u64.split_word(torch.cat([key, flag]))
    else:
        order = u128.argsort(*words)
        z = torch.zeros(n_invalid, dtype=torch.int64, device=device)
        planes = u128.split_planes(
            torch.cat([words[0][order], z + u64.SIGN_BIT]),
            torch.cat([words[1][order], z]))
    w = torch.randint(-2**31 if big else 0, 2**31 if big else 1000, (n,),
                      generator=g, device=device, dtype=torch.int64)
    return planes, w.to(torch.int32)


def run_sum_reference(keys, w):
    """(key tuples, count mod 2^32 as int32) of each run of valid lanes,
    from Python ints."""
    cols = [p.tolist() for p in keys]
    out = {}
    order = []
    for i, wt in enumerate(w.tolist()):
        if cols[0][i] < 0:
            continue
        key = tuple(c[i] for c in cols)
        if key not in out:
            out[key] = 0
            order.append(key)
        out[key] = (out[key] + (wt & 0xFFFFFFFF)) & 0xFFFFFFFF
    signed = lambda v: v - (1 << 32) if v >> 31 else v
    return order, [signed(out[k]) for k in order]


# (n lanes, invalid lanes, distinct values drawn): empty, all invalid,
# one lane, long runs past a tile, a tile and a lane, several tiles
EDGE_LANES = [(0, 0, 1), (5, 5, 1), (1, 0, 1), (6000, 100, 3),
              (2049, 1, 2000), (1025, 0, 900), (7000, 300, 4000)]


@pytest.mark.parametrize("nk", [2, 4])
@pytest.mark.parametrize("n,n_invalid,n_keys", EDGE_LANES)
def test_reduce_runs_plain_at_the_edges(nk, n, n_invalid, n_keys):
    g = torch.Generator().manual_seed(n + n_keys + nk)
    keys, w = merged_lanes(nk, n, n_invalid, n_keys, g, "cpu", big=True)
    got_keys, got_counts, nu = kmerge.reduce_runs(keys, w, 64)
    order, counts = run_sum_reference(keys, w)
    assert nu == len(order)
    assert got_counts.shape == (max(64, nu),)
    assert list(zip(*(p[:nu].tolist() for p in got_keys))) == order
    assert got_counts[:nu].tolist() == counts
    assert not got_counts[nu:].any()
    assert not any(p[nu:].any() for p in got_keys)


@pytest.mark.parametrize("nk", [2, 4])
def test_runs_across_a_tile_edge_and_longer_than_a_tile(nk):
    """A table key repeated by the units across lane TILE of the merged
    lanes, and one key whose run is three tiles long."""
    g = torch.Generator().manual_seed(nk)
    tile = TILE[nk]
    table = make_table(nk, 4 * tile, tile - 4, g, "cpu")
    last = tuple(w[-1:] for w in table_words(table))
    first = tuple(w[:1] for w in table_words(table))
    words = tuple(torch.cat([lw.repeat(16), fw.repeat(3 * tile)])
                  for lw, fw in zip(last, first))
    valid = torch.ones(words[0].shape[0], dtype=torch.bool)
    units = (tcount.unit_table(words[0], valid) if nk == 2
             else tcount.unit_table_wide(words, valid))
    got = new_merge(table, sorted_units(units))
    want = tcount.merge_many([table, units], max_k=MAX_K[nk])
    assert_same_table(got, want, capacity=4 * tile)
    assert got.counts[0] == table.counts[0] + 3 * tile
    assert got.counts[tile - 5] == table.counts[tile - 5] + 16


@pytest.mark.parametrize("nk", [2, 4])
def test_weights_past_2_to_the_32(nk):
    """Counts of 2^30 and near 2^31 - 1: the prefix sums wrap past 2^32
    many times, every count below 2^31 stays exact."""
    g = torch.Generator().manual_seed(31 + nk)
    n_live = 64
    weights = torch.full((n_live,), 1 << 30, dtype=torch.int32)
    weights[7] = 2**31 - 40
    table = make_table(nk, 128, n_live, g, "cpu", weights=weights)
    words = tuple(w[7:8].repeat(30) for w in table_words(table))
    valid = torch.ones(30, dtype=torch.bool)
    units = (tcount.unit_table(words[0], valid) if nk == 2
             else tcount.unit_table_wide(words, valid))
    got = new_merge(table, sorted_units(units))
    assert got.n_unique == n_live
    assert got.counts[7] == 2**31 - 10
    assert (got.counts[:n_live] == torch.where(
        torch.arange(n_live) == 7, 2**31 - 10, 1 << 30)).all()
    assert_same_table(got, tcount.merge_many([table, units],
                                             max_k=MAX_K[nk]))


@pytest.mark.parametrize("nk", [2, 4])
def test_eviction_past_capacity(nk):
    """The merge of a full table with units of fresh keys outgrows
    capacity; _bound_table evicts as after the sort-based merge."""
    g = torch.Generator().manual_seed(40 + nk)
    table = make_table(nk, 2048, 2048, g, "cpu")
    pending = [make_units(nk, 1024, table, g, "cpu", dup_frac=0.3)
               for _ in range(4)]
    streaming = (stream._merge_bounded_streaming_wide if nk == 4
                 else stream._merge_bounded_streaming)
    sorting = stream._merge_bounded_wide if nk == 4 else stream._merge_bounded
    got, du, dk = streaming(table, pending, 2048)
    want, wdu, wdk = sorting(table, pending, 2048, max_k=MAX_K[nk])
    assert du > 0 and (du, dk) == (wdu, wdk)
    assert_same_table(got, want, capacity=2048)


@pytest.mark.parametrize("k", [31, 63])
def test_count_fastx_gives_the_smoke_digest(tmp_path, k):
    """count_fastx at the smoke count's settings saves the table whose
    npz_digest the JAX package's count gives (SMOKE_DIGEST, _WIDE)."""
    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    out = str(tmp_path / "t.npz")
    stream.count_fastx(fq, k, 65536, device="cpu", batch=256,
                       length=160).save(out)
    assert stream.npz_digest(out) == smoke.SMOKE_DIGESTS[k]


def test_merge_counters_on_the_cpu():
    """Under a profiler each table merge adds one to
    kmers.consolidate.merges and nothing to .reduced (the plain version
    ran); without one neither moves."""
    g = torch.Generator().manual_seed(5)
    table = make_table(2, 1024, 300, g, "cpu")
    s_keys = sorted_units(make_units(2, 512, table, g, "cpu"))
    names = ("kmers.consolidate.merges", "kmers.consolidate.reduced")
    before = profiling.counters()
    new_merge(table, s_keys)
    assert all(profiling.counters().get(n) == before.get(n) for n in names)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        new_merge(table, s_keys)
        new_merge(table, s_keys)
    after = profiling.counters()
    assert after[names[0]] - before.get(names[0], 0) == 2
    assert after[names[1]] - before.get(names[1], 0) == 0


# -- on the card ----------------------------------------------------------------

def check_kernel(keys, w, capacity):
    kernels.reset_launch_counts()
    got = kmerge.reduce_runs(keys, w, capacity)
    assert kernels.launch_counts()["reduce_runs"] == 1
    want = kmerge.reduce_runs_plain(keys, w, capacity)
    assert got[2] == want[2]
    for g_, w_ in zip(got[0] + (got[1],), want[0] + (want[1],)):
        assert g_.shape == w_.shape and torch.equal(g_, w_)
    return got[2]


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4])
@pytest.mark.parametrize("n,n_invalid,n_keys", EDGE_LANES + [
    (4097, 0, 1), ((1 << 20) + 3, 1000, 1 << 19), ((1 << 20) + 3, 0, 50)])
def test_reduce_runs_kernel_matches_plain_at_odd_lengths(card, nk, n,
                                                         n_invalid, n_keys):
    g = torch.Generator(device=card).manual_seed(n + nk)
    keys, w = merged_lanes(nk, n, n_invalid, n_keys, g, card, big=True)
    check_kernel(keys, w, 4096)
    check_kernel(keys, w, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4])
def test_reduce_runs_kernel_at_the_cells_shape(card, nk):
    """A 2^24-slot table with 8.3M live keys merged with 2^24 unit lanes
    (a count cell's steady consolidation): K13 against its plain
    version, and the merge against merge_many."""
    g = torch.Generator(device=card).manual_seed(24 + nk)
    table = make_table(nk, 1 << 24, 8_300_000, g, card)
    units = make_units(nk, 1 << 24, table, g, card)
    s_keys = sorted_units(units)
    nu = table.n_unique
    merge = ((lambda a, w, b: (lambda o: (o[:2], o[2]))(
        kmerge.merge_sorted(*a, w, *b))) if nk == 2
        else kmerge.merge_sorted_wide)
    m_keys, m_w = merge(tuple(p[:nu] for p in table.keys), table.counts[:nu],
                        s_keys)
    assert check_kernel(m_keys, m_w, 1 << 24) > nu
    del m_keys, m_w
    got = new_merge(table, s_keys)
    assert_same_table(got, tcount.merge_many([table, units],
                                             max_k=MAX_K[nk]))


@pytest.mark.cuda
@pytest.mark.parametrize("nk,cap,n_live,n_units,valid_frac", MERGE_CASES + [
    (2, 1 << 20, 600_000, 1 << 20, 0.97), (4, 1 << 20, 600_000, 1 << 20,
                                           0.97)])
def test_live_prefix_merge_on_card_matches_the_sentinel_form(
        card, nk, cap, n_live, n_units, valid_frac):
    """K3 / K6 over the live prefix and K13 against K3 / K6 over the
    sentinel planes and K4, both on the card, and the CPU's merge."""
    g = torch.Generator().manual_seed(cap + n_live + n_units + nk)
    table = make_table(nk, cap, n_live, g, "cpu")
    units = make_units(nk, n_units, table, g, "cpu", valid_frac)
    s_keys = tuple(p.to(card) for p in sorted_units(units))
    on_card = tcount.make_table(tuple(p.to(card) for p in table.keys),
                                table.counts.to(card), table.n_unique)
    kernels.reset_launch_counts()
    got = new_merge(on_card, s_keys)
    launched = kernels.launch_counts()
    assert launched["reduce_runs"] == 1 and launched["compress_flagged"] == 0
    assert_same_table(got, earlier_merge(on_card, s_keys),
                      capacity=max(cap, got.n_unique))
    assert_same_table(got, new_merge(table, sorted_units(units)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,live,limit_mib", [(31, 8_300_000, 2000),
                                              (63, 9_950_000, 3200)])
def test_one_consolidation_peak_memory(card, k, live, limit_mib):
    """One consolidation of 16 pending unit tables of 2^20 lanes into a
    2^24-slot table at a count cell's steady state: the device memory it
    peaks at, table and pending tables included."""
    nk = 2 if k <= 32 else 4
    g = torch.Generator(device=card).manual_seed(k)
    sc = stream.StreamingCounter(k, 1 << 24, merge_every=16, device=card)
    sc.table = make_table(nk, 1 << 24, live, g, card)
    sc._pending = [make_units(nk, 1 << 20, sc.table, g, card)
                   for _ in range(16)]
    sc._pending_kmers = [torch.tensor(1 << 20, device=card)] * 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sc._consolidate()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert kernels.launch_counts()["reduce_runs"] == 1
    assert sc.table.capacity == 1 << 24 and sc.dropped_unique == 0
    assert sc.table.n_unique > live
    assert peak < limit_mib * MiB, f"{peak / MiB:.1f} MiB"
