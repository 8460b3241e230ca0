"""The port's sort-based count tables against the JAX package on the CPU:
sort_by_word (both layouts), run starts, start compaction, count_sorted,
count_sorted_runs, count_words (compact and run-length), count_weighted,
merge_many and lookup, narrow (k <= 32) and wide (33 <= k <= 64), at
k in {1, 15, 31, 32, 33, 63, 64}; and the plain versions of the kernels
K10 (segment count) and K11 (u64 sort) against the Pallas kernels in
interpret mode and lax.sort.  Integers throughout: exact equality."""

import inspect
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.kernels import count_tile as jct
from kmers_tpu.kernels import sort as jsort
from kmers_tpu.parallel import count as jcount
from kmers_tpu_torch import kernels
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.kernels import count_tile as tct
from kmers_tpu_torch.kernels import sort as tsort
from kmers_tpu_torch.parallel import count as tcount

NARROW_K = [1, 15, 31, 32]
WIDE_K = [33, 63, 64]


def pool_words(rng, n, k, distinct=None):
    """n uint64 words of k bases (k <= 32) drawn from `distinct` values,
    so that runs repeat; at k = 32 about half carry bit 63."""
    distinct = distinct or max(2, n // 3)
    top = 1 << (2 * k)
    vals = rng.integers(0, min(top, 1 << 63), distinct, dtype=np.uint64)
    if k == 32:
        vals |= (rng.random(distinct) < 0.5).astype(np.uint64) << np.uint64(63)
    vals[0] = top - 1                      # the all-T word
    return vals[rng.integers(0, distinct, n)]


def wide_words(rng, n, k):
    """(hi, lo) uint64 words of k bases (33 <= k <= 64): lo uses all 64
    bits, and at k = 64 hi carries bit 63 in about half of them."""
    distinct = max(2, n // 3)
    lo = rng.integers(0, 1 << 63, distinct, dtype=np.uint64) << np.uint64(1)
    lo |= rng.integers(0, 2, distinct, dtype=np.uint64)
    hi = pool_words(rng, distinct, k - 32, distinct)
    pick = rng.integers(0, distinct, n)
    return hi[pick], lo[pick]


def t64(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def jax_u64(words: np.ndarray) -> U64:
    return ju.from_numpy(words)


def jax_u128(hi: np.ndarray, lo: np.ndarray) -> U128:
    return U128(ju.from_numpy(hi), ju.from_numpy(lo))


def jax_planes(keys) -> list:
    """A JAX table's key planes, most significant first, as numpy."""
    if isinstance(keys, U128):
        return [np.asarray(p) for p in (keys.hi.hi, keys.hi.lo, keys.lo.hi,
                                        keys.lo.lo)]
    return [np.asarray(keys.hi), np.asarray(keys.lo)]


def assert_same_table(t, j, n=None):
    """Every lane of the port's table equals the JAX table's."""
    assert t.n_unique == int(j.n_unique)
    tk = t.keys if isinstance(t, tcount.CountTableWide) else t.keys
    for tp, jp in zip(tk, jax_planes(j.keys)):
        np.testing.assert_array_equal(u32(tp)[:n], jp[:n])
    np.testing.assert_array_equal(t.counts.numpy()[:n],
                                  np.asarray(j.counts)[:n])


def narrow_input(k, n=1500, seed=None):
    rng = np.random.default_rng(k * 1000 + n if seed is None else seed)
    words = pool_words(rng, n, k)
    valid = rng.random(n) < 0.8
    return words, valid


# -- K11 --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 4096, 8192])
def test_radix_sort_plain_matches_bitonic_and_lax_sort(n):
    """K11's plain version against the Pallas bitonic kernel (interpret
    mode, 512-lane tiles) and lax.sort, with duplicates and flagged keys."""
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi[: n // 4], lo[: n // 4] = hi[n // 2: n // 2 + n // 4], lo[
        n // 2: n // 2 + n // 4]
    hi[rng.random(n) < 0.1] |= np.uint32(0x80000000)
    got = tsort.radix_sort_u64(torch.from_numpy(hi.view(np.int32)),
                               torch.from_numpy(lo.view(np.int32)))
    bit = jsort.bitonic_sort_u64(jnp.asarray(hi), jnp.asarray(lo),
                                 tile_lanes=512, interpret=True)
    lax = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    for want in (bit, lax):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(u32(g), np.asarray(w))


@pytest.mark.parametrize("n", [0, 1, 2, 777, 1001])
def test_radix_sort_any_n_matches_lax_sort(n):
    """Any n, odd and not a power of two included (the TPU kernel needs a
    power of two >= 512; count.py pads)."""
    rng = np.random.default_rng(n + 1)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    got = tsort.radix_sort_u64(torch.from_numpy(hi.view(np.int32)),
                               torch.from_numpy(lo.view(np.int32)))
    want = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n,)
        np.testing.assert_array_equal(u32(g), np.asarray(w))


def test_kernel_wrappers_check_inputs_and_take_plain_on_cpu():
    kernels.reset_launch_counts()
    z = torch.zeros(8, dtype=torch.int32)
    tsort.radix_sort_u64(z, z)
    tct.segment_count_keys(z, z, seg_lanes=8, block_lanes=8)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(TypeError):
        tsort.radix_sort_u64(z.to(torch.int64), z)
    with pytest.raises(ValueError):
        tsort.radix_sort_u64(z, z[:4])
    for seg, blk in ((12, 64), (64, 32), (4, 64), (64, 96)):
        with pytest.raises(ValueError):
            tct.segment_count_keys(z, z, seg_lanes=seg, block_lanes=blk)


# -- K10 --------------------------------------------------------------------------

def folded(rng, n, n_planes, k):
    """Folded planes: invalid lanes exactly (0x80000000, 0[, 0, 0])."""
    valid = rng.random(n) < 0.8
    if n_planes == 2:
        w = np.where(valid, pool_words(rng, n, k, 60), np.uint64(1) << np.uint64(63))
        return [w >> np.uint64(32), w & np.uint64(0xFFFFFFFF)]
    hi, lo = wide_words(rng, n, k)
    hi = np.where(valid, hi, np.uint64(1) << np.uint64(63))
    lo = np.where(valid, lo, 0)
    m = np.uint64(0xFFFFFFFF)
    return [hi >> np.uint64(32), hi & m, lo >> np.uint64(32), lo & m]


@pytest.mark.parametrize("n_planes,k", [(2, 15), (2, 31), (4, 33), (4, 63)])
@pytest.mark.parametrize("n,seg,blk", [(1500, 64, 1024), (1024, 32, 256),
                                       (300, 8, 256), (2048, 256, 2048),
                                       (3000, 512, 2048), (5000, 1024, 4096),
                                       (20000, 8192, 16384),
                                       (16384, 16384, 16384)])
def test_segment_count_plain_matches_pallas(n_planes, k, n, seg, blk):
    """K10's plain version lane for lane against count_tile.py in
    interpret mode: n on and off the block size, segments of 8 to 16384
    (past the 4096 lanes that one thread block sorts on the card)."""
    rng = np.random.default_rng(n + seg + k)
    planes = [p.astype(np.uint32) for p in folded(rng, n, n_planes, k)]
    jfn = (jct.segment_count_keys if n_planes == 2
           else jct.segment_count_keys_wide)
    tfn = (tct.segment_count_keys if n_planes == 2
           else tct.segment_count_keys_wide)
    want = jfn(*(jnp.asarray(p) for p in planes), seg_lanes=seg,
               block_lanes=blk, interpret=True)
    got = tfn(*(torch.from_numpy(p.view(np.int32)) for p in planes),
              seg_lanes=seg, block_lanes=blk)
    assert len(got) == n_planes + 1
    for g, w in zip(got, want):
        assert g.shape == (-(-n // blk) * blk,)
        np.testing.assert_array_equal(u32(g), np.asarray(w).view(np.uint32))


def test_segment_count_defaults_match_jax():
    """The same call gives the same segments in both packages: seg_lanes
    1024 narrow and 64 wide, blocks of 2^14 lanes."""
    want = {"segment_count_keys": (1024, 1 << 14),
            "segment_count_keys_wide": (64, 1 << 14)}
    for name, (seg, blk) in want.items():
        for fn in (getattr(tct, name), getattr(jct, name)):
            params = inspect.signature(fn).parameters
            assert (params["seg_lanes"].default,
                    params["block_lanes"].default) == (seg, blk), name


def segments_model(planes, seg, blk):
    """An independent per-segment count in numpy: each segment's valid
    keys ascending, then zeros; each run's length at its first lane."""
    words = np.zeros(len(planes[0]), dtype=object)
    for p in planes:
        words = (words << 32) | p.astype(np.uint64).astype(object)
    n = len(words)
    n_pad = -(-n // blk) * blk
    flag = 1 << (32 * len(planes) - 1)
    words = np.concatenate([words, np.full(n_pad - n, flag, dtype=object)])
    keys = np.zeros(n_pad, dtype=object)
    counts = np.zeros(n_pad, dtype=np.int32)
    for s in range(0, n_pad, seg):
        vk = sorted(w for w in words[s:s + seg] if w < flag)
        keys[s:s + len(vk)] = vk
        i = 0
        for _, run in itertools.groupby(vk):
            length = len(list(run))
            counts[s + i] = length
            i += length
    out = [np.array([(w >> (32 * (len(planes) - 1 - i))) & 0xFFFFFFFF
                     for w in keys], dtype=np.uint32)
           for i in range(len(planes))]
    return out + [counts]


@pytest.mark.parametrize("seg", [8, 16, 512, 4096, 8192, 16384, 65536])
@pytest.mark.parametrize("n_planes,k", [(2, 31), (4, 63)])
def test_segment_count_sizes_the_card_takes(seg, n_planes, k):
    """The wrappers take every segment size from 8 up, as JAX does (on the
    CPU the plain version, here against an independent numpy count; on
    the card one thread block up to SEG_LANES_MAX = 4096 lanes, the merge
    rounds past it)."""
    rng = np.random.default_rng(seg + k)
    n, blk = 5000, max(seg, 2048)
    planes = [p.astype(np.uint32) for p in folded(rng, n, n_planes, k)]
    fn = (tct.segment_count_keys if n_planes == 2
          else tct.segment_count_keys_wide)
    got = fn(*(torch.from_numpy(p.view(np.int32)) for p in planes),
             seg_lanes=seg, block_lanes=blk)
    for g, w in zip(got, segments_model(planes, seg, blk)):
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


@pytest.mark.parametrize("k", [15, 31])
def test_count_words_segmented_matches_jax(k):
    words, valid = narrow_input(k, 1800)
    got = tcount.count_words_segmented(t64(words), torch.from_numpy(valid),
                                       block_lanes=1024)
    want = jcount.count_words_segmented(jax_u64(words), jnp.asarray(valid),
                                        seg_lanes=64, block_lanes=1024,
                                        interpret=True)
    assert_same_table(got, want)


@pytest.mark.parametrize("k", [33, 63])
def test_count_words_segmented_wide_matches_jax(k):
    rng = np.random.default_rng(k)
    hi, lo = wide_words(rng, 1500, k)
    valid = rng.random(1500) < 0.8
    got = tcount.count_words_segmented_wide((t64(hi), t64(lo)),
                                            torch.from_numpy(valid),
                                            block_lanes=512)
    want = jcount.count_words_segmented_wide(
        jax_u128(hi, lo), jnp.asarray(valid), seg_lanes=64, block_lanes=512,
        interpret=True)
    assert_same_table(got, want)


# -- narrow tables ------------------------------------------------------------------

@pytest.mark.parametrize("k,spare", [(k, s) for k in NARROW_K
                                     for s in (False, True) if k <= 31 or not s])
@pytest.mark.parametrize("n_extras", [0, 1])
def test_sort_by_word_matches_jax(k, spare, n_extras):
    """The spare-bit layout (k <= 31) and the flag-key layout."""
    words, valid = narrow_input(k)
    pay = np.arange(len(words), dtype=np.int32)[::-1].copy()
    extras = (pay,)[:n_extras]
    s, v, ex = tcount.sort_by_word(t64(words), torch.from_numpy(valid),
                                   *(torch.from_numpy(e) for e in extras),
                                   spare_hi_bit=spare)
    js, jv, jex = jcount.sort_by_word(jax_u64(words), jnp.asarray(valid),
                                      *(jnp.asarray(e) for e in extras),
                                      spare_hi_bit=spare)
    np.testing.assert_array_equal(s.numpy().view(np.uint64), ju.to_numpy(js))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert len(ex) == len(jex) == n_extras
    for a, b in zip(ex, jex):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", NARROW_K)
def test_run_starts_and_compaction_match_jax(k):
    """_run_starts and both _compact_starts layouts, lane for lane."""
    words, valid = narrow_input(k)
    spare_ok = k <= 31
    s, v, _ = tcount.sort_by_word(t64(words), torch.from_numpy(valid),
                                  spare_hi_bit=spare_ok)
    js, jv, _ = jcount.sort_by_word(jax_u64(words), jnp.asarray(valid),
                                    spare_hi_bit=spare_ok)
    starts, idx = tcount._run_starts((s,), v)
    jstarts, jidx = jcount._run_starts(js, jv)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for spare in ([False, True] if spare_ok else [False]):
        (keys,), pay = tcount._compact_starts((s,), starts, idx, spare)
        kh, kl, jpay = jcount._compact_starts(js, jstarts, jidx, spare)
        hi, lo = tu.split_word(keys)
        np.testing.assert_array_equal(u32(hi), np.asarray(kh))
        np.testing.assert_array_equal(u32(lo), np.asarray(kl))
        np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))


@pytest.mark.parametrize("k", NARROW_K)
def test_count_sorted_and_runs_match_jax(k):
    words, valid = narrow_input(k)
    spare = k <= 31
    s, v, _ = tcount.sort_by_word(t64(words), torch.from_numpy(valid),
                                  spare_hi_bit=spare)
    js, jv, _ = jcount.sort_by_word(jax_u64(words), jnp.asarray(valid),
                                    spare_hi_bit=spare)
    assert_same_table(tcount.count_sorted(s, v, spare),
                      jcount.count_sorted(js, jv, spare))
    assert_same_table(tcount.count_sorted_runs(s, v),
                      jcount.count_sorted_runs(js, jv))


@pytest.mark.parametrize("k", NARROW_K)
@pytest.mark.parametrize("max_k", ["k", None])
@pytest.mark.parametrize("compact", [True, False])
def test_count_words_matches_jax(k, max_k, compact):
    """Compact tables and globally sorted run-length tables lane for lane;
    the per-segment run-length form (max_k <= 31, K10's layout) merges to
    the JAX package's compact table."""
    max_k = k if max_k == "k" else None
    words, valid = narrow_input(k, 2000)
    tw, tv = t64(words).reshape(40, 50), torch.from_numpy(valid).reshape(40, 50)
    got = tcount.count_words(tw, tv, max_k=max_k, compact=compact)
    jw = ju.from_numpy(words.reshape(40, 50))
    want = jcount.count_words(jw, jnp.asarray(valid.reshape(40, 50)),
                              max_k=max_k, compact=compact)
    if compact or max_k is None or max_k > 31:
        assert_same_table(got, want)
        return
    assert got.capacity == 1 << 14                 # n padded to the block
    merged = tcount.merge_many([got], max_k=max_k)
    jmerged = jcount.count_words(jw, jnp.asarray(valid.reshape(40, 50)),
                                 max_k=max_k)
    nu = int(jmerged.n_unique)
    assert_same_table(merged, jmerged, n=nu)


@pytest.mark.parametrize("k", NARROW_K)
def test_count_weighted_matches_jax(k):
    """Weights up to 2^31 - 1: the total mass passes 2^32, so the prefix
    sums wrap and only their differences are exact."""
    words, valid = narrow_input(k)
    rng = np.random.default_rng(k)
    w = rng.integers(0, 1 << 20, len(words)).astype(np.int32)
    w[::97] = (1 << 31) - 1
    got = tcount.count_weighted(t64(words), torch.from_numpy(valid),
                                torch.from_numpy(w), max_k=k)
    want = jcount.count_weighted(jax_u64(words), jnp.asarray(valid),
                                 jnp.asarray(w), max_k=k)
    assert_same_table(got, want)


@pytest.mark.parametrize("k", [15, 31, 32])
def test_merge_many_of_every_form_matches_jax(k):
    """A compact table, a run-length table, a unit table (k <= 31) and a
    per-segment table (k <= 31) merge as in the JAX package; merge_tables
    too."""
    parts = [narrow_input(k, 600, seed=k + i) for i in range(4)]
    t_tabs = [tcount.count_words(t64(w), torch.from_numpy(v), max_k=k)
              for w, v in parts[:2]]
    j_tabs = [jcount.count_words(jax_u64(w), jnp.asarray(v), max_k=k)
              for w, v in parts[:2]]
    w, v = parts[2]
    t_tabs.append(tcount.count_words(t64(w), torch.from_numpy(v),
                                     compact=False))
    j_tabs.append(jcount.count_words(jax_u64(w), jnp.asarray(v),
                                     compact=False))
    if k <= 31:
        w, v = parts[3]
        t_tabs.append(tcount.unit_table(t64(w), torch.from_numpy(v)))
        j_tabs.append(jcount.unit_table(jax_u64(w), jnp.asarray(v)))
        t_tabs.append(tcount.count_words_segmented(t64(w),
                                                   torch.from_numpy(v),
                                                   block_lanes=1024))
        j_tabs.append(jcount.count_words_segmented(
            jax_u64(w), jnp.asarray(v), seg_lanes=64, block_lanes=1024,
            interpret=True))
    for max_k in (k, None):
        assert_same_table(tcount.merge_many(t_tabs, max_k=max_k),
                          jcount.merge_many(j_tabs, max_k=max_k))
    assert_same_table(tcount.merge_tables(*t_tabs[:2]),
                      jcount.merge_tables(*j_tabs[:2]))


def test_lookup_is_unsigned_at_k32():
    """A k = 32 key with bit 63 set (A^16 T^16 is its own reverse
    complement, its T half in the high word) is found; absent keys are 0."""
    words, valid = narrow_input(32)
    pal = sum(3 << (2 * i) for i in range(16, 32))     # A^16 T^16
    words[:5] = pal
    valid[:5] = True
    table = tcount.count_words(t64(words), torch.from_numpy(valid), max_k=32)
    jt = jcount.count_words(jax_u64(words), jnp.asarray(valid), max_k=32)
    rng = np.random.default_rng(3)
    q = np.concatenate([words[:200], pool_words(rng, 100, 32)])
    got = tcount.lookup(table, t64(q))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcount.lookup(jt, jax_u64(q))))
    assert int(got[0]) >= 5 and pal >> 63 == 1


# -- wide tables ---------------------------------------------------------------------

def wide_input(k, n=1500, seed=None):
    rng = np.random.default_rng(k + n if seed is None else seed)
    hi, lo = wide_words(rng, n, k)
    return hi, lo, rng.random(n) < 0.8


@pytest.mark.parametrize("k,spare", [(k, s) for k in WIDE_K
                                     for s in (False, True) if k <= 63 or not s])
def test_sort_by_word_wide_matches_jax(k, spare):
    hi, lo, valid = wide_input(k)
    pay = np.arange(len(hi), dtype=np.int32)
    (sh, sl), v, (p,) = tcount.sort_by_word_wide(
        (t64(hi), t64(lo)), torch.from_numpy(valid), torch.from_numpy(pay),
        spare_hi_bit=spare)
    js, jv, (jp,) = jcount.sort_by_word_wide(
        jax_u128(hi, lo), jnp.asarray(valid), jnp.asarray(pay),
        spare_hi_bit=spare)
    np.testing.assert_array_equal(sh.numpy().view(np.uint64),
                                  ju.to_numpy(js.hi))
    np.testing.assert_array_equal(sl.numpy().view(np.uint64),
                                  ju.to_numpy(js.lo))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("compact", [True, False])
def test_count_words_wide_matches_jax(k, compact):
    hi, lo, valid = wide_input(k)
    words = (t64(hi), t64(lo))
    got = tcount.count_words_wide(words, torch.from_numpy(valid), max_k=k,
                                  compact=compact)
    want = jcount.count_words_wide(jax_u128(hi, lo), jnp.asarray(valid),
                                   max_k=k, compact=compact)
    if compact or k > 63:
        assert_same_table(got, want)
        # the run starts and the compaction alone, both layouts
        if compact:
            spare = k <= 63
            s, sv, _ = tcount.sort_by_word_wide(words, torch.from_numpy(valid),
                                                spare_hi_bit=spare)
            js, jsv, _ = jcount.sort_by_word_wide(
                jax_u128(hi, lo), jnp.asarray(valid), spare_hi_bit=spare)
            starts, _ = tcount._run_starts(s, sv)
            np.testing.assert_array_equal(
                starts.numpy(), np.asarray(jcount._run_starts_wide(js, jsv)[0]))
        return
    merged = tcount.merge_many_wide([got], max_k=k)
    jmerged = jcount.count_words_wide(jax_u128(hi, lo), jnp.asarray(valid),
                                      max_k=k)
    assert_same_table(merged, jmerged, n=int(jmerged.n_unique))


@pytest.mark.parametrize("k", WIDE_K)
def test_count_weighted_and_merge_wide_match_jax(k):
    hi, lo, valid = wide_input(k, 900)
    rng = np.random.default_rng(k)
    w = rng.integers(0, 1 << 20, len(hi)).astype(np.int32)
    w[::50] = (1 << 31) - 1
    got = tcount.count_weighted_wide((t64(hi), t64(lo)),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(w), max_k=k)
    want = jcount.count_weighted_wide(jax_u128(hi, lo), jnp.asarray(valid),
                                      jnp.asarray(w), max_k=k)
    assert_same_table(got, want)
    h2, l2, v2 = wide_input(k, 700, seed=k + 1)
    t_tabs = [got, tcount.count_words_wide((t64(h2), t64(l2)),
                                           torch.from_numpy(v2),
                                           compact=False)]
    j_tabs = [want, jcount.count_words_wide(jax_u128(h2, l2), jnp.asarray(v2),
                                            compact=False)]
    if k <= 63:
        t_tabs.append(tcount.unit_table_wide((t64(h2), t64(l2)),
                                             torch.from_numpy(v2)))
        j_tabs.append(jcount.unit_table_wide(jax_u128(h2, l2),
                                             jnp.asarray(v2)))
    assert_same_table(tcount.merge_many_wide(t_tabs, max_k=k),
                      jcount.merge_many_wide(j_tabs, max_k=k))
    assert_same_table(tcount.merge_tables_wide(*t_tabs[:2]),
                      jcount.merge_tables_wide(*j_tabs[:2]))


def test_lookup_wide_at_k64_uses_bit_127():
    hi, lo, valid = wide_input(64)
    table = tcount.count_words_wide((t64(hi), t64(lo)),
                                    torch.from_numpy(valid), max_k=64)
    jt = jcount.count_words_wide(jax_u128(hi, lo), jnp.asarray(valid),
                                 max_k=64)
    top = hi >> np.uint64(63) == 1
    assert top[valid].any() and (~top[valid]).any()
    got = tcount.lookup_wide(table, t64(hi[:300]), t64(lo[:300]))
    want = jcount.lookup_wide(jt, jax_u128(hi[:300], lo[:300]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[valid[:300]] > 0).all()
