"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card, and the count paths (one device, and two shards on the card)
against the reference tables.

Imports no JAX, so it runs on a machine that has only torch; there the
repository's tests/conftest.py (which imports JAX) must be skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmers_tpu_torch import kernels, smoke
from kmers_tpu_torch.__main__ import main
from kmers_tpu_torch.core import u64
from kmers_tpu_torch.io import fastx
from kmers_tpu_torch.kernels import merge as tmerge
from kmers_tpu_torch.kernels import window as twin
from kmers_tpu_torch.kernels import window_wide as tww
from kmers_tpu_torch.parallel.stream import npz_digest

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def equal_all(got, want, n=None):
    return all(torch.equal(g[:n], w[:n]) for g, w in zip(got, want))


def test_window_kernels_match_plain(card):
    rng = np.random.default_rng(11)
    reads = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, size=(64, 320))].copy()
    reads[::5, 200:] = ord("N")
    words, vbits = fastx.pack_batch_np(reads)
    r = torch.from_numpy(reads).to(card)
    w = torch.from_numpy(words.view(np.int32)).to(card)
    v = torch.from_numpy(vbits.view(np.int32)).to(card)
    for k in (1, 15, 16, 17, 31):
        assert equal_all(twin.pack_canonical_keys_packed(w, v, k),
                         twin.pack_canonical_keys_packed_plain(w, v, k))
        assert equal_all(twin.pack_canonical_keys(r, k),
                         twin.pack_canonical_keys_plain(r, k))


def test_merge_kernels_match_plain(card):
    g = torch.Generator(device=card).manual_seed(5)
    live = torch.unique(torch.randint(0, 1 << 40, (30000,), device=card,
                                      generator=g))
    a_key = torch.cat([live, torch.full((40000 - live.shape[0],), -1,
                                        device=card, dtype=torch.int64)])
    a_hi, a_lo = u64.split_word(a_key)
    a_w = torch.randint(0, 100, (40000,), device=card, generator=g,
                        dtype=torch.int32)
    b_key = torch.cat([live[:20000], torch.randint(
        0, 1 << 40, (25000,), device=card, generator=g),
        torch.full((5000,), u64.SIGN_BIT, device=card, dtype=torch.int64)])
    b_key = u64.to_unsigned_order(torch.sort(u64.to_unsigned_order(b_key))
                                  .values)
    args = (a_hi, a_lo, a_w) + u64.split_word(b_key)
    assert equal_all(tmerge.merge_sorted(*args),
                     tmerge.merge_sorted_plain(*args))
    keep = (torch.rand(40000, device=card, generator=g) < 0.4).to(torch.uint8)
    cnt = int(keep.sum())
    assert equal_all(tmerge.compress_flagged(a_hi, a_lo, a_w, keep),
                     tmerge.compress_flagged_plain(a_hi, a_lo, a_w, keep),
                     cnt)


@pytest.mark.parametrize("B,L,k", [(1, 32, 31), (3, 96, 1), (2, 1000, 17),
                                   (0, 64, 5)])
def test_window_kernels_edge_shapes(card, B, L, k):
    """Rows shorter than a block, one row, no rows; the ASCII kernel also
    takes L % 32 != 0."""
    rng = np.random.default_rng(B * L + k)
    reads = np.frombuffer(b"ACGTN", dtype=np.uint8)[
        rng.integers(0, 5, size=(B, L))].copy()
    r = torch.from_numpy(reads).to(card)
    assert equal_all(twin.pack_canonical_keys(r, k),
                     twin.pack_canonical_keys_plain(r, k))
    if L % 32 == 0:
        words, vbits = fastx.pack_batch_np(reads)
        w = torch.from_numpy(words.view(np.int32)).to(card)
        v = torch.from_numpy(vbits.view(np.int32)).to(card)
        assert equal_all(twin.pack_canonical_keys_packed(w, v, k),
                         twin.pack_canonical_keys_packed_plain(w, v, k))


@pytest.mark.parametrize("na,nb,n_keep", [(0, 5, 1), (7, 0, 1000),
                                          (2049, 2047, 1025), (0, 0, 0)])
def test_merge_kernels_edge_shapes(card, na, nb, n_keep):
    """Empty sides, lengths off the tile and block sizes."""
    g = torch.Generator(device=card).manual_seed(na + nb)
    a = torch.sort(torch.randint(0, 1 << 20, (na,), device=card,
                                 generator=g)).values
    b = torch.sort(torch.randint(0, 1 << 20, (nb,), device=card,
                                 generator=g)).values
    a_w = torch.ones(na, dtype=torch.int32, device=card)
    args = u64.split_word(a) + (a_w,) + u64.split_word(b)
    assert equal_all(tmerge.merge_sorted(*args),
                     tmerge.merge_sorted_plain(*args))
    planes = [torch.arange(n_keep, dtype=torch.int32, device=card)] * 3
    keep = (torch.rand(n_keep, device=card, generator=g) < 0.5).to(torch.uint8)
    cnt = int(keep.sum())
    assert equal_all(tmerge.compress_flagged(*planes, keep),
                     tmerge.compress_flagged_plain(*planes, keep), cnt)


def compress_case(card, n, p_keep, seed, offset=0):
    """Three random planes and a keep plane of n lanes, each a view
    `offset` lanes into its allocation; kept lanes hold a byte of
    {1, 2, 255}, so any nonzero byte must keep its lane."""
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.integers(-2**31, 2**31, n + offset)
                               .astype(np.int32)).to(card)[offset:]
              for _ in range(3)]
    keep = np.where(rng.random(n + offset) < p_keep,
                    rng.choice(np.array([1, 2, 255], np.uint8), n + offset),
                    0).astype(np.uint8)
    return planes, torch.from_numpy(keep).to(card)[offset:]


def check_compress(planes, keep):
    got = tmerge.compress_flagged(*planes, keep)
    want = tmerge.compress_flagged_plain(*planes, keep)
    assert equal_all(got, want, int((keep != 0).sum()))


@pytest.mark.parametrize("n", [0, 1, 15, 4095, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("p_keep", [0.0, 0.5, 1.0])
def test_compress_kernel_matches_plain(card, n, p_keep):
    """K4 on the kept lanes at lengths off its 2048-lane tile and its
    16-lane keep loads, with nothing, half and everything kept."""
    check_compress(*compress_case(card, n, p_keep, n))


@pytest.mark.parametrize("n", [4097, (1 << 20) + 3])
def test_compress_kernel_on_views_and_aliased_planes(card, n):
    """K4 on planes and a keep plane that start off 16 bytes (x[1:], the
    scalar load path), and with one tensor passed as two planes, as the
    consolidation passes its last chunk."""
    planes, keep = compress_case(card, n, 0.5, n + 1, offset=1)
    check_compress(planes, keep)
    check_compress((planes[0], planes[1], planes[0]), keep)
    aligned, keep = compress_case(card, n, 0.5, n + 2)
    check_compress((aligned[0], planes[1], aligned[2]), keep)


def test_compress_kernel_look_back_across_waves(card):
    """K4 at 2^24 + 7 lanes: 8193 tiles, more than the card holds at
    once, so the look-back walks tiles of finished blocks."""
    check_compress(*compress_case(card, (1 << 24) + 7, 0.5, 24))


def test_count_on_card_gives_the_reference_table(card, tmp_path):
    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    out = str(tmp_path / "t.npz")
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(smoke.smoke_count_args(fq, out)
                    + ["--device", "cuda"]) == 0
    counts = kernels.launch_counts()
    assert counts["pack_canonical_keys_packed"] > 0
    assert counts["merge_sorted"] > 0 and counts["reduce_runs"] > 0
    assert npz_digest(out) == smoke.SMOKE_DIGEST


def card_reads(card, B, L, seed):
    rng = np.random.default_rng(seed)
    reads = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)[
        rng.integers(0, 9, size=(B, L))].copy()
    reads[::3, L // 2:] = ord("N")
    return torch.from_numpy(reads).to(card)


@pytest.mark.parametrize("B,L", [(64, 320), (1, 100), (3, 257), (0, 64)])
def test_hash_kernel_matches_plain(card, B, L):
    """K5 at k in {1, 16, 17, 31, 32}, a seed above 2^32 included; rows
    off the block size and one row."""
    r = card_reads(card, B, L, B + L)
    for k in (1, 16, 17, 31, 32):
        for seed in (0, (1 << 40) + 3):
            assert equal_all(twin.pack_canonical_hash(r, k, seed),
                             twin.pack_canonical_hash_plain(r, k, seed))


@pytest.mark.parametrize("B,L,k", [(64, 320, 63), (1, 63, 63), (3, 100, 33),
                                   (2, 257, 48), (5, 64, 64), (0, 64, 40)])
def test_wide_window_kernels_match_plain(card, B, L, k):
    """K7 and K8 on every lane (K8 leaves invalid lanes unzeroed; its
    kernel and plain version agree there too); L == k, L % 32 != 0, one
    row and no rows."""
    r = card_reads(card, B, L, B * L + k)
    if k <= 63:
        assert equal_all(tww.pack_canonical_keys_wide(r, k),
                         tww.pack_canonical_keys_wide_plain(r, k))
    for seed in (0, 0xDEADBEEF, (1 << 33) + 1):
        assert equal_all(tww.pack_canonical_hash_wide(r, k, seed),
                         tww.pack_canonical_hash_wide_plain(r, k, seed))


def run_reads(card, B, L, seed):
    """[B, L] reads of mostly bases, a tenth of them lower case, with runs
    of N and single other bytes, so that long windows are often valid."""
    rng = np.random.default_rng(seed)
    reads = np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTacgt",
                          dtype=np.uint8)[rng.integers(0, 40, (B, L))].copy()
    for _ in range(B):
        b, p = rng.integers(0, B), rng.integers(0, L)
        reads[b, p:p + rng.integers(1, 40)] = ord("N")
        reads[rng.integers(0, B), rng.integers(0, L)] = rng.choice(
            np.frombuffer(b"nRX.\0", dtype=np.uint8))
    return torch.from_numpy(reads).to(card)


def off_16_bytes(reads):
    """The same reads in a tensor whose data starts 3 bytes into its
    allocation, so that the kernels stage them byte by byte."""
    flat = torch.empty(reads.numel() + 3, dtype=torch.uint8,
                       device=reads.device)[3:]
    return flat.copy_(reads.reshape(-1)).view(reads.shape)


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 30, 31])
def test_window_kernel_rolled_runs_match_plain(card, k):
    """K2 on every lane at rows of k to 257 bases: its runs of 8 lanes
    cross p = L - k and the row's end, a row may be shorter than the
    block's 2048 lanes or than the run, and the 7-row batches also start
    off 8 bytes."""
    for L in sorted({k, 31, 64, 100, 150, 257}):
        for B in (1, 7, 300):
            r = run_reads(card, B, L, B * L + k)
            if B == 7:
                r = off_16_bytes(r)
            want = twin.pack_canonical_keys_plain(r, k)
            assert equal_all(twin.pack_canonical_keys(r, k), want)
            if B == 300:             # valid lanes are among those checked
                assert (want[0] != -(1 << 31)).any()


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32])
def test_hash_kernel_rolled_runs_match_plain(card, k):
    """K5 on every lane at rows of k to 257 bases, two seeds (one above
    2^32): its runs of 8 lanes cross p = L - k and the row's end, a row
    may be shorter than a warp's 256 lanes or than the run, and the 7-row
    batches also start off 8 bytes."""
    for L in sorted({k, 31, 64, 100, 150, 257} - set(range(k))):
        for B in (1, 7, 300):
            r = run_reads(card, B, L, B * L + k)
            if B == 7:
                r = off_16_bytes(r)
            for seed in (0, (1 << 40) + 3):
                want = twin.pack_canonical_hash_plain(r, k, seed)
                assert equal_all(twin.pack_canonical_hash(r, k, seed), want)
                if B == 300:         # valid lanes are among those checked
                    assert want[4].any()


@pytest.mark.parametrize("B,L", [(64, 320), (1, 100), (3, 257), (0, 64)])
def test_stage_variants_match_plain(card, B, L):
    """K2 at stage "pack" and K9 at stage "hash", every order, on every
    lane; rows off the block and tile sizes, one row and no rows."""
    from kmers_tpu_torch.kernels import minimizer as tkmin

    r = card_reads(card, B, L, B * L + 10)
    for k in (1, 15, 16, 17, 31):
        assert equal_all(twin.pack_canonical_keys(r, k, "pack"),
                         twin.pack_canonical_keys_plain(r, k, "pack"))
    for order in tkmin.ORDERS:
        for k, w in ((31, 11), (21, 17), (5, 3), (64, 32), (64, 1)):
            for seed in (0, (1 << 40) + 3):
                assert equal_all(
                    tkmin.minimizer_kernel(r, k, w, seed, order, "hash"),
                    tkmin.minimizer_kernel_plain(r, k, w, seed, order,
                                                 "hash"))


@pytest.mark.parametrize("k", [33, 47, 48, 62, 63, 64])
def test_wide_window_kernel_rolled_runs_match_plain(card, k):
    """K7 (k <= 63) and K8 (two seeds, one above 2^32) on every lane at
    rows of k to 257 bases: their runs of 8 lanes cross p = L - k and the
    row's end (where K8 rolls in the next row's bases and must mask them
    to the plain version's code 0), a row may be shorter than a block's
    1024 or 2048 lanes or than the run's first window, and the 7-row
    batches also start off 8 bytes."""
    for L in sorted({k, 63, 64, 100, 150, 257} - set(range(k))):
        for B in (1, 7, 300):
            r = run_reads(card, B, L, B * L + k)
            if B == 7:
                r = off_16_bytes(r)
            if k <= 63:
                want = tww.pack_canonical_keys_wide_plain(r, k)
                assert equal_all(tww.pack_canonical_keys_wide(r, k), want)
                if B == 300:         # valid lanes are among those checked
                    assert (want[0] != -(1 << 31)).any()
            for seed in (0, (1 << 33) + 1):
                want = tww.pack_canonical_hash_wide_plain(r, k, seed)
                assert equal_all(tww.pack_canonical_hash_wide(r, k, seed),
                                 want)
                if B == 300:
                    assert want[6].any()


@pytest.mark.parametrize("na,nb", [(40000, 50000), (0, 5), (7, 0),
                                   (1025, 1023), (0, 0)])
def test_wide_merge_kernel_matches_plain(card, na, nb):
    """K6: 128-bit keys sharing high words (ties in every plane), a dead
    tail on both sides; lengths off the 1024-lane tile."""
    g = torch.Generator(device=card).manual_seed(na + nb)
    rand = lambda n, top: torch.randint(0, top, (n,), device=card,
                                        generator=g)
    from kmers_tpu_torch.core import u128

    def sorted_side(n, dead):
        hi = rand(n, 1 << 4) << 58           # few distinct high words
        lo = rand(n, 1 << 62) - (1 << 61)    # both signs of the low word
        hi = torch.where(torch.arange(n, device=card) >= n - dead,
                         u64.SIGN_BIT, hi)
        order = u128.argsort(hi, lo)
        return u128.split_planes(hi[order], lo[order])

    a_keys = sorted_side(na, na // 5)
    b_keys = sorted_side(nb, nb // 7)
    a_w = rand(na, 100).to(torch.int32)
    got = tmerge.merge_sorted_wide(a_keys, a_w, b_keys)
    want = tmerge.merge_sorted_wide_plain(a_keys, a_w, b_keys)
    assert equal_all(got[0] + (got[1],), want[0] + (want[1],))


def test_wide_count_on_card_gives_the_reference_table(card, tmp_path):
    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    out, a_out = str(tmp_path / "t.npz"), str(tmp_path / "a.npz")
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(smoke.smoke_count_args(fq, out, 63)
                    + ["--device", "cuda"]) == 0
        assert main(smoke.smoke_count_args(fq, a_out, 63)
                    + ["--ascii-ingest", "--device", "cuda"]) == 0
    counts = kernels.launch_counts()
    assert counts["merge_sorted_wide"] > 0 and counts["reduce_runs"] > 0
    assert counts["pack_canonical_keys_wide"] > 0
    assert npz_digest(out) == npz_digest(a_out) == smoke.SMOKE_DIGEST_WIDE


@pytest.mark.parametrize("B,L", [(64, 320), (1, 100), (3, 257), (0, 64)])
def test_minimizer_kernel_matches_plain(card, B, L):
    """K9 on every lane (invalid lanes are zero in both), every order, the
    (k, w) pairs of the minimizer path and its edges (k up to 64, w from 1
    to 32); rows off the block size, L % 32 != 0, one row and no rows."""
    from kmers_tpu_torch.kernels import minimizer as tkmin

    r = card_reads(card, B, L, B * L + 9)
    for order in tkmin.ORDERS:
        for k, w in ((31, 11), (21, 7), (18, 4), (16, 5), (31, 31), (5, 3),
                     (45, 13), (64, 32), (64, 1)):
            for seed in (0, (1 << 40) + 3):
                assert equal_all(tkmin.minimizer_kernel(r, k, w, seed, order),
                                 tkmin.minimizer_kernel_plain(r, k, w, seed,
                                                              order))


@pytest.mark.parametrize("B", [4096, 1024])
def test_minimizer_kernel_at_the_sharded_batch_shapes(card, B):
    """K9 at the [B, 256] batches the sharded minimizer runs give it (D = 1
    and D = 4): rows of one repeated base (every order ties, so the
    leftmost candidate must win), N at the first and at the last base,
    k = 64 with w = 1 (the widest candidate window) and k = w."""
    from kmers_tpu_torch.kernels import minimizer as tkmin

    rng = np.random.default_rng(B)
    reads = np.frombuffer(b"ACGTacgt", dtype=np.uint8)[
        rng.integers(0, 8, size=(B, 256))].copy()
    for i, base in enumerate(b"ACGTacgt"):
        reads[i] = base
    reads[8::7, 0] = ord("N")
    reads[9::7, -1] = ord("N")
    reads[10::7, 100:103] = ord("N")
    r = torch.from_numpy(reads).to(card)
    for order in tkmin.ORDERS:
        for k, w in ((31, 11), (64, 1), (31, 31), (32, 32), (64, 32)):
            for seed in (0, (1 << 40) + 3):
                assert equal_all(tkmin.minimizer_kernel(r, k, w, seed, order),
                                 tkmin.minimizer_kernel_plain(r, k, w, seed,
                                                              order))


@pytest.mark.parametrize("partition", ["hash", "minimizer"])
def test_sharded_count_on_card_gives_the_reference_table(card, tmp_path,
                                                         partition):
    """Two shards on the one card: the smoke input's table, through K9
    (minimizer partition), K3 and K13."""
    from kmers_tpu_torch.parallel.mesh import make_mesh
    from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                                 count_fastx)

    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    sc = ShardedStreamingCounter(31, 65536, merge_every=4,
                                 mesh=make_mesh(devices=[card] * 2),
                                 route_capacity=(16384 if partition == "hash"
                                                 else 2048),
                                 partition=partition)
    kernels.reset_launch_counts()
    count_fastx(fq, 31, 65536, device=card, batch=256, length=160,
                counter=sc)
    sc.save(str(tmp_path / "t"))
    counts = kernels.launch_counts()
    assert sc.route_overflow == 0
    assert counts["merge_sorted"] > 0 and counts["reduce_runs"] > 0
    assert (counts["minimizer_kernel"] > 0) == (partition == "minimizer")
    assert npz_digest(str(tmp_path / "t.npz")) == smoke.SMOKE_DIGEST


def folded_keys(card, n, n_planes, k, seed, distinct=5000):
    """n folded keys of k bases (2 or 4 planes, drawn from `distinct`
    values so that runs repeat), a fifth of them invalid:
    (0x80000000, 0[, 0, 0])."""
    from kmers_tpu_torch.core import u128

    g = torch.Generator(device=card).manual_seed(seed)
    rand = lambda m, bits: torch.randint(0, 1 << bits, (m,), device=card,
                                         generator=g)
    pick = torch.randint(0, distinct, (n,), device=card, generator=g)
    valid = torch.rand(n, device=card, generator=g) >= 0.2
    if n_planes == 2:
        word = rand(distinct, 2 * k)[pick]
        return u64.fold_invalid(word, valid)
    hi = rand(distinct, 2 * k - 64)[pick]
    lo = (rand(distinct, 62)[pick] << 2) - (1 << 63)   # bit 63 set too
    return u128.fold_invalid(hi, lo, valid)


def patterned(planes):
    """The folded planes with their first quarter one valid key, the
    second all invalid and the third alternating between two keys (whole
    segments of every size at n >= 16384)."""
    n = planes[0].shape[0]
    q = n // 4
    idx = torch.arange(q, device=planes[0].device)
    out = []
    for i, p in enumerate(planes):
        p = p.clone()
        p[:q] = i + 1                              # bit 31 of plane 0 clear
        p[q:2 * q] = -(1 << 31) if i == 0 else 0        # invalid
        p[2 * q:3 * q] = torch.where(idx % 2 == 0, 7 * i + 5, 7 * i + 6).to(
            torch.int32)
        out.append(p)
    return tuple(out)


@pytest.mark.parametrize("n", [0, 1, 777, 16384, 1 << 20, 1_000_003])
def test_segment_count_kernel_matches_plain(card, n):
    """K10 narrow (k=31) and wide (k=63) on every output lane, at every
    segment size from 8 to 65536 (past SEG_LANES_MAX = 4096 through the
    merge rounds), n on and off the block size; random keys, and segments
    of one key, of invalid lanes only and of two alternating keys."""
    from kmers_tpu_torch.kernels import count_tile as tct

    for n_planes, k, fn in ((2, 31, tct.segment_count_keys),
                            (4, 63, tct.segment_count_keys_wide)):
        planes = folded_keys(card, n, n_planes, k, n + n_planes)
        for keys in (planes, patterned(planes)):
            for seg in (1 << i for i in range(3, 17)):
                blk = max(seg, 1 << 14 if n > 4096 else 1024)
                got = fn(*keys, seg_lanes=seg, block_lanes=blk)
                want = tct.segment_count_plain(keys, seg, blk)
                assert equal_all(got, want), (n_planes, seg)
    keys = folded_keys(card, 64, 2, 31, 0)
    got = tct.segment_count_keys(*keys, seg_lanes=2 * tct.SEG_LANES_MAX)
    assert equal_all(got, tct.segment_count_plain(keys, 2 * tct.SEG_LANES_MAX,
                                                  1 << 14))


def test_count_words_segmented_past_one_block_on_card(card):
    """count_words_segmented and its _wide form at 8192-lane segments run
    on the card and give the CPU's run-length table lane for lane."""
    from kmers_tpu_torch.parallel import count

    g = torch.Generator(device=card).manual_seed(14)
    n = 20000
    valid = torch.rand(n, device=card, generator=g) >= 0.2
    words = torch.randint(0, 1 << 62, (3000,), device=card, generator=g)[
        torch.randint(0, 3000, (n,), device=card, generator=g)]
    kernels.reset_launch_counts()
    got = count.count_words_segmented(words, valid, seg_lanes=8192)
    want = count.count_words_segmented(words.cpu(), valid.cpu(),
                                       seg_lanes=8192)
    assert kernels.launch_counts()["segment_count_keys"] == 1
    assert got.n_unique == want.n_unique
    assert equal_all((got.keys_hi, got.keys_lo, got.counts),
                     tuple(t.to(card) for t in (want.keys_hi, want.keys_lo,
                                                want.counts)))
    hi = torch.randint(0, 1 << 62, (n,), device=card, generator=g)
    wide = (hi, words)
    got = count.count_words_segmented_wide(wide, valid, seg_lanes=8192)
    want = count.count_words_segmented_wide(tuple(w.cpu() for w in wide),
                                            valid.cpu(), seg_lanes=8192)
    assert kernels.launch_counts()["segment_count_keys_wide"] == 1
    assert got.n_unique == want.n_unique
    assert equal_all(got.keys + (got.counts,),
                     tuple(t.to(card) for t in want.keys + (want.counts,)))


@pytest.mark.parametrize("B", [13, 1, 524_289])
def test_packed_window_kernel_matches_plain(card, B):
    """K1 at L off and on its 256-lane chunk, every k boundary, B not a
    multiple of the 8 rows a block takes (524,289 rows at L = 32 pass the
    grid's 65,535 x 8 rows, so warps walk a second row), and runs of N at
    both row edges."""
    rng = np.random.default_rng(B)
    for L in ((32,) if B > 1000 else (32, 64, 256, 288, 1024)):
        reads = np.frombuffer(b"ACGTacgt", dtype=np.uint8)[
            rng.integers(0, 8, size=(B, L))].copy()
        reads[::3, :5] = ord("N")
        reads[1::3, L - 7:] = ord("N")
        reads[2::5, L // 2] = ord("N")
        words, vbits = fastx.pack_batch_np(reads)
        w = torch.from_numpy(words.view(np.int32)).to(card)
        v = torch.from_numpy(vbits.view(np.int32)).to(card)
        for k in (1, 15, 16, 17, 31):
            assert equal_all(twin.pack_canonical_keys_packed(w, v, k),
                             twin.pack_canonical_keys_packed_plain(w, v, k)), (
                L, k)


@pytest.mark.parametrize("k", range(1, 32))
def test_packed_pack_stage_matches_plain(card, k):
    """K1 at stage "pack" (the forward words) on every lane, at every k:
    rows on and off the 256-lane chunk, B off the 8-row block, Ns at both
    row edges; counted under its own launch name."""
    rng = np.random.default_rng(100 + k)
    for B, L in ((13, 32), (64, 288), (5, 1024)):
        reads = np.frombuffer(b"ACGTacgt", dtype=np.uint8)[
            rng.integers(0, 8, size=(B, L))].copy()
        reads[::3, :5] = ord("N")
        reads[1::3, L - 7:] = ord("N")
        words, vbits = fastx.pack_batch_np(reads)
        w = torch.from_numpy(words.view(np.int32)).to(card)
        v = torch.from_numpy(vbits.view(np.int32)).to(card)
        kernels.reset_launch_counts()
        got = twin.pack_canonical_keys_packed(w, v, k, "pack")
        assert kernels.launch_counts()["pack_canonical_keys_packed[pack]"] == 1
        assert equal_all(got, twin.pack_canonical_keys_packed_plain(
            w, v, k, "pack")), (B, L)


def same_table(a, b) -> bool:
    return equal_all(a.keys, b.keys) and (
        not hasattr(a, "counts") or (torch.equal(a.counts, b.counts)
                                     and a.n_unique == b.n_unique))


@pytest.mark.parametrize("axis", ["d", "s"])
def test_two_axis_mesh_on_card_equals_the_one_axis_run(card, axis):
    """A (2, 2) mesh on the one card, over each axis: the hash counter
    (k = 31, K11), the super-k-mer counter (K9, K4), the sequence-parallel
    counter and the lookup's merge arm (K3 with idx) give every local
    shard the table of the one-axis D = 2 run at its index along the axis,
    and that run's metrics and answers."""
    from kmers_tpu_torch.parallel import mesh, pipeline

    m22 = mesh.make_mesh(devices=[card] * 4, seq_shards=2)
    m2 = mesh.make_mesh(devices=[card] * 2)
    pos = mesh.axis_positions(m22, axis)
    reads = run_reads(card, 64, 150, 7)
    seq = run_reads(card, 1, 4096, 8).reshape(-1)
    steps = (
        (lambda m, **kw: pipeline.make_sharded_counter(
            m, 31, route_capacity=8192, **kw), reads),
        (lambda m, **kw: pipeline.make_superkmer_counter(
            m, 31, 11, route_capacity=1024, **kw), reads),
        (lambda m, **kw: pipeline.make_sequence_parallel_counter(
            m, 31, route_capacity=2048, **kw), seq))
    kernels.reset_launch_counts()
    for make, x in steps:
        got, want = make(m22, axis=axis)(x), make(m2)(x)
        assert all(same_table(t, want.table[p])
                   for t, p in zip(got.table, pos))
        assert {n: int(v) for n, v in got.metrics.items()} == {
            n: int(v) for n, v in want.metrics.items()}
        assert int(got.metrics["route_overflow"]) == 0
    tables = pipeline.make_sharded_counter(m22, 31, route_capacity=8192,
                                           axis=axis)(reads).table
    words, valid = pipeline.canonical_kmers(reads, 31)
    words, valid = words.reshape(-1), valid.reshape(-1)
    look = lambda m, t, **kw: pipeline.make_sharded_lookup(
        m, query_capacity=8192, max_k=31, merge_lookup=True, **kw)(
            t, words, valid)
    got = look(m22, tables, axis=axis)
    want = look(m2, [tables[pos.index(p)] for p in range(2)])
    assert torch.equal(got[0], want[0]) and int(got[1]) == 0
    launched = kernels.launch_counts()
    for name in ("radix_sort_u64", "minimizer_kernel", "compress_flagged",
                 "merge_sorted_idx"):
        assert launched[name] > 0, name


@pytest.mark.parametrize("n", [0, 1, 2, 4095, 4096, 4097, 1 << 20, 1_000_003])
def test_radix_sort_kernel_matches_plain(card, n):
    """K11 against torch.sort of the unsigned words: full 64-bit keys with
    duplicates and flagged lanes, short keys (most passes skipped), and
    all keys equal."""
    from kmers_tpu_torch.kernels import sort as tsort

    g = torch.Generator(device=card).manual_seed(n)
    full = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), device=card,
                         generator=g)
    if n > 8:
        full[: n // 4] = full[n // 2: n // 2 + n // 4]
    flagged = u64.fold_invalid(
        torch.randint(0, 1 << 62, (n,), device=card, generator=g),
        torch.rand(n, device=card, generator=g) < 0.7)
    short = u64.split_word(torch.randint(0, 1 << 22, (n,), device=card,
                                         generator=g))
    same = u64.split_word(torch.full((n,), 12345, device=card,
                                     dtype=torch.int64))
    for hi, lo in (u64.split_word(full), flagged, short, same):
        assert equal_all(tsort.radix_sort_u64(hi, lo),
                         tsort.radix_sort_u64_plain(hi, lo))


@pytest.mark.parametrize("tiles,extra", [(1, -1), (1, 0), (1, 1), (37, 1),
                                         (0, 1 << 24)])
def test_radix_sort_kernel_digit_layouts(card, tiles, extra):
    """K11 at n on and off its tile (tiles * tile + extra keys) and at 2^24
    keys, for the digit layouts that choose its passes: keys that
    differ in one byte only (each byte in turn), or only at bit 63 (one
    pass), in three bytes (an odd number of passes), and full-width keys
    with duplicates (eight passes; a pass that is not stable breaks
    them)."""
    from kmers_tpu_torch.kernels import _build
    from kmers_tpu_torch.kernels import sort as tsort

    n = tiles * _build.lib().kt_radix_tile() + extra
    g = torch.Generator(device=card).manual_seed(n)
    rand = lambda bits: torch.randint(0, 1 << bits, (n,), device=card,
                                      generator=g)
    base = 0x0123456789ABCDEF
    layouts = [base ^ (rand(8) << (8 * b)) for b in range(7)]
    layouts.append(base ^ u64.shl(rand(8), 56))
    layouts.append(base | torch.where(rand(1) == 1, u64.SIGN_BIT, 0))
    layouts.append(base ^ (rand(8) << 8) ^ (rand(8) << 32) ^ (rand(7) << 56))
    full = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), device=card,
                         generator=g)
    full[: n // 4] = full[n // 2: n // 2 + n // 4]
    layouts.append(full)
    for words in layouts:
        hi, lo = u64.split_word(words)
        assert equal_all(tsort.radix_sort_u64(hi, lo),
                         tsort.radix_sort_u64_plain(hi, lo))


@pytest.mark.parametrize("k,compact,kernel", [
    (31, True, "radix_sort_u64"), (31, False, "segment_count_keys"),
    (63, False, "segment_count_keys_wide"), (32, True, None),
    (64, False, None)])
def test_count_forms_on_card_match_the_cpu(card, k, compact, kernel):
    """count_reads(_wide) on the card launches K11 (compact, k <= 31) or
    K10 (run-length, k <= 31 / k <= 63) and gives the CPU's table."""
    from kmers_tpu_torch.parallel import pipeline

    reads = card_reads(card, 64, 320, k)
    count = pipeline.count_reads_wide if k > 32 else pipeline.count_reads
    kernels.reset_launch_counts()
    got = count(reads, k, compact=compact).table
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    want = count(reads.cpu(), k, compact=compact).table
    assert got.n_unique == want.n_unique
    assert equal_all(tuple(p.cpu() for p in got.keys) + (got.counts.cpu(),),
                     tuple(want.keys) + (want.counts,))
    if kernel:
        assert launched[kernel] == 1


@pytest.mark.parametrize("k", [32, 64])
def test_full_width_count_on_card_gives_the_reference_table(card, tmp_path,
                                                            k):
    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    out = str(tmp_path / "t.npz")
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(smoke.smoke_count_args(fq, out, k)
                    + ["--device", "cuda"]) == 0
    assert npz_digest(out) == smoke.SMOKE_DIGESTS[k]


def merge_idx_sides(card, na, nb, kind, seed):
    """K3's two sorted sides: random keys (a dead tail on both), every key
    dead, or every key equal (ties between and within the sides)."""
    g = torch.Generator(device=card).manual_seed(seed)
    if kind == "random":
        a = torch.unique(torch.randint(0, 1 << 40, (na,), device=card,
                                       generator=g))
        a = torch.cat([a, torch.full((na - a.shape[0],), -1, device=card)])
        b = torch.randint(0, 1 << 40, (nb,), device=card, generator=g)
        b[nb - nb // 8:] = u64.SIGN_BIT
        b = u64.to_unsigned_order(torch.sort(u64.to_unsigned_order(b)).values)
    elif kind == "dead":
        a = torch.full((na,), -1, device=card)
        b = torch.full((nb,), u64.SIGN_BIT, device=card)
    else:
        a = torch.full((na,), 12345, device=card)
        b = torch.full((nb,), 12345, device=card)
    a_w = torch.randint(0, 100, (na,), device=card, generator=g,
                        dtype=torch.int32)
    return u64.split_word(a) + (a_w,) + u64.split_word(b)


@pytest.mark.parametrize("total", ["0", "1", "tile-1", "tile+1", "2^20+3"])
def test_merge_idx_kernel_matches_plain(card, total):
    """K3 with its source-index plane at nA + nB lanes on and off its tile,
    split both ways; random, all-dead and all-equal keys."""
    from kmers_tpu_torch.kernels import _build

    tile = _build.lib().kt_merge_tile()
    n = {"0": 0, "1": 1, "tile-1": tile - 1, "tile+1": tile + 1,
         "2^20+3": (1 << 20) + 3}[total]
    for na in {n // 3, n - n // 3}:
        for kind in ("random", "dead", "equal"):
            args = merge_idx_sides(card, na, n - na, kind, n + na)
            kernels.reset_launch_counts()
            got = tmerge.merge_sorted(*args, with_idx=True)
            assert kernels.launch_counts()["merge_sorted_idx"] == 1
            assert equal_all(got, tmerge.merge_sorted_plain(
                *args, with_idx=True)), (na, kind)
            assert equal_all(got[:3], tmerge.merge_sorted(*args))


def test_lookup_arms_agree_on_card(card):
    """make_sharded_lookup on two shards of the card: both answer arms
    give the CPU's answers, and the merge arm launches K3 with idx and
    K4."""
    from kmers_tpu_torch.parallel import pipeline
    from kmers_tpu_torch.parallel.mesh import make_mesh

    reads = card_reads(card, 64, 320, 7)
    answers = {}
    for dev in (card, torch.device("cpu")):
        mesh = make_mesh(devices=[dev] * 2)
        res = pipeline.make_sharded_counter(mesh, 31, route_capacity=8192)(
            reads.to(dev))
        keys = torch.cat([u64.join_planes(t.keys_hi[:t.n_unique],
                                          t.keys_lo[:t.n_unique]).cpu()
                          for t in res.table])
        g = torch.Generator().manual_seed(3)
        words = torch.cat([keys[torch.randint(0, keys.shape[0], (3000,),
                                              generator=g)],
                           torch.randint(0, 1 << 62, (1000,), generator=g)])
        valid = torch.rand(4000, generator=g) < 0.8
        words[5] = u64.feistel_unmix(torch.full((1,), -1), 0)[0]
        valid[:5], valid[5] = False, True
        for merge in (False, True):
            kernels.reset_launch_counts()
            got, overflow = pipeline.make_sharded_lookup(
                mesh, query_capacity=4096, max_k=31, merge_lookup=merge)(
                    res.table, words.to(dev), valid.to(dev))
            launched = kernels.launch_counts()
            assert int(overflow) == 0
            answers[dev.type, merge] = got.cpu()
            if dev.type == "cuda" and merge:
                assert launched["merge_sorted_idx"] == 2
                assert launched["compress_flagged"] == 2
    want = answers["cpu", False]
    assert (want[6:3000][valid[6:3000]] > 0).all() and want[5] == 0
    for got in answers.values():
        assert torch.equal(got, want)


def test_parity_surface_on_card_gives_the_pinned_digest(card):
    """SeqVector and the generic layer on the card give the outputs that
    PARITY_DIGEST pins to kmers_tpu's, array for array the CPU's."""
    got = smoke.parity_arrays(card)
    assert smoke.digest_arrays(got) == smoke.PARITY_DIGEST
    for g, w in zip(got, smoke.parity_arrays("cpu")):
        assert np.array_equal(g, w)


def test_seqvector_reads_past_its_words_on_card(card):
    """A read past the stored words gives the CPU's (JAX's) filled word,
    with no device-side assert."""
    from kmers_tpu_torch.ops.seqvector import SeqVector

    words = torch.tensor([0x12345678, 0x9ABCDEF0, 0xFFFF0000], dtype=torch.int64)
    pos = torch.arange(-3, 70)
    for k in (1, 17, 32):
        want = SeqVector(words, 48).get_kmers(pos, k)
        got = SeqVector(words.to(card), 48).get_kmers(pos.to(card), k)
        assert torch.equal(got.cpu(), want)
