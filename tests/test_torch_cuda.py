"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA card, and the count path on the card against the CPU.

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


def test_count_on_card_gives_the_reference_table(card, tmp_path):
    fq = smoke.write_smoke_input(str(tmp_path / "smoke.fastq"))
    out = str(tmp_path / "t.npz")
    kernels.reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(smoke.smoke_count_args(fq, out)
                    + ["--device", "cuda"]) == 0
    counts = kernels.launch_counts()
    assert counts["pack_canonical_keys_packed"] > 0
    assert counts["merge_sorted"] > 0 and counts["compress_flagged"] > 0
    assert npz_digest(out) == smoke.SMOKE_DIGEST
