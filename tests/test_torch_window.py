"""Window kernels K1/K2 of the port against the JAX package's Pallas
kernels (interpret mode), on the CPU.  The CUDA kernels are compared with
these plain versions on the card by test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.kernels import window as jwin
from kmers_tpu_torch import kernels
from kmers_tpu_torch.kernels import window as twin

from test_torch_kmer import make_reads


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_pack_canonical_keys_plain_matches_pallas(k):
    """K2: every lane, invalid lanes exactly (0x80000000, 0); rows of 256
    bases, of the reads' own 150 (off every run and tile size of the card's
    kernel) and of k (one window a row)."""
    for L in (256, 150, k):
        reads = make_reads(300 + k + L, 8, L)
        want_hi, want_lo = jwin.pack_canonical_keys(
            jnp.asarray(reads), k, block_rows=8, interpret=True)
        hi, lo = twin.pack_canonical_keys_plain(torch.from_numpy(reads), k)
        np.testing.assert_array_equal(as_u32(hi), np.asarray(want_hi))
        np.testing.assert_array_equal(as_u32(lo), np.asarray(want_lo))


@pytest.mark.parametrize("k,L", [(7, 128), (16, 128), (17, 256), (31, 256)])
def test_pack_canonical_keys_packed_plain_matches_pallas(k, L):
    """K1: the TPU kernel emits q-order, the port p-order; lane q of the
    TPU output is the window at base qspace_positions(L)[q]."""
    reads = make_reads(400 + k, 8, L)
    words, vbits = pack_batch_np(reads)
    want_hi, want_lo = jwin.pack_canonical_keys_packed(
        jnp.asarray(words), jnp.asarray(vbits), k, block_rows=8,
        interpret=True)
    hi, lo = twin.pack_canonical_keys_packed_plain(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(vbits.view(np.int32)), k)
    p_of_q = jwin.qspace_positions(L)
    np.testing.assert_array_equal(as_u32(hi)[:, p_of_q], np.asarray(want_hi))
    np.testing.assert_array_equal(as_u32(lo)[:, p_of_q], np.asarray(want_lo))


@pytest.mark.parametrize("k", [1, 16, 17, 31])
def test_pack_stage_plain_matches_pallas(k):
    """K2 at stage "pack" (the forward word folded in place of the
    canonical one): every lane, at rows of 256 bases, of 150 and of k."""
    for L in (256, 150, k):
        reads = make_reads(700 + k + L, 8, L)
        want_hi, want_lo = jwin.pack_canonical_keys(
            jnp.asarray(reads), k, stage="pack", block_rows=8, interpret=True)
        hi, lo = twin.pack_canonical_keys_plain(torch.from_numpy(reads), k,
                                                "pack")
        np.testing.assert_array_equal(as_u32(hi), np.asarray(want_hi))
        np.testing.assert_array_equal(as_u32(lo), np.asarray(want_lo))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_packed_pack_stage_matches_pallas(k):
    """K1 at stage "pack" (the forward word folded in place of the
    canonical one), wrapper and plain version, every lane through
    qspace_positions, at rows of 128 and 256 bases with Ns; invalid lanes
    exactly (0x80000000, 0)."""
    for L in (128, 256):
        reads = make_reads(900 + k + L, 8, L)
        words, vbits = pack_batch_np(reads)
        want_hi, want_lo = jwin.pack_canonical_keys_packed(
            jnp.asarray(words), jnp.asarray(vbits), k, stage="pack",
            block_rows=8, interpret=True)
        w = torch.from_numpy(words.view(np.int32))
        v = torch.from_numpy(vbits.view(np.int32))
        p_of_q = jwin.qspace_positions(L)
        for hi, lo in (twin.pack_canonical_keys_packed(w, v, k, "pack"),
                       twin.pack_canonical_keys_packed_plain(w, v, k,
                                                             "pack")):
            np.testing.assert_array_equal(as_u32(hi)[:, p_of_q],
                                          np.asarray(want_hi))
            np.testing.assert_array_equal(as_u32(lo)[:, p_of_q],
                                          np.asarray(want_lo))
        invalid = as_u32(hi) == 0x80000000
        assert invalid.any() and (~invalid).any()
        assert not as_u32(lo)[invalid].any()


def test_wrappers_take_the_plain_version_on_cpu():
    reads = make_reads(9, 4, 64)
    words, vbits = pack_batch_np(reads)
    w = torch.from_numpy(words.view(np.int32))
    v = torch.from_numpy(vbits.view(np.int32))
    r = torch.from_numpy(reads)
    kernels.reset_launch_counts()
    for got, want in ((twin.pack_canonical_keys_packed(w, v, 21),
                       twin.pack_canonical_keys_packed_plain(w, v, 21)),
                      (twin.pack_canonical_keys(r, 21),
                       twin.pack_canonical_keys_plain(r, 21))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = twin.pack_canonical_keys(r, 21, "pack")
    want = twin.pack_canonical_keys_plain(r, 21, "pack")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = twin.pack_canonical_keys_packed(w, v, 21, "pack")
    want = twin.pack_canonical_keys_packed_plain(w, v, 21, "pack")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the packed and ASCII forward keys are the same lanes
    assert torch.equal(got[1], twin.pack_canonical_keys(r, 21, "pack")[1])
    # a CPU tensor runs no kernel, so nothing is counted
    assert set(kernels.launch_counts().values()) == {0}
    # the packed and ASCII keys are the same lanes
    assert torch.equal(twin.pack_canonical_keys_packed(w, v, 21)[0],
                       twin.pack_canonical_keys(r, 21)[0])


def test_wrappers_check_their_inputs():
    reads = torch.from_numpy(make_reads(1, 2, 64))
    with pytest.raises(TypeError):
        twin.pack_canonical_keys(reads.to(torch.int32), 5)
    with pytest.raises(ValueError):
        twin.pack_canonical_keys(reads, 32)
    with pytest.raises(ValueError):
        twin.pack_canonical_keys(reads[:, ::2], 5)
    w = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        twin.pack_canonical_keys_packed(w, torch.zeros((2, 1), dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        twin.pack_canonical_keys_packed(torch.zeros((2, 3), dtype=torch.int32),
                                        torch.zeros((2, 1), dtype=torch.int32), 5)


def test_wrappers_reject_an_unknown_stage():
    reads = torch.from_numpy(make_reads(2, 2, 64))
    words, vbits = (torch.from_numpy(a.view(np.int32))
                    for a in pack_batch_np(reads.numpy()))
    for call in (lambda: twin.pack_canonical_keys(reads, 5, "full"),
                 lambda: twin.pack_canonical_keys_plain(reads, 5, "hash"),
                 lambda: twin.pack_canonical_keys(reads, 5, "Pack"),
                 lambda: twin.pack_canonical_keys_plain(reads, 5, ""),
                 lambda: twin.pack_canonical_keys_packed(words, vbits, 5,
                                                         "full"),
                 lambda: twin.pack_canonical_keys_packed_plain(words, vbits,
                                                               5, "hash")):
        with pytest.raises(ValueError, match="canon.*pack"):
            call()
