"""The port's hashes and hash emitters against the JAX package, on the CPU:
the 64- and 128-bit mixer hashes, and the plain versions of the window
kernels K5 (pack_canonical_hash) and K8 (pack_canonical_hash_wide)
against the Pallas kernels in interpret mode.  The CUDA kernels are
compared with these plain versions on the card by test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.core import u128 as ju128
from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.kernels import window as jwin
from kmers_tpu.kernels import window_wide as jww
from kmers_tpu.ops import hash as jhash
from kmers_tpu_torch import kernels
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.core import u128 as tu128
from kmers_tpu_torch.kernels import window as twin
from kmers_tpu_torch.kernels import window_wide as tww
from kmers_tpu_torch.ops import hash as thash

from test_torch_kmer import make_reads

SEEDS = [0, 7, 0xDEADBEEF, (1 << 40) + 12345]


def u64_words(rng, n):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def jax_u64(words: np.ndarray) -> U64:
    return U64(jnp.asarray((words >> np.uint64(32)).astype(np.uint32)),
               jnp.asarray((words & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_hash_matches_jax(seed):
    """Every multiply keeps its low 32 bits; seeds above 2^32 reach the
    high half."""
    words = u64_words(np.random.default_rng(seed & 0xFFFF), 4096)
    want = ju.to_numpy(jhash.mix_hash(jax_u64(words), seed))
    t = torch.from_numpy(words.view(np.int64))
    np.testing.assert_array_equal(
        thash.mix_hash(t, seed).numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        thash.mix_hash_fn(seed)(t).numpy().view(np.uint64), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_hash_wide_matches_jax(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    hi, lo = u64_words(rng, 4096), u64_words(rng, 4096)
    want = ju.to_numpy(ju128.mix_hash(U128(jax_u64(hi), jax_u64(lo)), seed))
    got = thash.mix_hash_wide(torch.from_numpy(hi.view(np.int64)),
                              torch.from_numpy(lo.view(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert torch.equal(got, tu128.mix_hash(torch.from_numpy(hi.view(np.int64)),
                                           torch.from_numpy(lo.view(np.int64)),
                                           seed))


def test_mix32_matches_jax_on_edge_values():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x12345678],
                 np.uint32)
    want = np.asarray(ju._mix32(jnp.asarray(x)))
    got = tu.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [3, (1 << 33) + 1])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32])
def test_pack_canonical_hash_plain_matches_pallas(k, seed):
    """K5: every lane; invalid lanes are zero in the four words."""
    reads = make_reads(500 + k, 8, 256)
    want = jwin.pack_canonical_hash(jnp.asarray(reads), k, seed=seed,
                                    block_rows=8, interpret=True)
    got = twin.pack_canonical_hash_plain(torch.from_numpy(reads), k, seed)
    assert len(got) == 5
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(as_u32(g), np.asarray(w))
    assert got[4].dtype == torch.uint8
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("k", [1, 16, 17, 31, 32])
def test_pack_canonical_hash_plain_matches_pallas_on_short_rows(k):
    """K5 at rows of the reads' own 150 bases (off every run and tile size
    of the card's kernel) and of k (one window a row): every lane."""
    for L in (150, k):
        reads = make_reads(900 + k + L, 8, L)
        want = jwin.pack_canonical_hash(jnp.asarray(reads), k,
                                        seed=(1 << 40) + 3, block_rows=8,
                                        interpret=True)
        got = twin.pack_canonical_hash_plain(torch.from_numpy(reads), k,
                                             (1 << 40) + 3)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(as_u32(g), np.asarray(w))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("k", [33, 47, 48, 49, 63, 64])
def test_pack_canonical_hash_wide_plain_matches_pallas(k):
    """K8: valid lanes (invalid lanes are not zeroed on either side); at
    k = 64 also rows of the reads' own 150 bases, off every run and tile
    size of the card's kernel."""
    for L in (256, 150) if k == 64 else (256,):
        reads = make_reads(600 + k + L - 256, 8, L)
        want = jww.pack_canonical_hash_wide(jnp.asarray(reads), k, seed=7,
                                            block_rows=8, interpret=True)
        got = tww.pack_canonical_hash_wide_plain(torch.from_numpy(reads), k,
                                                 7)
        v = np.asarray(want[6]).astype(bool)
        np.testing.assert_array_equal(got[6].numpy().astype(bool), v)
        assert v.any() and not v.all()
        for g, w in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(as_u32(g)[v], np.asarray(w)[v])


def test_hash_wrappers_take_the_plain_version_on_cpu():
    r = torch.from_numpy(make_reads(12, 4, 100))
    kernels.reset_launch_counts()
    for got, want in ((twin.pack_canonical_hash(r, 31, 5),
                       twin.pack_canonical_hash_plain(r, 31, 5)),
                      (tww.pack_canonical_hash_wide(r, 63, 5),
                       tww.pack_canonical_hash_wide_plain(r, 63, 5))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(kernels.launch_counts().values()) == {0}


def test_hash_wrappers_check_their_inputs():
    r = torch.from_numpy(make_reads(13, 2, 64))
    with pytest.raises(ValueError):
        twin.pack_canonical_hash(r, 33)
    with pytest.raises(ValueError):
        tww.pack_canonical_hash_wide(r, 32)
    with pytest.raises(ValueError):
        tww.pack_canonical_hash_wide(r[:, :40], 41)
    with pytest.raises(TypeError):
        twin.pack_canonical_hash(r.to(torch.int32), 21)
