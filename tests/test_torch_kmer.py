"""Port (kmers_tpu_torch) k-mer windows against the JAX package, on the CPU.

The same seeded reads go through kmers_tpu.ops.kmer and its port; words
are compared on valid lanes (invalid lanes hold unspecified garbage in
both), bit for bit.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.ops import kmer as jkmer
from kmers_tpu.oracle import numpy_ref as oracle
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.ops import encoding as tenc
from kmers_tpu_torch.ops import kmer as tkmer


def make_reads(seed, B, L, n_frac=0.04, lower_frac=0.1, pad=True):
    """ASCII reads with N bases, lowercase bases and N padding tails."""
    rng = np.random.default_rng(seed)
    reads = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, L))
    reads[rng.random((B, L)) < n_frac] = ord("N")
    reads[rng.random((B, L)) < lower_frac] |= 0x20
    if pad:
        for b in range(0, B, 3):           # ragged reads padded with N
            reads[b, rng.integers(L // 2, L):] = ord("N")
    return reads


def jax_words(w) -> np.ndarray:
    return ju.to_numpy(w)


def port_words(w: torch.Tensor) -> np.ndarray:
    return w.numpy().astype(np.uint64)


def assert_windows_equal(jw, tw):
    v = np.asarray(jw.valid)
    np.testing.assert_array_equal(tw.valid.numpy(), v)
    assert tw.n_windows == jw.n_windows
    np.testing.assert_array_equal(port_words(tw.fw)[v], jax_words(jw.fw)[v])
    np.testing.assert_array_equal(port_words(tw.rc)[v], jax_words(jw.rc)[v])
    np.testing.assert_array_equal(
        port_words(tkmer.canonical_word(tw.fw, tw.rc))[v],
        jax_words(jkmer.canonical_word(jw.fw, jw.rc))[v])


@pytest.mark.parametrize("k", [1, 7, 15, 16, 17, 31])
def test_kmer_windows_match_jax(k):
    reads = make_reads(k, 6, 96)
    assert_windows_equal(jkmer.kmer_windows(jnp.asarray(reads), k),
                         tkmer.kmer_windows(torch.from_numpy(reads), k))


@pytest.mark.parametrize("k,L", [(1, 10), (7, 10), (10, 10), (3, 15)])
def test_kmer_windows_short_read(k, L):
    """Reads shorter than the 16-base pack stride."""
    reads = make_reads(100 + k, 4, L, pad=False)
    assert_windows_equal(jkmer.kmer_windows(jnp.asarray(reads), k),
                         tkmer.kmer_windows(torch.from_numpy(reads), k))


@pytest.mark.parametrize("k", [1, 7, 15, 16, 17, 31])
def test_kmer_windows_packed_match_jax(k):
    reads = make_reads(200 + k, 5, 128)
    words, vbits = pack_batch_np(reads)
    jw = jkmer.kmer_windows_packed(jnp.asarray(words), jnp.asarray(vbits), k)
    tw = tkmer.kmer_windows_packed(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(vbits.view(np.int32)), k)
    assert_windows_equal(jw, tw)


def test_packed_and_ascii_windows_agree():
    reads = make_reads(5, 4, 64)
    words, vbits = pack_batch_np(reads)
    a = tkmer.kmer_windows(torch.from_numpy(reads), 21)
    p = tkmer.kmer_windows_packed(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(vbits.view(np.int32)), 21)
    assert torch.equal(a.valid, p.valid)
    assert torch.equal(a.fw[a.valid], p.fw[p.valid])


def test_encoding_matches_jax():
    from kmers_tpu.ops import encoding as jenc

    allbytes = np.arange(256, dtype=np.uint8)
    t = torch.from_numpy(allbytes)
    v = np.asarray(jenc.valid_mask(jnp.asarray(allbytes)))
    np.testing.assert_array_equal(tenc.valid_mask(t).numpy(), v)
    np.testing.assert_array_equal(
        tenc.ascii_to_codes(t).numpy()[v],
        np.asarray(jenc.ascii_to_codes(jnp.asarray(allbytes)))[v])


@pytest.mark.parametrize("k", [1, 12, 16, 31])
def test_reverse_complement_matches_oracle(k):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 1 << (2 * k), 64, dtype=np.int64)
    got = tu.reverse_complement(torch.from_numpy(words), k).tolist()
    assert got == [oracle.reverse_complement_word(int(w), k) for w in words]


def test_planes_round_trip_keeps_bit_patterns():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 32, 100, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 100, dtype=np.uint64).astype(np.uint32)
    th = torch.from_numpy(hi.view(np.int32))
    tl = torch.from_numpy(lo.view(np.int32))
    w = tu.join_planes(th, tl)
    want = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    np.testing.assert_array_equal(w.numpy().view(np.uint64), want)
    h2, l2 = tu.split_word(w)
    assert torch.equal(h2, th) and torch.equal(l2, tl)
    # unsigned order: flagged (sign-bit) words sort after every valid word
    order = torch.sort(tu.to_unsigned_order(w)).indices.numpy()
    np.testing.assert_array_equal(want[order], np.sort(want))


@pytest.mark.parametrize("s", ["A", "acgtT", "GATTACA" * 4 + "CGT",
                               "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT",
                               "A" * 16 + "T" * 16, "G" * 32])
def test_canonical_from_string_matches_oracle(s):
    fw = oracle.word_from_bytes(s.upper().encode())
    want = min(fw, oracle.reverse_complement_word(fw, len(s)))
    assert tkmer.canonical_from_string(s) == want


def test_canonical_from_string_rejects_bad_input():
    with pytest.raises(ValueError):
        tkmer.canonical_from_string("ACNGT")
    with pytest.raises(ValueError):
        tkmer.canonical_from_string("A" * 33)
