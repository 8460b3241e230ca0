"""The port's generic k-mer layer (ops.generic: Kmer<P, K, B> over widths
8-128, the 24 Naive permutations and Xor10) against the JAX package's, on
the CPU, bit for bit: all 25 encodings at one width and small k, and all
five widths at two encodings.  Lanes cross between the packages through
convert.lanes_from_numpy / lanes_to_numpy.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.ops import generic as jg
from kmers_tpu.oracle.numpy_ref import NAIVE_PERMS
from kmers_tpu_torch import convert
from kmers_tpu_torch.ops import generic as tg

ENCODINGS = sorted(NAIVE_PERMS) + ["xor10"]
WIDTHS = [8, 16, 32, 64, 128]


def reads(seed, shape):
    """Seeded ASCII with lowercase bases and the odd non-ACGT byte (the
    generic encoder takes any byte)."""
    rng = np.random.default_rng(seed)
    out = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)[
        rng.integers(0, 10, size=shape)]
    return out.copy()


def same_lanes(jlanes, tlanes):
    want = tuple(np.asarray(x) for x in jlanes)
    got = convert.lanes_to_numpy(tlanes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


def check_spec(jspec, tspec, seqs):
    """Every batched function of the layer on one spec, both packages."""
    js, ts = jnp.asarray(seqs), torch.from_numpy(seqs)
    for name in ("n_words", "total_bits", "total_bases", "n_lanes", "disc",
                 "comp_table"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    np.testing.assert_array_equal(tg.base_codes(tspec, ts).numpy(),
                                  np.asarray(jg.base_codes(jspec, js)))
    jl, tl = jg.encode(jspec, js), tg.encode(tspec, ts)
    same_lanes(jl, tl)
    same_lanes(jg.pack(jspec, jg.base_codes(jspec, js)),
               tg.pack(tspec, tg.base_codes(tspec, ts)))
    np.testing.assert_array_equal(tg.unpack_codes(tspec, tl).numpy(),
                                  np.asarray(jg.unpack_codes(jspec, jl)))
    dec = tg.decode(tspec, tl)
    assert dec.dtype == torch.uint8
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jg.decode(jspec, jl)))
    same_lanes(jg.rev_comp(jspec, jl), tg.rev_comp(tspec, tl))
    # lanes made by JAX, carried over, give JAX's reverse complement
    carried = convert.lanes_from_numpy(tuple(np.asarray(x) for x in jl), "cpu")
    same_lanes(jg.rev_comp(jspec, jl), tg.rev_comp(tspec, carried))
    return jl, tl


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_every_encoding_matches_jax(encoding):
    """u32 words at k = 21: two words, 11 padding slots."""
    check_spec(jg.GenericSpec(32, 21, encoding),
               tg.GenericSpec(32, 21, encoding), reads(21, (6, 21)))


def ks_for(width):
    per = width // 2
    return sorted({1, per, per + 1, 2 * per + 1} & set(range(1, 66)))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("encoding", ["ACGT", "xor10"])
def test_every_width_matches_jax(width, encoding):
    for k in ks_for(width):
        jspec, tspec = (jg.GenericSpec(width, k, encoding),
                        tg.GenericSpec(width, k, encoding))
        jl, tl = check_spec(jspec, tspec, reads(width + k, (5, k)))
        for i in sorted({0, k // 2, k - 1}):
            np.testing.assert_array_equal(tg.get(tspec, tl, i).numpy(),
                                          np.asarray(jg.get(jspec, jl, i)))
        for n in sorted({0, k // 2, k - 1}):
            same_lanes(jg.get_prefix(jspec, jl, n), tg.get_prefix(tspec, tl, n))
        jwords, twords = jg.lanes_to_words(jspec, jl), tg.lanes_to_words(tspec, tl)
        assert twords.dtype == object and twords.shape == jwords.shape
        assert twords.tolist() == jwords.tolist()
        same_lanes(jg.words_to_lanes(jspec, jwords),
                   tg.words_to_lanes(tspec, jwords, device="cpu"))
        same_lanes(jg.with_data(jspec, jwords),
                   tg.with_data(tspec, jwords, device="cpu"))
        same_lanes(jg.default(jspec, (2, 3)), tg.default(tspec, (2, 3), "cpu"))
        assert tg.k_of(tspec) == jg.k_of(jspec) == k
        assert tg.num_bytes(tspec) == jg.num_bytes(jspec)


@pytest.mark.parametrize("width,k,encoding", [
    (64, 31, "ACGT"), (128, 63, "GTCA"), (32, 15, "xor10"), (8, 3, "TGCA"),
    (16, 17, "ACTG")])
def test_encode_windows_matches_jax(width, k, encoding):
    """Every window of ragged-width rows at once, each base encoded once;
    the lanes past L - k (zero-padded garbage) match too."""
    jspec, tspec = (jg.GenericSpec(width, k, encoding),
                    tg.GenericSpec(width, k, encoding))
    seqs = reads(k + width, (3, 70))
    jl, jv = jg.encode_windows(jspec, jnp.asarray(seqs))
    tl, tv = tg.encode_windows(tspec, torch.from_numpy(seqs))
    same_lanes(jl, tl)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # and at valid positions, the per-window encode
    p = 70 - k
    one = tg.encode(tspec, torch.from_numpy(seqs[:, p:p + k]))
    for x, y in zip(one, tl):
        assert torch.equal(x, y[:, p])


def test_default_makes_tensors_on_the_card_unless_told():
    spec = tg.GenericSpec(64, 31, "ACGT")
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises((RuntimeError, AssertionError)):
        tg.default(spec, (2,))


def test_spec_rejects_what_jax_rejects():
    for args in ((12, 5, "ACGT"), (32, 5, "ACGU"), (32, 0, "ACGT")):
        with pytest.raises(ValueError):
            jg.GenericSpec(*args)
        with pytest.raises(ValueError):
            tg.GenericSpec(*args)
    with pytest.raises(ValueError):
        tg.words_to_lanes(tg.GenericSpec(8, 9, "ACGT"), [[1, 2]], device="cpu")
    with pytest.raises(TypeError):
        convert.lanes_from_numpy((np.zeros(3, dtype=np.int64),), "cpu")
