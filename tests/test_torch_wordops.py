"""The port's encodings, 128-bit lex hash, k-mer word operations and
wideint lanes against the JAX package's, on the CPU, bit for bit (the
tolerance is exact equality).

Inputs are seeded numpy arrays; words go to JAX as uint32 (hi, lo) pairs
and to the port as int64 of the same bits, and come back as uint64.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.core import u128 as ju128
from kmers_tpu.core import wideint as jwi
from kmers_tpu.ops import encoding as jenc
from kmers_tpu.ops import hash as jhash
from kmers_tpu.ops import kmer as jkmer
from kmers_tpu.oracle.numpy_ref import NAIVE_PERMS
from kmers_tpu_torch.core import u128 as tu128
from kmers_tpu_torch.core import wideint as twi
from kmers_tpu_torch.ops import encoding as tenc
from kmers_tpu_torch.ops import hash as thash
from kmers_tpu_torch.ops import kmer as tkmer

ALL_BYTES = np.arange(256, dtype=np.uint8)


def words(seed, n, k=32):
    """n random words of 2k bits (the full 64 at k = 32), as uint64."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) << np.uint64(1)
    w |= rng.integers(0, 2, size=n, dtype=np.uint64)
    return w if k == 32 else w & np.uint64((1 << (2 * k)) - 1)


def jw(a: np.ndarray):
    return ju.from_numpy(a)


def tw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int64).copy())


def back(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def same(j, t):
    """A JAX result (U64 or array) equals a port tensor, value for value."""
    want = ju.to_numpy(j) if isinstance(j, ju.U64) else np.asarray(j)
    got = back(t) if isinstance(j, ju.U64) else t.numpy()
    np.testing.assert_array_equal(got.astype(want.dtype), want)


# -- 1. encodings ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["ascii_to_internal", "ascii_to_codes",
                                  "valid_mask"])
def test_ascii_codecs_match_jax_on_every_byte(name):
    same(getattr(jenc, name)(jnp.asarray(ALL_BYTES)),
         getattr(tenc, name)(torch.from_numpy(ALL_BYTES)))


@pytest.mark.parametrize("name", ["internal_to_acgt", "acgt_to_internal"])
def test_code_order_involutions_match_jax(name):
    vals = np.concatenate([np.arange(4, dtype=np.uint32), np.random.default_rng(
        1).integers(0, 1 << 32, size=64, dtype=np.uint64).astype(np.uint32)])
    same(getattr(jenc, name)(jnp.asarray(vals)),
         getattr(tenc, name)(torch.from_numpy(vals.astype(np.int64))))
    if name == "internal_to_acgt":
        four = torch.arange(4)
        assert torch.equal(tenc.acgt_to_internal(tenc.internal_to_acgt(four)),
                           four)


@pytest.mark.parametrize("lower", [True, False])
def test_codes_to_ascii_matches_jax(lower):
    codes = np.random.default_rng(2).integers(0, 1 << 20, size=200,
                                              dtype=np.int64)
    got = tenc.codes_to_ascii(torch.from_numpy(codes), lower=lower)
    assert got.dtype == torch.uint8
    same(jenc.codes_to_ascii(jnp.asarray(codes.astype(np.uint32)), lower=lower),
         got)
    assert bytes(tenc.codes_to_ascii(torch.arange(4)).numpy()) == b"acgt"


@pytest.mark.parametrize("perm", sorted(NAIVE_PERMS))
def test_permutation_encodings_match_jax(perm):
    disc = NAIVE_PERMS[perm]
    assert tenc.rev_encoding(disc) == jenc.rev_encoding(disc)
    same(jenc.perm_encode(jnp.asarray(ALL_BYTES), disc),
         tenc.perm_encode(torch.from_numpy(ALL_BYTES), disc))
    codes = np.arange(16, dtype=np.uint32)          # bits past 2 ignored
    tcodes = torch.from_numpy(codes.astype(np.int64))
    decoded = tenc.perm_decode(tcodes, disc)
    assert decoded.dtype == torch.uint8
    same(jenc.perm_decode(jnp.asarray(codes), disc), decoded)
    same(jenc.perm_complement(jnp.asarray(codes), disc),
         tenc.perm_complement(tcodes, disc))
    # the permutation names its codes: perm[c] is the base of code c
    acgt = torch.from_numpy(np.frombuffer(bytearray(perm.encode()), dtype=np.uint8))
    assert tenc.perm_encode(acgt, disc).tolist() == [0, 1, 2, 3]


# -- 2. the 128-bit lex hash ----------------------------------------------------

@pytest.mark.parametrize("k", [1, 31, 32, 33, 63, 64])
def test_u128_lex_hash_matches_jax(k):
    hi, lo = words(10 + k, 50, max(1, k - 32) if k > 32 else 32), words(20 + k, 50)
    if k <= 32:
        hi = np.zeros_like(hi)
        lo = lo & np.uint64((1 << (2 * k)) - 1) if k < 32 else lo
    want = ju128.lex_hash(ju128.U128(jw(hi), jw(lo)), k)
    got = tu128.lex_hash(tw(hi), tw(lo), k)
    same(want.hi, got[0])
    same(want.lo, got[1])


def test_u128_lex_hash_rejects_k_out_of_range():
    z = torch.zeros(1, dtype=torch.int64)
    for k in (0, 65):
        with pytest.raises(ValueError):
            tu128.lex_hash(z, z, k)


# -- 3. k-mer word operations ------------------------------------------------------

KS = [1, 5, 16, 17, 31, 32]


def palindromes(k, n=4):
    """Words equal to their own reverse complement (even k)."""
    if k % 2:
        return np.zeros(0, dtype=np.uint64)
    half = words(99 + k, n, k // 2)
    rc = np.array([int(x) for x in ju.to_numpy(
        ju.reverse_complement(jw(half), k // 2))], dtype=np.uint64)
    return half | (rc << np.uint64(k))


@pytest.mark.parametrize("k", KS)
def test_reverse_complement_and_canonical_predicates_match_jax(k):
    fw = np.concatenate([words(k, 64, k), palindromes(k)])
    jfw, tfw = jw(fw), tw(fw)
    jrc, trc = jkmer.reverse_complement(jfw, k), tkmer.reverse_complement(tfw, k)
    same(jrc, trc)
    same(jkmer.is_fw_canonical(jfw, jrc), tkmer.is_fw_canonical(tfw, trc))
    same(jkmer.is_canonical(jfw, k), tkmer.is_canonical(tfw, k))
    same(jkmer.canonical_word(jfw, jrc), tkmer.canonical_word(tfw, trc))
    if k % 2 == 0:       # palindromes: canonical, but fw is not < rc
        pal = slice(64, None)
        assert tkmer.is_canonical(tfw[pal], k).all()
        assert not tkmer.is_fw_canonical(tfw[pal], trc[pal]).any()


@pytest.mark.parametrize("k", KS)
def test_rolling_base_updates_match_jax(k):
    fw = words(30 + k, 64, k)
    rc = ju.to_numpy(ju.reverse_complement(jw(fw), k))
    b = np.random.default_rng(k).integers(0, 4, size=64).astype(np.uint32)
    jb, tb = jnp.asarray(b), torch.from_numpy(b.astype(np.int64))
    for name in ("append_base", "prepend_base"):
        jnew, jev = getattr(jkmer, name)(jw(fw), jb, k)
        tnew, tev = getattr(tkmer, name)(tw(fw), tb, k)
        same(jnew, tnew)
        same(jev, tev)
    for name in ("ck_append_base", "ck_prepend_base"):
        jf, jr, jev = getattr(jkmer, name)(jw(fw), jw(rc), jb, k)
        tf, tr, tev = getattr(tkmer, name)(tw(fw), tw(rc), tb, k)
        same(jf, tf)
        same(jr, tr)
        same(jev, tev)
    if k == 32:          # MASK_TABLE[32] == 0: a prepend zeroes the word
        assert not tkmer.prepend_base(tw(fw), tb, 32)[0].any()


@pytest.mark.parametrize("k,pos,width", [(31, 0, 31), (31, 5, 11), (32, 0, 32),
                                         (32, 31, 1), (20, 3, 16), (9, 8, 1)])
def test_sub_kmer_word_matches_jax(k, pos, width):
    w = words(k + pos, 40, k)
    same(jkmer.sub_kmer_word(jw(w), k, pos, width),
         tkmer.sub_kmer_word(tw(w), k, pos, width))


def test_sub_kmer_word_rejects_a_window_past_k():
    with pytest.raises(ValueError):
        tkmer.sub_kmer_word(torch.zeros(1, dtype=torch.int64), 10, 5, 6)


def test_match_type_matches_jax_identity_first():
    k = 12
    fw = np.concatenate([words(5, 30, k), palindromes(k)])
    rc = ju.to_numpy(ju.reverse_complement(jw(fw), k))
    other = np.where(np.arange(len(fw)) % 3 == 0, fw,
                     np.where(np.arange(len(fw)) % 3 == 1, rc, words(6, len(fw), k)))
    other[30:] = rc[30:]               # a palindrome's rc is itself
    got = tkmer.match_type(tw(fw), tw(rc), tw(other))
    assert got.dtype == torch.int32
    same(jkmer.match_type(jw(fw), jw(rc), jw(other)), got)
    assert set(got.tolist()) == {0, 1, 2}
    assert (got[30:] == 1).all()       # palindromes: identity wins


@pytest.mark.parametrize("k,width", [(31, 11), (32, 7), (15, 15), (21, 1)])
@pytest.mark.parametrize("order", ["mix", "lex", "mix32", "mix16"])
def test_brute_force_minimizer_matches_jax(k, width, order):
    fns = {"mix": (jhash.mix_hash_fn(3), thash.mix_hash_fn(3)),
           "lex": (jhash.lex_hash_fn(width), thash.lex_hash_fn(width)),
           "mix32": (jhash.mix32_hash_fn(0), thash.mix32_hash_fn(0)),
           "mix16": (jhash.mix16_hash_fn(0), thash.mix16_hash_fn(0))}[order]
    w = words(k * width, 128, k)
    w[:8] = 0                          # every sub-k-mer ties: offset 0
    jm, jpos = jkmer.minimizer(jw(w), k, width, fns[0])
    tm, tpos = tkmer.minimizer(tw(w), k, width, fns[1])
    same(jm, tm)
    assert tpos.dtype == torch.int32
    same(jpos, tpos)
    assert not tpos[:8].any()


@pytest.mark.parametrize("k", [33, 47, 63, 64])
def test_wide_rolling_updates_match_jax(k):
    hi, lo = words(40 + k, 64, k - 32), words(50 + k, 64)
    b = np.random.default_rng(k).integers(0, 4, size=64).astype(np.uint32)
    jb, tb = jnp.asarray(b), torch.from_numpy(b.astype(np.int64))
    for name in ("append_base_wide", "prepend_base_wide"):
        (jnew, jev) = getattr(jkmer, name)(ju128.U128(jw(hi), jw(lo)), jb, k)
        (thi, tlo), tev = getattr(tkmer, name)((tw(hi), tw(lo)), tb, k)
        same(jnew.hi, thi)
        same(jnew.lo, tlo)
        same(jev, tev)
    with pytest.raises(ValueError):
        tkmer.append_base_wide((tw(hi), tw(lo)), tb, 32)


# -- 4. wideint lanes ------------------------------------------------------------

def lanes(seed, nl, n=48):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(nl)]


def jl(a):
    return tuple(jnp.asarray(x) for x in a)


def tl(a):
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in a)


def same_lanes(j, t):
    assert len(j) == len(t)
    for x, y in zip(j, t):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("nl", [1, 2, 3, 4])
def test_wideint_shifts_match_jax(nl):
    a = lanes(nl, nl)
    for n in sorted({0, 1, 2, 30, 31, 32, 33, 62, 64, 65, 32 * nl - 2,
                     32 * nl, 32 * nl + 3}):
        same_lanes(jwi.shl(jl(a), n), twi.shl(tl(a), n))
        same_lanes(jwi.shr(jl(a), n), twi.shr(tl(a), n))


@pytest.mark.parametrize("nl", [1, 2, 4])
def test_wideint_compares_and_bitwise_match_jax(nl):
    a, b = lanes(10 + nl, nl), lanes(20 + nl, nl)
    for x in b[:-1]:
        x[::3] = 0
    b[-1][::2] = a[-1][::2]            # ties in the top lane decide below
    for i in range(nl):
        b[i][::5] = a[i][::5]          # whole-word ties
    ja, jb, ta, tb = jl(a), jl(b), tl(a), tl(b)
    for name in ("eq", "lt"):
        np.testing.assert_array_equal(getattr(twi, name)(ta, tb).numpy(),
                                      np.asarray(getattr(jwi, name)(ja, jb)))
    for name in ("min_", "and_", "or_", "xor"):
        same_lanes(getattr(jwi, name)(ja, jb), getattr(twi, name)(ta, tb))
    same_lanes(jwi.not_(ja), twi.not_(ta))
    c = 0x0123456789ABCDEF_FEDCBA9876543210_5555AAAA
    same_lanes(jwi.and_const(ja, c), twi.and_const(ta, c))
    same_lanes(jwi.xor_const(ja, c), twi.xor_const(ta, c))
    same_lanes(jwi.zeros_like(ja), twi.zeros_like(ta))


@pytest.mark.parametrize("nl", [1, 2, 3, 4])
def test_wideint_base_ops_match_jax(nl):
    a = lanes(30 + nl, nl)
    same_lanes(jwi.reverse_bases(jl(a)), twi.reverse_bases(tl(a)))
    for k in sorted({1, 7, 16, 16 * nl - 1, 16 * nl}):
        same_lanes(jwi.reverse_bases_k(jl(a), k), twi.reverse_bases_k(tl(a), k))
    rng = np.random.default_rng(nl)
    for _ in range(6):
        table = [int(t) for t in rng.integers(0, 4, size=4)]
        same_lanes(jwi.map2bit(jl(a), table), twi.map2bit(tl(a), table))


def test_wideint_scalars_and_python_ints_match_jax():
    vals = [0, 1, (1 << 127) + 12345, (1 << 96) - 1, 0xDEADBEEF << 40]
    for nl in (1, 3, 4):
        assert twi.n_lanes(32 * nl) == jwi.n_lanes(32 * nl) == nl
        t = twi.from_python_ints(vals, nl, device="cpu")
        same_lanes(jwi.from_python_ints(vals, nl), t)
        assert twi.to_python_ints(t) == jwi.to_python_ints(
            jwi.from_python_ints(vals, nl))
        same_lanes(jwi.from_scalar(vals[2], nl, (2, 3)),
                   twi.from_scalar(vals[2], nl, (2, 3), device="cpu"))
    assert twi.n_lanes(8) == jwi.n_lanes(8) == 1
