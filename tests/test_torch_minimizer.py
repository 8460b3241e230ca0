"""The port's minimizers against the JAX package, on the CPU: the selection
orders (lex, mix32, mix16), sliding_argmin, minimizer_stream, and the
plain version of the minimizer kernel K9 against the Pallas kernel in
interpret mode and against kmers_tpu's minimizer_stream, for every order.
Valid lanes only: invalid lanes are unspecified in the JAX package (the
port zeroes them).  The CUDA kernel is held against this plain version on
the card by test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.kernels import minimizer as jkmin
from kmers_tpu.ops import hash as jhash
from kmers_tpu.ops import minimizer as jmin
from kmers_tpu_torch import kernels
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.kernels import minimizer as tkmin
from kmers_tpu_torch.ops import hash as thash
from kmers_tpu_torch.ops import minimizer as tmin

from test_torch_hash import as_u32, jax_u64, u64_words
from test_torch_kmer import make_reads

ORDERS = ["mix64", "mix32", "mix16", "lex"]
PAIRS = [(31, 11), (21, 7), (18, 4), (16, 5), (31, 31), (5, 3), (45, 13)]
SEED = 0xC0FFEE


def jax_order_fn(order, w, seed):
    return {"mix64": jhash.mix_hash_fn(seed),
            "mix32": jhash.mix32_hash_fn(seed),
            "mix16": jhash.mix16_hash_fn(seed),
            "lex": jhash.lex_hash_fn(w)}[order]


def reads_for(k, w, L=100):
    """Ns, lowercase and N-padded tails; L % 32 != 0."""
    return make_reads(k * 100 + w, 8, L, n_frac=0.01)


def port_words(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("seed", [0, 9, (1 << 36) + 5])
def test_orders_match_jax(seed):
    words = u64_words(np.random.default_rng(seed & 0xFF), 4096)
    t = torch.from_numpy(words.view(np.int64))
    j = jax_u64(words)
    np.testing.assert_array_equal(
        port_words(tu.mix32_order(t, seed)),
        ju.to_numpy(ju.mix32_order(j, seed)))
    np.testing.assert_array_equal(
        port_words(thash.mix32_hash_fn(seed)(t)),
        ju.to_numpy(jhash.mix32_hash_fn(seed)(j)))
    np.testing.assert_array_equal(
        port_words(thash.mix16_hash_fn(seed)(t)),
        ju.to_numpy(jhash.mix16_hash_fn(seed)(j)))


@pytest.mark.parametrize("w", [1, 7, 16, 17, 31, 32])
def test_lex_hash_matches_jax(w):
    words = u64_words(np.random.default_rng(w), 2048)
    if w < 32:
        words &= np.uint64((1 << (2 * w)) - 1)
    t = torch.from_numpy(words.view(np.int64))
    want = ju.to_numpy(jhash.lex_hash(jax_u64(words), w))
    np.testing.assert_array_equal(port_words(thash.lex_hash(t, w)), want)
    np.testing.assert_array_equal(port_words(thash.lex_hash_fn(w)(t)), want)


@pytest.mark.parametrize("window", [1, 2, 5, 21])
def test_sliding_argmin_matches_jax(window):
    """Unsigned 64-bit compare (top bits set), ties to the leftmost, every
    lane including the zero-padded tail."""
    rng = np.random.default_rng(window)
    h = rng.integers(0, 8, (4, 60), dtype=np.uint64) << np.uint64(61)
    h |= rng.integers(0, 3, (4, 60), dtype=np.uint64)
    want_h, want_off = jmin.sliding_argmin(jax_u64(h), window)
    got_h, got_off = tmin.sliding_argmin(torch.from_numpy(h.view(np.int64)),
                                         window)
    np.testing.assert_array_equal(port_words(got_h), ju.to_numpy(want_h))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))


@pytest.mark.parametrize("order", ORDERS)
def test_minimizer_stream_matches_jax(order):
    for k, w in PAIRS:
        reads = reads_for(k, w)
        want = jmin.minimizer_stream(jnp.asarray(reads), k, w,
                                     jax_order_fn(order, w, SEED))
        got = tmin.minimizer_stream(torch.from_numpy(reads), k, w,
                                    tkmin.order_fn(order, w, SEED))
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), v)
        assert got.n_kmers == want.n_kmers and v.any() and not v.all()
        np.testing.assert_array_equal(port_words(got.word)[v],
                                      ju.to_numpy(want.word)[v])
        np.testing.assert_array_equal(got.pos.numpy()[v],
                                      np.asarray(want.pos)[v])


def test_minimizer_stream_from_words_matches_jax():
    from kmers_tpu.ops.kmer import window_words as jww
    from kmers_tpu_torch.ops.kmer import window_words as tww

    codes = np.random.default_rng(4).integers(0, 4, (3, 90))
    k, w = 21, 7
    want = jmin.minimizer_stream_from_words(
        jww(jnp.asarray(codes, jnp.uint32), w), 90, k, w,
        jhash.mix_hash_fn(3))
    got = tmin.minimizer_stream_from_words(
        tww(torch.from_numpy(codes), w), 90, k, w, thash.mix_hash_fn(3))
    n = 90 - k + 1
    np.testing.assert_array_equal(port_words(got[0])[:, :n],
                                  ju.to_numpy(want[0])[:, :n])
    np.testing.assert_array_equal(got[1].numpy()[:, :n],
                                  np.asarray(want[1])[:, :n])


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("k,w", PAIRS)
def test_minimizer_kernel_plain_matches_pallas(order, k, w):
    """K9's plain version: the Pallas kernel (interpret mode) on valid
    lanes, with zeros on every invalid lane."""
    reads = reads_for(k, w)
    opts = dict(use_lex=True) if order == "lex" else dict(order=order)
    want = jkmin.minimizer_kernel(jnp.asarray(reads), k, w, seed=SEED,
                                  block_rows=8, interpret=True, **opts)
    got = tkmin.minimizer_kernel_plain(torch.from_numpy(reads), k, w, SEED,
                                       order)
    assert [g.dtype for g in got] == [torch.int32] * 3 + [torch.uint8]
    v = np.asarray(want[3]).astype(bool)
    np.testing.assert_array_equal(got[3].numpy().astype(bool), v)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(as_u32(g)[v], np.asarray(x)[v])
    np.testing.assert_array_equal(got[2].numpy()[v], np.asarray(want[2])[v])
    for g in got:
        assert (g.numpy()[~v] == 0).all()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("k,w", [(31, 11), (21, 17)])
def test_minimizer_kernel_hash_stage_plain_matches_pallas(order, k, w):
    """K9 at stage "hash" (no window scan): the forward w-mer word at p,
    int32(lo) ^ int32(hi) of its order and the k-window's validity, on
    valid lanes (JAX leaves the unmasked values on invalid lanes; the port
    zeroes them)."""
    reads = reads_for(k, w)
    opts = dict(use_lex=True) if order == "lex" else dict(order=order)
    want = jkmin.minimizer_kernel(jnp.asarray(reads), k, w, seed=SEED,
                                  block_rows=8, interpret=True, stage="hash",
                                  **opts)
    got = tkmin.minimizer_kernel_plain(torch.from_numpy(reads), k, w, SEED,
                                       order, "hash")
    assert [g.dtype for g in got] == [torch.int32] * 3 + [torch.uint8]
    v = np.asarray(want[3]).astype(bool)
    assert v.any() and not v.all()
    np.testing.assert_array_equal(got[3].numpy().astype(bool), v)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(as_u32(g)[v], np.asarray(x)[v])
    np.testing.assert_array_equal(got[2].numpy()[v], np.asarray(want[2])[v])
    for g in got:
        assert (g.numpy()[~v] == 0).all()


def test_minimizer_kernel_wrapper_takes_the_plain_version_on_cpu():
    r = torch.from_numpy(reads_for(21, 7, L=70))
    kernels.reset_launch_counts()
    for order in ORDERS:
        got = tkmin.minimizer_kernel(r, 21, 7, 5, order)
        want = tkmin.minimizer_kernel_plain(r, 21, 7, 5, order)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = tkmin.minimizer_kernel(r, 21, 7, 5, order, "hash")
        want = tkmin.minimizer_kernel_plain(r, 21, 7, 5, order, "hash")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launch_counts()["minimizer_kernel"] == 0
    assert kernels.launch_counts()["minimizer_kernel[hash]"] == 0


def test_minimizer_kernel_checks_its_inputs():
    r = torch.from_numpy(reads_for(21, 7, L=40))
    with pytest.raises(ValueError):
        tkmin.minimizer_kernel(r, 21, 7, order="mix8")
    with pytest.raises(ValueError):
        tkmin.minimizer_kernel(r, 21, 22)                 # w > k
    with pytest.raises(ValueError):
        tkmin.minimizer_kernel(r, 40, 33)                 # w > 32
    with pytest.raises(ValueError):
        tkmin.minimizer_kernel(r, 41, 11)                 # L < k
    with pytest.raises(TypeError):
        tkmin.minimizer_kernel(r.to(torch.int32), 21, 7)
    with pytest.raises(ValueError):
        tmin.minimizer_stream(r, 5, 7, thash.mix_hash_fn())


def test_minimizer_kernel_rejects_an_unknown_stage():
    r = torch.from_numpy(reads_for(21, 7, L=40))
    for call in (lambda: tkmin.minimizer_kernel(r, 21, 7, stage="pack"),
                 lambda: tkmin.minimizer_kernel_plain(r, 21, 7, 0, "mix64",
                                                      "canon")):
        with pytest.raises(ValueError, match="full.*hash"):
            call()


def test_minimizer_stream_matches_the_oracle():
    """The reference's deque (kmers_tpu.oracle.numpy_ref) on one read."""
    from kmers_tpu.oracle import numpy_ref as o

    read = b"ACGTTGCATTAGGCATCCAGTAGCATTTACGGACTAGGATCCATGCAACGT"
    k, w = 15, 5
    state = o.lex_hash_state(w)
    got = tmin.minimizer_stream(
        torch.frombuffer(bytearray(read), dtype=torch.uint8)[None], k, w,
        thash.lex_hash_fn(w))
    for i in range(len(read) - k + 1):
        fw = o.word_from_bytes(read[i:i + k])
        word, pos = o.minimizer_word(fw, k, w, state)
        assert (int(got.word[0, i]), int(got.pos[0, i])) == (word, i + pos)
