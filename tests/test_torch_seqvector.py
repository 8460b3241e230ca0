"""The port's SeqVector (ops.seqvector) against the JAX package's, on the
CPU, bit for bit: packing, the 3-word funnel reads (also past the stored
words, where JAX's gather fills 0xFFFFFFFF), k = 32 words with bit 63 set,
minimizers under each hash paired with JAX's of the same name and seed,
push_chars, slices and iterators, and the npz and simple_sds files across
the packages both ways.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.ops import hash as jhash
from kmers_tpu.ops import seqvector as jsv
from kmers_tpu.oracle import numpy_ref as oracle
from kmers_tpu_torch import convert
from kmers_tpu_torch.ops import hash as thash
from kmers_tpu_torch.ops import seqvector as tsv
from kmers_tpu_torch.ops.minimizer import MappedMinimizer
from kmers_tpu_torch.parallel.stream import npz_digest


def seq(seed, n, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return bytes(np.frombuffer(alphabet, dtype=np.uint8)[
        rng.integers(0, len(alphabet), size=n)])


def pair(data: bytes):
    return jsv.SeqVector.from_bytes(data), tsv.SeqVector.from_bytes(
        data, device="cpu")


def jwords(sv) -> np.ndarray:
    return np.asarray(sv.words, dtype=np.uint32)


def twords(sv) -> np.ndarray:
    words, n = convert.seqvector_to_numpy(sv)
    assert words.dtype == np.uint32 and n == sv.n_bases
    return words


def same_u64(j, t: torch.Tensor):
    np.testing.assert_array_equal(t.numpy().view(np.uint64), ju.to_numpy(j))


def test_pack_and_unpack_match_jax():
    data = np.frombuffer(seq(1, 1000, b"ACGTacgtNRY"), dtype=np.uint8)
    for n in (0, 1, 15, 16, 17, 1000):
        w = tsv.pack_ascii_to_words(data[:n])
        np.testing.assert_array_equal(w, jsv.pack_ascii_to_words(data[:n]))
        assert w.dtype == np.uint32
    words = jsv.pack_ascii_to_words(data)
    got = tsv.unpack_words_to_codes(torch.from_numpy(words.astype(np.int64)),
                                    999)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsv.unpack_words_to_codes(jnp.asarray(words),
                                                          999)))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32])
def test_gather_without_spare_words_matches_jax(k):
    """Bare words (no spare words): every position up to past the end,
    and a negative one, read as JAX's jnp.take reads them."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 1 << 32, size=9, dtype=np.uint64).astype(np.uint32)
    pos = np.concatenate([np.arange(0, 9 * 16 + 40, dtype=np.int32),
                          np.array([-1, -17], dtype=np.int32)])
    want = jsv.gather_kmers(jnp.asarray(words), jnp.asarray(pos), k)
    got = tsv.gather_kmers(torch.from_numpy(words.astype(np.int64)),
                           torch.from_numpy(pos), k)
    same_u64(want, got)
    if k == 32:
        assert (got < 0).any()             # bit 63 set in some words


def test_kmer_reads_match_jax_and_the_oracle():
    data = seq(2, 777)
    j, t = pair(data)
    assert len(t) == len(j) == 777 and not t.is_empty()
    np.testing.assert_array_equal(twords(t), jwords(j))
    assert t.to_string() == j.to_string() == str(t) == data.decode()
    np.testing.assert_array_equal(
        twords(tsv.SeqVector.from_str(data.decode(), device="cpu")),
        jwords(jsv.SeqVector.from_str(data.decode())))
    o = oracle.SeqVector.from_bytes(data)
    for k in (1, 9, 16, 31, 32):
        jw, jn = j.all_kmers(k)
        tw, tn = t.all_kmers(k)
        assert tn == jn
        same_u64(jw, tw)
        assert list(t.iter_kmers(k)) == list(j.iter_kmers(k))
        for pos in (0, 5, 776 - k, 776):
            assert t.get_kmer_u64(pos, k) == j.get_kmer_u64(pos, k)
        assert t.get_kmer_u64(3, k) == o.get_kmer_u64(3, k)
    assert [t.get_base(i) for i in range(40)] == [j.get_base(i)
                                                  for i in range(40)]


def test_k32_words_with_bit_63_are_unsigned_ints():
    data = b"T" * 40 + seq(3, 60)
    j, t = pair(data)
    top = t.get_kmer_u64(0, 32)
    assert top == j.get_kmer_u64(0, 32) == (1 << 64) - 1
    it = list(tsv.SeqVecKmerIterator(t, 32))
    assert it == list(jsv.SeqVecKmerIterator(j, 32))
    assert all(0 <= w < 1 << 64 for w, _ in it) and it[0][0] == top


def test_bare_words_read_past_the_end_as_jax():
    """SeqVector(words, n) over words with no spare words (and a load of
    such a file): reads at the end match JAX's filled words."""
    words = jsv.pack_ascii_to_words(np.frombuffer(seq(4, 64), dtype=np.uint8))
    j = jsv.SeqVector(jnp.asarray(words), 64)
    t = convert.seqvector_from_numpy(words, 64, "cpu")
    for k in (1, 20, 32):
        for pos in (32, 50, 63):
            assert t.get_kmer_u64(pos, k) == j.get_kmer_u64(pos, k)
        same_u64(j.all_kmers(k)[0], t.all_kmers(k)[0])
    assert t.get_kmer_u64(63, 32) >> 2 == (1 << 62) - 1   # the fill's ones


# (name, hash of a module and w, (k, w) pairs); each pair costs JAX a compile
HASHES = [("mix", lambda m, w: m.mix_hash_fn(7), ((31, 11), (32, 32))),
          ("lex", lambda m, w: m.lex_hash_fn(w), ((31, 11), (15, 1))),
          ("mix32", lambda m, w: m.mix32_hash_fn(0), ((31, 11),)),
          ("mix16", lambda m, w: m.mix16_hash_fn(0), ((31, 11), (21, 21)))]


@pytest.mark.parametrize("name,make,pairs", HASHES, ids=[h[0] for h in HASHES])
def test_minimizers_match_jax(name, make, pairs):
    data = seq(5, 300) + b"A" * 40        # a run: ties everywhere
    j, t = pair(data)
    for k, w in pairs:
        jword, jpos = j.minimizers(k, w, make(jhash, w))
        tword, tpos = t.minimizers(k, w, make(thash, w))
        same_u64(jword, tword)
        assert tpos.dtype == torch.int32
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        # JAX's iterators are these arrays as Python ints
        want = [(int(a), int(b)) for a, b in zip(ju.to_numpy(jword),
                                                 np.asarray(jpos))]
        assert list(t.iter_minimizers(k, w, make(thash, w))) == want
        it = tsv.SeqVecMinimizerIter(t, k, w, make(thash, w))
        mins = list(it)
        assert len(it) == len(mins) == 340 - k + 1
        assert all(type(m) is MappedMinimizer for m in mins)
        assert mins == want
    assert list(t.iter_minimizers(31, 11, make(thash, 11))) == [
        tuple(m) for m in jsv.SeqVecMinimizerIter(j, 31, 11, make(jhash, 11))]
    want = list(oracle.SeqVector.from_bytes(data).iter_minimizers(
        31, 11, oracle.lex_hash_state(11)))
    assert list(t.iter_minimizers(31, 11, thash.lex_hash_fn(11))) == want


@pytest.mark.parametrize("initial,appends", [
    (b"", [b"ACGT", b"", b"G" * 13, seq(6, 50)]),
    (seq(7, 16), [seq(8, 16), seq(9, 1), seq(10, 31)]),
    (seq(11, 5), [seq(12, 100), seq(13, 7), seq(14, 16), seq(15, 33)])])
def test_push_chars_matches_jax_word_for_word(initial, appends):
    j, t = pair(initial)
    tc = tsv.SeqVector.with_capacity(500, device="cpu")
    jc = jsv.SeqVector.with_capacity(500)
    tc.push_chars(initial)
    jc.push_chars(initial)
    for data in appends:
        for sv in (j, t, jc, tc):
            sv.push_chars(data)
        np.testing.assert_array_equal(twords(t), jwords(j))
        np.testing.assert_array_equal(twords(tc), jwords(jc))
    assert t.to_string() == (initial + b"".join(appends)).decode()
    assert tsv.SeqVector.with_capacity(9, device="cpu").is_empty()


def test_slices_match_jax():
    data = seq(16, 400)
    j, t = pair(data)
    js, ts = j.slice(37, 350), t.slice(37, 350)
    assert len(ts) == len(js) == 313 and not ts.is_empty()
    assert ts.to_string() == js.to_string() == str(ts) == data[37:350].decode()
    pos = np.arange(0, 313 - 31 + 1, dtype=np.int32)
    same_u64(js.get_kmers(jnp.asarray(pos), 31),
             ts.get_kmers(torch.from_numpy(pos), 31))
    assert list(ts.iter_kmers(17)) == list(js.iter_kmers(17))
    for k, p in ((32, 0), (5, 100), (1, 312)):
        assert ts.get_kmer_u64(p, k) == js.get_kmer_u64(p, k)
    assert ts.get_base(7) == js.get_base(7)
    j2, t2 = js.slice(10, 200), ts.slice(10, 200)
    assert (t2.start_pos, len(t2)) == (j2.start_pos, len(j2)) == (47, 190)
    assert list(t2.iter_kmers(9)) == list(j2.iter_kmers(9))
    whole = t.as_slice()
    assert (whole.start_pos, len(whole)) == (0, 400)
    assert t.slice(5, 5).is_empty()
    with pytest.raises(ValueError):
        t.slice(10, 401)
    with pytest.raises(IndexError):
        ts.get_kmer_u64(300, 31)


def test_npz_files_cross_packages_both_ways(tmp_path):
    data = seq(17, 1001)
    j, t = pair(data)
    j.push_chars(seq(18, 7))
    t.push_chars(seq(18, 7))
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j.save(jp)
    t.save(tp)
    assert npz_digest(tp) == npz_digest(jp)
    t_from_j = tsv.SeqVector.load(jp, device="cpu")
    j_from_t = jsv.SeqVector.load(tp)
    np.testing.assert_array_equal(twords(t_from_j), jwords(j))
    np.testing.assert_array_equal(jwords(j_from_t), twords(t))
    assert t_from_j.n_bases == j_from_t.n_bases == 1008
    # a file of bare words (no spare words) loads and reads as in JAX
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, words=jsv.pack_ascii_to_words(
        np.frombuffer(data[:32], dtype=np.uint8)).astype("<u4"),
        n_bases=np.int64(32))
    tb, jb = tsv.SeqVector.load(bare[:-4], device="cpu"), jsv.SeqVector.load(bare)
    same_u64(jb.all_kmers(32)[0], tb.all_kmers(32)[0])
    assert tb.get_kmer_u64(31, 32) == jb.get_kmer_u64(31, 32)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 257])
def test_simple_sds_bytes_cross_packages_both_ways(n, tmp_path):
    data = seq(19 + n, n)
    j, t = pair(data)
    blob = t.to_simple_sds()
    assert blob == j.to_simple_sds() == oracle.SeqVector.from_bytes(
        data).to_simple_sds()
    t_from_j = tsv.SeqVector.from_simple_sds(j.to_simple_sds(), device="cpu")
    j_from_t = jsv.SeqVector.from_simple_sds(blob)
    np.testing.assert_array_equal(twords(t_from_j), jwords(j_from_t))
    assert t_from_j.to_string() == data.decode()
    path = str(tmp_path / "sv.sds")
    t.save_simple_sds(path)
    assert open(path, "rb").read() == blob
    assert tsv.SeqVector.load_simple_sds(path, device="cpu").to_string() == \
        data.decode()
    iv = np.array([n, 2], dtype="<u8").tobytes() + blob
    t_iv = tsv.SeqVector.from_simple_sds_int_vector(iv, device="cpu")
    np.testing.assert_array_equal(
        twords(t_iv), jwords(jsv.SeqVector.from_simple_sds_int_vector(iv)))


def test_simple_sds_errors_match_jax():
    blob = jsv.SeqVector.from_bytes(seq(20, 40)).to_simple_sds()
    head = np.frombuffer(blob[:16], dtype="<u8")
    bad = {
        "odd": np.array([81, 2], dtype="<u8").tobytes() + blob[16:],
        "count": np.array([head[0], 3], dtype="<u8").tobytes() + blob[16:],
        "truncated": blob[:-8],
    }
    for name, data in bad.items():
        with pytest.raises(ValueError) as jerr:
            jsv.SeqVector.from_simple_sds(data)
        with pytest.raises(ValueError) as terr:
            tsv.SeqVector.from_simple_sds(data, device="cpu")
        assert str(terr.value) == str(jerr.value), name
    for iv in (np.array([40, 3], dtype="<u8").tobytes() + blob,
               np.array([41, 2], dtype="<u8").tobytes() + blob):
        with pytest.raises(ValueError) as jerr:
            jsv.SeqVector.from_simple_sds_int_vector(iv)
        with pytest.raises(ValueError) as terr:
            tsv.SeqVector.from_simple_sds_int_vector(iv, device="cpu")
        assert str(terr.value) == str(jerr.value)


def test_convert_round_trips_jax_state():
    j = jsv.SeqVector.from_bytes(seq(21, 100))
    t = convert.seqvector_from_numpy(jwords(j), j.n_bases, "cpu")
    words, n = convert.seqvector_to_numpy(t)
    np.testing.assert_array_equal(words, jwords(j))
    assert n == 100 and t.to_string() == j.to_string()
    with pytest.raises(TypeError):
        convert.seqvector_from_numpy(words.astype(np.int64), 100, "cpu")


def test_positions_stop_where_jax_int32_positions_stop():
    t = tsv.SeqVector(torch.zeros(4, dtype=torch.int64), tsv.MAX_BASES + 40)
    with pytest.raises(ValueError):
        t.all_kmers(31)
    with pytest.raises(ValueError):
        t.minimizers(31, 11, thash.mix_hash_fn())


def test_factories_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    for make in (lambda: tsv.SeqVector.from_bytes(b"ACGT"),
                 lambda: tsv.SeqVector.with_capacity(4)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
