"""The count forms end to end against the JAX package on the CPU: the
per-batch pipelines with their defaults (compact tables) and every
aggregate, and k = 32 and k = 64 (keys that fill every bit, counted
through the run-length tables) in the word helpers, the windows, lookup
of the bit-63 palindrome A^16 T^16, count_fastx and the StreamingCounter
with eviction and resume across the two packages (the CLI is in
test_torch_fullword_cli.py).  Exact equality."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.core import u128 as ju128
from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.ops import kmer as jkmer
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu.parallel.stream import StreamingCounter as JaxCounter
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.core import u128 as tu128
from kmers_tpu_torch.ops import kmer as tkmer
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel.stream import StreamingCounter, npz_digest

from test_torch_count_forms import assert_same_table
from test_torch_kmer import make_reads
from test_torch_stream import batches, feed, saved_digest

PALINDROME_32 = "A" * 16 + "T" * 16       # its own reverse complement


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32))


def words_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# -- the word helpers at full width ------------------------------------------------

def test_u64_helpers_at_k32():
    """reverse_complement, unsigned_min and canonical_word at k = 32,
    where words use bit 63."""
    rng = np.random.default_rng(32)
    w = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    w[:3] = [0, (1 << 64) - 1, 1 << 63]
    tw = torch.from_numpy(w.view(np.int64))
    rc = tu.reverse_complement(tw, 32)
    jw = ju.from_numpy(w)
    np.testing.assert_array_equal(words_of(rc), ju.to_numpy(
        ju.reverse_complement(jw, 32)))
    np.testing.assert_array_equal(
        words_of(tkmer.canonical_word(tw, rc)),
        ju.to_numpy(jkmer.canonical_word(jw, ju.reverse_complement(jw, 32))))
    np.testing.assert_array_equal(words_of(tu.unsigned_min(tw, rc)),
                                  np.minimum(w, words_of(rc)))
    assert tu.to_ints(tu.from_ints([0, 1 << 63, (1 << 64) - 1])) == [
        0, 1 << 63, (1 << 64) - 1]


def test_u128_helpers_at_k64():
    """reverse_complement and canonical_word_wide at k = 64 (shift 0, bit
    127 in use)."""
    rng = np.random.default_rng(64)
    hi = rng.integers(0, 1 << 64, 2048, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, 2048, dtype=np.uint64)
    t = (torch.from_numpy(hi.view(np.int64)), torch.from_numpy(lo.view(np.int64)))
    j = ju128.U128(ju.from_numpy(hi), ju.from_numpy(lo))
    rc, jrc = tu128.reverse_complement(*t, 64), ju128.reverse_complement(j, 64)
    np.testing.assert_array_equal(words_of(rc[0]), ju.to_numpy(jrc.hi))
    np.testing.assert_array_equal(words_of(rc[1]), ju.to_numpy(jrc.lo))
    c, jc = tkmer.canonical_word_wide(t, rc), jkmer.canonical_word_wide(j, jrc)
    np.testing.assert_array_equal(words_of(c[0]), ju.to_numpy(jc.hi))
    np.testing.assert_array_equal(words_of(c[1]), ju.to_numpy(jc.lo))


@pytest.mark.parametrize("k", [32, 64])
def test_windows_at_full_width_match_jax(k):
    """kmer_windows(_packed) at k = 32 and their wide forms at k = 64, on
    the valid lanes (invalid lanes carry garbage in both packages)."""
    reads = make_reads(k, 6, 128)
    words, vbits = pack_batch_np(reads)
    if k == 32:
        pairs = [(jkmer.kmer_windows(jnp.asarray(reads), k),
                  tkmer.kmer_windows(torch.from_numpy(reads), k)),
                 (jkmer.kmer_windows_packed(jnp.asarray(words),
                                            jnp.asarray(vbits), k),
                  tkmer.kmer_windows_packed(t32(words), t32(vbits), k))]
        for jw, tw in pairs:
            v = np.asarray(jw.valid)
            np.testing.assert_array_equal(tw.valid.numpy(), v)
            np.testing.assert_array_equal(
                words_of(tkmer.canonical_word(tw.fw, tw.rc))[v],
                ju.to_numpy(jkmer.canonical_word(jw.fw, jw.rc))[v])
        return
    pairs = [(jkmer.kmer_windows_wide(jnp.asarray(reads), k),
              tkmer.kmer_windows_wide(torch.from_numpy(reads), k)),
             (jkmer.kmer_windows_packed_wide(jnp.asarray(words),
                                             jnp.asarray(vbits), k),
              tkmer.kmer_windows_packed_wide(t32(words), t32(vbits), k))]
    for jw, tw in pairs:
        v = np.asarray(jw.valid)
        np.testing.assert_array_equal(tw.valid.numpy(), v)
        c = tkmer.canonical_word_wide(tw.fw, tw.rc)
        jc = jkmer.canonical_word_wide(jw.fw, jw.rc)
        np.testing.assert_array_equal(words_of(c[0])[v], ju.to_numpy(jc.hi)[v])
        np.testing.assert_array_equal(words_of(c[1])[v], ju.to_numpy(jc.lo)[v])


# -- the per-batch pipelines -------------------------------------------------------

NARROW = [1, 15, 31, 32]
WIDE = [33, 63, 64]


def assert_same_metrics(tres, jres):
    assert set(tres.metrics) == set(jres.metrics)
    for name, value in jres.metrics.items():
        assert int(tres.metrics[name]) == int(value), name


def live_pairs(table):
    """(key planes, count) of the lanes with counts > 0, in lane order."""
    live = table.counts > 0
    return [p[live].tolist() for p in table.keys] + [
        table.counts[live].tolist()]


@pytest.mark.parametrize("k", NARROW + WIDE)
@pytest.mark.parametrize("packed", [False, True])
def test_count_reads_defaults_match_jax(k, packed):
    """count_reads(_packed)(_wide)(reads, k) with no other argument: the
    compact table of kmers_tpu's call, lane for lane, and its metrics."""
    reads = make_reads(k + 100, 8, 128)
    wide = k > 32
    if packed:
        words, vbits = pack_batch_np(reads)
        jfn = jpipe.count_reads_packed_wide if wide else jpipe.count_reads_packed
        tfn = tpipe.count_reads_packed_wide if wide else tpipe.count_reads_packed
        jres = jfn(jnp.asarray(words), jnp.asarray(vbits), k)
        tres = tfn(t32(words), t32(vbits), k)
    else:
        jfn = jpipe.count_reads_wide if wide else jpipe.count_reads
        tfn = tpipe.count_reads_wide if wide else tpipe.count_reads
        jres = jfn(jnp.asarray(reads), k)
        tres = tfn(torch.from_numpy(reads), k)
    assert isinstance(tres.table, (tcount.CountTable, tcount.CountTableWide))
    assert_same_table(tres.table, jres.table)
    assert_same_metrics(tres, jres)


@pytest.mark.parametrize("k", [15, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("aggregate", ["runlength", "unit"])
def test_count_reads_aggregates_match_jax(k, aggregate):
    """The run-length form: lane for lane at k = 32 / 64 (globally sorted
    on every device); K10's per-segment layout at k <= 31 / k <= 63 merges
    to kmers_tpu's table.  The unit form: the same live keys."""
    if aggregate == "unit" and k in (32, 64):
        with pytest.raises(ValueError):
            (tpipe.count_reads_wide if k > 32 else tpipe.count_reads)(
                torch.from_numpy(make_reads(1, 2, 64)), k, aggregate="unit")
        return
    reads = make_reads(k, 8, 128)
    wide = k > 32
    jfn = jpipe.count_reads_wide if wide else jpipe.count_reads
    tfn = tpipe.count_reads_wide if wide else tpipe.count_reads
    jres = jfn(jnp.asarray(reads), k, aggregate=aggregate)
    tres = tfn(torch.from_numpy(reads), spec=tpipe.KmerSpec(k),
               aggregate=aggregate)
    assert_same_metrics(tres, jres)
    merge = tcount.merge_many_wide if wide else tcount.merge_many
    if aggregate == "runlength" and k in (32, 64):
        want = [np.asarray(p) for p in (
            (jres.table.keys.hi.hi, jres.table.keys.hi.lo, jres.table.keys.lo.hi,
             jres.table.keys.lo.lo) if wide else
            (jres.table.keys.hi, jres.table.keys.lo))]
        live = np.asarray(jres.table.counts) > 0
        got = live_pairs(tres.table)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.array(g, np.int64).astype(np.uint32),
                                          w[live])
        np.testing.assert_array_equal(got[-1], np.asarray(jres.table.counts)[live])
        assert tres.table.n_unique == int(jres.table.n_unique)
    jmerged = jpipe.count_reads_wide(jnp.asarray(reads), k) if wide else (
        jpipe.count_reads(jnp.asarray(reads), k))
    merged = merge([tres.table], max_k=k)
    assert_same_table(merged, jmerged.table, n=int(jmerged.table.n_unique))


def test_canonical_kmers_match_jax():
    reads = make_reads(5, 4, 100)
    for k in (21, 32):
        c, v = tpipe.canonical_kmers(torch.from_numpy(reads), k)
        jc, jv = jpipe.canonical_kmers(jnp.asarray(reads), k)
        m = np.asarray(jv)
        np.testing.assert_array_equal(v.numpy(), m)
        np.testing.assert_array_equal(words_of(c)[m], ju.to_numpy(jc)[m])
    (hi, lo), v = tpipe.canonical_kmers_wide(torch.from_numpy(reads), 64)
    jc, jv = jpipe.canonical_kmers_wide(jnp.asarray(reads), 64)
    m = np.asarray(jv)
    np.testing.assert_array_equal(words_of(hi)[m], ju.to_numpy(jc.hi)[m])
    np.testing.assert_array_equal(words_of(lo)[m], ju.to_numpy(jc.lo)[m])
    with pytest.raises(TypeError):
        tpipe.count_reads(torch.from_numpy(reads))
    with pytest.raises(ValueError):
        tpipe.count_reads(torch.from_numpy(reads), 21, aggregate="sorted")


# -- StreamingCounter at k = 32 and 64 ------------------------------------------------

@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("capacity", [8192, 512])
def test_streaming_counter_full_width_matches_jax(tmp_path, k, packed,
                                                  capacity):
    """Run-length batches, the sort-based consolidation, eviction at
    capacity 512: the same checkpoint content, drops and pairs."""
    rows = batches(k)
    j = JaxCounter(k, capacity, merge_every=2)
    t = StreamingCounter(k, capacity, merge_every=2, device="cpu")
    feed(j, rows, packed)
    feed(t, rows, packed)
    assert saved_digest(t, tmp_path / "t") == saved_digest(j, tmp_path / "j")
    assert (t.dropped_unique, t.dropped_kmers) == (j.dropped_unique,
                                                   j.dropped_kmers)
    assert (t.dropped_unique > 0) == (capacity == 512)
    assert t.to_pairs() == j.to_pairs()


@pytest.mark.parametrize("k", [32, 64])
def test_full_width_checkpoints_resume_across_packages(tmp_path, k):
    """k = 32 keeps the narrow npz layout, k = 64 the wide one; either
    package's checkpoint resumes in the other."""
    rows = batches(k + 1, n=4)
    j = JaxCounter(k, 8192, merge_every=2)
    t = StreamingCounter(k, 8192, merge_every=2, device="cpu")
    feed(j, rows[:2], True)
    feed(t, rows[:2], True)
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    with np.load(str(tmp_path / "t.npz")) as z:
        assert ("keys_hi_hi" in z.files) == (k == 64)
    assert npz_digest(str(tmp_path / "j.npz")) == npz_digest(
        str(tmp_path / "t.npz"))
    t2 = StreamingCounter.load(str(tmp_path / "j"), device="cpu")
    j2 = JaxCounter.load(str(tmp_path / "t"))
    for sc in (t2, j2):
        sc.merge_every = 2
        feed(sc, rows[2:], True)
    assert saved_digest(t2, tmp_path / "a") == saved_digest(j2, tmp_path / "b")
    assert t2.to_pairs() == j2.to_pairs()


def test_lookup_at_k32_finds_bit63_keys():
    """Reads of the palindrome A^16 T^16 (canonical word with bit 63 set)
    are found by lookup; so is every other key of the table."""
    row = np.frombuffer((PALINDROME_32 * 3).encode(), np.uint8)
    rows = np.full((4, 128), ord("N"), np.uint8)
    rows[:, :96] = row
    t = StreamingCounter(32, 1024, merge_every=1, device="cpu")
    t.update(rows)
    pal = tkmer.canonical_from_string(PALINDROME_32)
    assert pal >> 63 == 1
    pairs = dict(t.to_pairs())
    assert pairs[pal] == 3 * 4
    keys = list(pairs)
    got = t.lookup(tu.from_ints(keys + [5]))
    assert got.tolist() == [pairs[w] for w in keys] + [0]


@pytest.mark.parametrize("k", [32, 64])
def test_count_fastx_full_width_matches_jax(tmp_path, k):
    from kmers_tpu.parallel.stream import count_fastx as jax_count_fastx
    from kmers_tpu_torch.io import simulate
    from kmers_tpu_torch.parallel.stream import count_fastx

    fq = str(tmp_path / "r.fastq")
    simulate.write_fastq(fq, 3000, 70, 100, 0.01, 0.005, 6)
    args = dict(k=k, capacity=4096, batch=16, length=128, merge_every=2)
    j = jax_count_fastx(fq, **args)
    t = count_fastx(fq, device="cpu", **args)
    assert (t.batches, t.kmers) == (j.batches, j.kmers)
    assert t.to_pairs() == j.to_pairs()
