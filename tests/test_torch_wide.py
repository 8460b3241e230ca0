"""The port's wide tier (33 <= k <= 63, 128-bit keys) against the JAX
package on the CPU: the u128 helpers, the wide windows, the plain
versions of the kernels K7 (pack_canonical_keys_wide) and K6
(merge_sorted_wide) against the Pallas kernels in interpret mode, the
wide consolidation, lookup, StreamingCounter, checkpoints across the two
packages and the CLI.  The CUDA kernels are compared with these plain
versions on the card by test_torch_cuda.py."""

import contextlib
import io

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu.core import u128 as ju128
from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.kernels import merge as jmerge
from kmers_tpu.kernels import window_wide as jww
from kmers_tpu.ops import kmer as jkmer
from kmers_tpu.oracle import numpy_ref as oracle
from kmers_tpu.parallel import count as jcount
from kmers_tpu.parallel.stream import StreamingCounter as JaxCounter
from kmers_tpu_torch import convert, kernels, smoke
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.core import u128 as tu128
from kmers_tpu_torch.kernels import merge as tmerge
from kmers_tpu_torch.kernels import window_wide as tww
from kmers_tpu_torch.ops import kmer as tkmer
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel.stream import (StreamingCounter,
                                             _sort_units_wide, npz_digest)

from test_torch_kmer import make_reads
from test_torch_stream import batches, feed, saved_digest

K = 63
MASK32 = 0xFFFFFFFF


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def rand_ints(rng, n, bits) -> list:
    """n random unsigned ints below 2^bits (bits <= 128)."""
    return [int.from_bytes(rng.bytes(16), "little") & ((1 << bits) - 1)
            for _ in range(n)]


def planes_of(values, n=None) -> np.ndarray:
    """[4, n] uint32 planes (most significant first) of 128-bit ints,
    zero past len(values)."""
    n = len(values) if n is None else n
    out = np.zeros((4, n), np.uint32)
    for i, v in enumerate(values):
        for j in range(4):
            out[j, i] = (v >> (32 * (3 - j))) & MASK32
    return out


def ints_of(planes) -> list:
    p = [np.asarray(x).astype(object) for x in planes]
    return [int((a << 96) | (b << 64) | (c << 32) | d)
            for a, b, c, d in zip(*p)]


def jax_u128(planes) -> U128:
    j = [jnp.asarray(np.asarray(p, np.uint32)) for p in planes]
    return U128(U64(j[0], j[1]), U64(j[2], j[3]))


def jax_planes(x: U128) -> list:
    return [np.asarray(p) for p in (x.hi.hi, x.hi.lo, x.lo.hi, x.lo.lo)]


# -- u128 helpers and the wide windows -----------------------------------------

def test_u128_helpers_match_python_ints():
    vals = rand_ints(np.random.default_rng(1), 300, 128)
    vals += [0, (1 << 128) - 1, 1 << 127, (1 << 64) - 1, 1 << 64] + vals[:20]
    hi, lo = tu128.from_ints(vals)
    assert tu128.to_ints(hi, lo) == vals
    planes = tu128.split_planes(hi, lo)
    np.testing.assert_array_equal(np.stack([as_u32(p) for p in planes]),
                                  planes_of(vals))
    assert all(torch.equal(a, b) for a, b in
               zip(tu128.join_planes(*planes), (hi, lo)))
    order = tu128.argsort(hi, lo).tolist()
    assert [vals[i] for i in order] == sorted(vals)
    # stable: equal words keep their order
    assert order == sorted(range(len(vals)), key=lambda i: (vals[i], i))
    a, b = hi[:-1], lo[:-1]
    c, d = hi[1:], lo[1:]
    assert tu128.lt(a, b, c, d).tolist() == [x < y for x, y in
                                            zip(vals[:-1], vals[1:])]
    assert tu128.eq(a, b, c, d).tolist() == [x == y for x, y in
                                            zip(vals[:-1], vals[1:])]


@pytest.mark.parametrize("k", [33, 47, 64])
def test_u128_reverse_complement_matches_jax(k):
    vals = rand_ints(np.random.default_rng(k), 200, 2 * k)
    want = ints_of(jax_planes(ju128.reverse_complement(
        jax_u128(planes_of(vals)), k)))
    got = tu128.to_ints(*tu128.reverse_complement(*tu128.from_ints(vals), k))
    assert got == want
    assert tu128.to_ints(*tu128.reverse_bases(*tu128.from_ints(vals))) == \
        ints_of(jax_planes(ju128.reverse_bases(jax_u128(planes_of(vals)))))


def assert_wide_windows_equal(jw, tw):
    v = np.asarray(jw.valid)
    np.testing.assert_array_equal(tw.valid.numpy(), v)
    assert tw.n_windows == jw.n_windows
    for jword, tword in ((jw.fw, tw.fw), (jw.rc, tw.rc),
                         (jkmer.canonical_word_wide(jw.fw, jw.rc),
                          tkmer.canonical_word_wide(tw.fw, tw.rc))):
        tp = tu128.split_planes(*tword)
        for jp, p in zip(jax_planes(jword), tp):
            np.testing.assert_array_equal(as_u32(p)[v], jp[v])


@pytest.mark.parametrize("k", [33, 47, 48, 49, 63, 64])
def test_kmer_windows_wide_match_jax(k):
    reads = make_reads(700 + k, 6, 160)
    assert_wide_windows_equal(
        jkmer.kmer_windows_wide(jnp.asarray(reads), k),
        tkmer.kmer_windows_wide(torch.from_numpy(reads), k))


@pytest.mark.parametrize("k", [33, 48, 63])
def test_kmer_windows_packed_wide_match_jax(k):
    reads = make_reads(800 + k, 5, 128)
    words, vbits = pack_batch_np(reads)
    jw = jkmer.kmer_windows_packed_wide(jnp.asarray(words),
                                        jnp.asarray(vbits), k)
    tw = tkmer.kmer_windows_packed_wide(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(vbits.view(np.int32)), k)
    assert_wide_windows_equal(jw, tw)


@pytest.mark.parametrize("k", [33, 40, 63])
def test_canonical_from_string_wide_matches_oracle(k):
    rng = np.random.default_rng(k)
    s = "".join("ACGTacgt"[i] for i in rng.integers(0, 8, k))
    fw = oracle.word_from_bytes_wide(s.upper().encode())
    assert tkmer.canonical_from_string_wide(s) == oracle.canonical_wide(fw, k)
    with pytest.raises(ValueError):
        tkmer.canonical_from_string_wide(s[:32])
    with pytest.raises(ValueError):
        tkmer.canonical_from_string_wide(s[:-1] + "N")


# -- K7 -------------------------------------------------------------------------

@pytest.mark.parametrize("k,L", [
    pytest.param(k, 256, id=str(k)) for k in (33, 47, 48, 49, 63)] + [
    (33, 150), (63, 150), (47, 257), (62, 257)])
def test_pack_canonical_keys_wide_plain_matches_pallas(k, L):
    """K7: every lane, invalid lanes exactly (0x80000000, 0, 0, 0); also
    at the reads' own 150 bases and at a row length off every power of
    two."""
    reads = make_reads(900 + k if L == 256 else L + k, 8, L)
    want = jww.pack_canonical_keys_wide(jnp.asarray(reads), k, block_rows=8,
                                        interpret=True)
    got = tww.pack_canonical_keys_wide_plain(torch.from_numpy(reads), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_u32(g), np.asarray(w))
    assert (as_u32(got[0]) == 0x80000000).any()


def test_wide_window_wrapper_takes_plain_on_cpu_and_checks_inputs():
    r = torch.from_numpy(make_reads(14, 4, 96))
    kernels.reset_launch_counts()
    got = tww.pack_canonical_keys_wide(r, 47)
    assert all(torch.equal(a, b) for a, b in
               zip(got, tww.pack_canonical_keys_wide_plain(r, 47)))
    assert set(kernels.launch_counts().values()) == {0}
    for bad_k in (31, 32, 64):
        with pytest.raises(ValueError):
            tww.pack_canonical_keys_wide(r, bad_k)
    with pytest.raises(ValueError):
        tww.pack_canonical_keys_wide(r[:, ::2], 33)


# -- K6 and the wide consolidation -------------------------------------------------

def wide_table(rng, n_live, cap, bits):
    """Sorted unique live keys below 2^bits with counts; zero past them."""
    keys = sorted(set(rand_ints(rng, n_live, bits)))
    counts = np.zeros(cap, np.int32)
    counts[:len(keys)] = rng.integers(1, 60, len(keys))
    return keys, planes_of(keys, cap), counts


def wide_units(rng, n, n_valid, bits, table_keys):
    """n folded unit keys, n_valid of them live (half from the table)."""
    keys = rand_ints(rng, n_valid, bits)
    for i in range(0, n_valid, 2):
        if table_keys:
            keys[i] = table_keys[int(rng.integers(0, len(table_keys)))]
    p = planes_of(keys, n)
    p[0, n_valid:] = 0x80000000
    return keys, p


@pytest.mark.parametrize("nA,capA,nB,totB,bits", [
    (0, 512, 300, 512, 70),
    (400, 512, 0, 300, 100),
    (15, 1024, 1500, 2048, 4),       # heavy duplicates
    (300, 700, 1200, 1300, 126),     # ragged lengths, all four planes
])
def test_merge_sorted_wide_plain_matches_pallas(nA, capA, nB, totB, bits):
    rng = np.random.default_rng(nA + nB + bits)
    keys, a, a_w = wide_table(rng, nA, capA, bits)
    nA = len(keys)
    a[:, nA:] = MASK32                      # dead slots: MAX sentinels
    _, b = wide_units(rng, totB, nB, bits, keys)
    order = np.lexsort(b[::-1])
    b = b[:, order]
    want_keys, want_w = jmerge.merge_sorted_wide(
        tuple(jnp.asarray(p) for p in a), jnp.asarray(a_w.view(np.uint32)),
        tuple(jnp.asarray(p) for p in b), tile=1024, interpret=True)
    got_keys, got_w = tmerge.merge_sorted_wide_plain(
        tuple(t32(p) for p in a), torch.from_numpy(a_w), tuple(t32(p) for p in b))
    n = capA + totB
    for g, w in zip(got_keys + (got_w,), want_keys + (want_w,)):
        assert g.shape == (n,)
        np.testing.assert_array_equal(as_u32(g), np.asarray(w)[:n])


@pytest.mark.parametrize("cap,n_live,n_units,valid_frac,bits", [
    (2048, 1500, 4096, 0.8, 120),
    (1024, 0, 2048, 0.5, 8),
    (1024, 300, 8192, 1.0, 6),      # heavy duplicates
    (512, 200, 1024, 0.0, 90),
])
def test_merge_table_with_sorted_units_wide_matches_merge_many(
        cap, n_live, n_units, valid_frac, bits):
    rng = np.random.default_rng(cap + n_live + bits)
    keys, a, a_w = wide_table(rng, n_live, cap, bits)
    n_live = len(keys)
    _, u = wide_units(rng, n_units, int(n_units * valid_frac), bits, keys)
    u = u[:, rng.permutation(n_units)]       # pending units arrive unsorted
    jt = jcount.CountTableWide(keys=jax_u128(a), counts=jnp.asarray(a_w),
                               n_unique=jnp.int32(n_live))
    want = jcount.merge_many_wide([jt, jcount.UnitTableWide(jax_u128(u))],
                                  max_k=63)
    tt = tcount.CountTableWide(tuple(t32(p) for p in a),
                               torch.from_numpy(a_w), n_live)
    s_keys = _sort_units_wide([tcount.UnitTableWide(tuple(t32(p) for p in u))])
    got = tcount.merge_table_with_sorted_units_wide(tt, s_keys)
    nu = int(want.n_unique)
    assert got.n_unique == nu and got.capacity == max(cap, nu)
    for g, w in zip(got.keys, jax_planes(want.keys)):
        np.testing.assert_array_equal(as_u32(g)[:nu], w[:nu])
        assert (g.numpy()[nu:] == 0).all()
    np.testing.assert_array_equal(got.counts.numpy()[:nu],
                                  np.asarray(want.counts)[:nu])
    assert (got.counts.numpy()[nu:] == 0).all()


def test_lookup_wide_matches_jax():
    rng = np.random.default_rng(8)
    keys, a, a_w = wide_table(rng, 500, 1024, 126)
    queries = [keys[int(i)] for i in rng.integers(0, len(keys), 200)]
    queries += rand_ints(rng, 100, 126)
    queries += [keys[0], keys[-1], 0, (1 << 126) - 1]
    jt = jcount.CountTableWide(keys=jax_u128(a), counts=jnp.asarray(a_w),
                               n_unique=jnp.int32(len(keys)))
    want = np.asarray(jcount.lookup_wide(jt, jax_u128(planes_of(queries))))
    tt = tcount.CountTableWide(tuple(t32(p) for p in a),
                               torch.from_numpy(a_w), len(keys))
    got = tcount.lookup_wide(tt, *tu128.from_ints(queries))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:200] > 0).all()
    empty = tcount.empty_table_wide(16, "cpu")
    assert (tcount.lookup_wide(empty, *tu128.from_ints(queries[:3]))
            == 0).all()


def test_wide_padding_tables_are_dead_not_zero():
    unit = tcount.UnitTableWide(tuple(torch.arange(8, dtype=torch.int32)
                                      for _ in range(4)))
    pad = tcount.empty_like_table(unit)
    assert (as_u32(pad.keys[0]) == 0x80000000).all()
    assert all((p == 0).all() for p in pad.keys[1:])
    table = tcount.empty_like_table(tcount.empty_table_wide(4, "cpu"))
    assert isinstance(table, tcount.CountTableWide) and table.n_unique == 0


def test_convert_wide_round_trip():
    rng = np.random.default_rng(0)
    keys = [rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]
    counts = rng.integers(0, 1000, 64).astype(np.int32)
    table = convert.wide_table_from_numpy(keys, counts, 40, "cpu")
    assert isinstance(table, tcount.CountTableWide) and table.n_unique == 40
    back = convert.table_to_numpy(table)
    for name, want in zip(convert.WIDE_KEY_NAMES, keys):
        np.testing.assert_array_equal(back[name], want)
        assert back[name].dtype.str == "<u4"
    np.testing.assert_array_equal(back["counts"], counts)
    with pytest.raises(ValueError):
        convert.wide_table_from_numpy(keys[:2], counts, 4, "cpu")


# -- StreamingCounter, checkpoints and the CLI at k = 63 ------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("capacity,merge_every", [
    (8192, 2),    # no eviction; the last consolidation is padded
    (512, 2),     # evicts at every consolidation
])
def test_streaming_counter_wide_matches_jax(tmp_path, packed, capacity,
                                            merge_every):
    rows = batches(11)
    j = JaxCounter(K, capacity, merge_every=merge_every)
    t = StreamingCounter(K, capacity, merge_every=merge_every, device="cpu")
    feed(j, rows, packed)
    feed(t, rows, packed)
    assert saved_digest(t, tmp_path / "t") == saved_digest(j, tmp_path / "j")
    assert (t.dropped_unique, t.dropped_kmers) == (j.dropped_unique,
                                                   j.dropped_kmers)
    assert (t.dropped_unique > 0) == (capacity < 8192)
    assert t.to_pairs() == j.to_pairs()
    with np.load(str(tmp_path / "t.npz")) as z:
        assert "keys_hi_hi" in z.files and "keys_hi" not in z.files
    pairs = t.to_pairs()[:50]
    hi, lo = tu128.from_ints([w for w, _ in pairs])
    assert t.lookup((hi, lo)).tolist() == [c for _, c in pairs]


@pytest.mark.parametrize("capacity", [8192, 512])
def test_wide_checkpoints_resume_across_packages(tmp_path, capacity):
    rows = batches(12)
    j = JaxCounter(K, capacity, merge_every=2)
    feed(j, rows[:3], packed=True)
    j.save(str(tmp_path / "j3"))
    t = StreamingCounter(K, capacity, merge_every=2, device="cpu")
    feed(t, rows[:3], packed=True)
    t.save(str(tmp_path / "t3"))
    assert npz_digest(str(tmp_path / "j3.npz")) == npz_digest(
        str(tmp_path / "t3.npz"))
    t_from_j = StreamingCounter.load(str(tmp_path / "j3"), device="cpu")
    j_from_t = JaxCounter.load(str(tmp_path / "t3"))
    assert t_from_j.wide and t_from_j.k == K
    for sc in (t_from_j, j_from_t):
        sc.merge_every = 2
        feed(sc, rows[3:], packed=True)
    assert (saved_digest(t_from_j, tmp_path / "a")
            == saved_digest(j_from_t, tmp_path / "b"))


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    return smoke.write_smoke_input(
        str(tmp_path_factory.mktemp("wide") / "smoke.fastq"))


def top_kmer_wide(path):
    with np.load(path) as z:
        nu = int(z["n_unique"])
        i = int(np.argmax(z["counts"][:nu]))
        word = ints_of([z[n][i:i + 1] for n in convert.WIDE_KEY_NAMES])[0]
        k = int(z["k"])
    return "".join("ACGT"[(word >> (2 * j)) & 3] for j in range(k))


def test_smoke_digest_wide_is_kmers_tpu_output(fastq, tmp_path):
    """SMOKE_DIGEST_WIDE (which chip_smoke.py checks on the card) is what
    both packages produce on the CPU at k = 63."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert run(jax_main, smoke.smoke_count_args(fastq, j_out, K))[0] == 0
    assert run(port_main, smoke.smoke_count_args(fastq, t_out, K)
               + ["--device", "cpu"])[0] == 0
    assert npz_digest(j_out) == smoke.SMOKE_DIGEST_WIDE
    assert npz_digest(t_out) == smoke.SMOKE_DIGEST_WIDE


@pytest.mark.parametrize("extra,want_rc", [
    ([], 0),                                           # packed ingest
    (["--ascii-ingest"], 0),
    (["--capacity", "4096", "--merge-every", "2"], 3),  # evicts
])
def test_cli_wide_matches_kmers_tpu(fastq, tmp_path, extra, want_rc):
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_rc, _, j_err = run(jax_main, smoke.smoke_count_args(fastq, j_out, K)
                         + extra)
    t_rc, _, t_err = run(port_main, smoke.smoke_count_args(fastq, t_out, K)
                         + extra + ["--device", "cpu"])
    assert j_rc == t_rc == want_rc
    assert npz_digest(j_out) == npz_digest(t_out)
    warn = lambda err: [ln for ln in err.splitlines() if "WARNING" in ln]
    assert warn(j_err) == warn(t_err)

    assert run(jax_main, ["stats", j_out])[:2] == run(
        port_main, ["stats", t_out, "--device", "cpu"])[:2]
    top = top_kmer_wide(t_out)
    rc_top = "".join("TGCA"["ACGT".index(c)] for c in reversed(top))
    queries = [top, rc_top.lower(), "A" * K, "ACGT" * 15 + "ACN", "ACGT"]
    j_q = run(jax_main, ["query", j_out] + queries)
    t_q = run(port_main, ["query", t_out] + queries + ["--device", "cpu"])
    assert j_q[:2] == t_q[:2]
    assert j_q[0] == 2                  # "ACGT" has the wrong length
    assert int(t_q[1].splitlines()[0].split("\t")[1]) > 0


def test_cli_wide_checkpoint_and_resume(fastq, tmp_path):
    out = str(tmp_path / "t.npz")
    args = smoke.smoke_count_args(fastq, out, 47) + ["--device", "cpu"]
    assert run(port_main, args + ["--checkpoint-every", "3"])[0] == 0
    whole = npz_digest(out)
    rc, _, err = run(port_main, args + ["--resume"])
    assert rc == 0 and "resuming" in err
    assert npz_digest(out) == whole
