"""The rest of the port's surface against the JAX package's, on the CPU:
the scalar compat API (its own copy of the scalar model), utils,
profiling, the record reader and native pack of io.fastx, the package's
exports, and the pinned PARITY_DIGEST, which ties the SeqVector and
generic outputs of kmers_tpu on the CPU to the port's (chip_smoke.py
recomputes it on the card).
"""

import json
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import kmers_tpu
import kmers_tpu_torch
from kmers_tpu import compat as jcompat
from kmers_tpu import profiling as jprof
from kmers_tpu import utils as jutils
from kmers_tpu.core import u64 as ju
from kmers_tpu.io import fastx as jfastx
from kmers_tpu.ops import generic as jg
from kmers_tpu.ops import hash as jhash
from kmers_tpu.ops.seqvector import SeqVector as JSeqVector
from kmers_tpu_torch import compat as tcompat
from kmers_tpu_torch import profiling as tprof
from kmers_tpu_torch import smoke
from kmers_tpu_torch import utils as tutils
from kmers_tpu_torch.io import fastx as tfastx


# -- compat ------------------------------------------------------------------

def drive(c, seed):
    """A seeded sequence of scalar operations on a compat module; returns
    every result as plain ints, strings and tuples."""
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        k = rng.randint(1, 32)
        s = bytes(rng.choice(b"ACGTacgt") for _ in range(k))
        km = c.Kmer.from_str(s)
        rc = km.to_reverse_complement()
        out += [km.data, str(km), rc.data, km.is_canonical(),
                int(km.orientation()), km.to_canonical().data,
                km.into_u64(), c.Kmer.from_u64(km.data, k).data]
        b = rng.randrange(4)
        out += [km.append_base(b), km.data, km.prepend_base(b), km.data,
                km.append_base_u8(ord("G")), km.prepend_base_u8(ord("t")),
                km.data]
        width = rng.randint(1, k)
        pos = rng.randint(0, k - width)
        out += [km.sub_kmer_word(pos, width), km.sub_kmer(pos, width).data,
                c.sub_kmer_word(km.data, k, pos, width)]
        for state in (c.lex_hash_state(width), c.mix_hash_state(seed)):
            mm, off = km.minimizer(width, state)
            out += [mm.data, off, c.minimizer_word(km.data, k, width, state),
                    c.hash_one(state, km), c.hash_one(state, km.data)]
        ck = c.CanonicalKmer.from_str(s)
        out += [ck.get_fw_word(), ck.get_rc_word(), ck.get_canonical_word(),
                ck.is_fw_canonical(), str(ck),
                ck.append_base(b), ck.prepend_base_u8(ord("A")),
                ck.get_canonical_kmer().data, ck.get_fw_mer().data,
                ck.get_rc_mer().data,
                int(ck.get_word_equivalency(ck.get_rc_word())),
                int(ck.get_kmer_equivalency(ck.get_fw_mer())),
                int(ck.get_word_equivalency(12345))]
        ck.swap()
        out += [ck.get_fw_word(), ck == c.CanonicalKmer.from_kmer(km),
                c.CanonicalKmer.blank_of_size(k).get_rc_word(),
                c.CanonicalKmer.from_u64(km.data, k).get_rc_word()]
        out += [c.reverse_complement_word(km.data, k), c.lex_hash(km.data, k),
                c.mix_hash(km.data, seed), c.word_from_bytes(s),
                c.word_to_string(km.data, k)]
    read = bytes(rng.choice(b"ACGTNacgt") for _ in range(200))
    it = c.CanonicalKmerIterator(read, 11)
    out.append(list(it))
    it = c.CanonicalKmerIterator(read, 7)
    out.append((it.inc_by(5), it.get()[1], it.exhausted()))
    sv = c.SeqVector.from_bytes(read.replace(b"N", b"A"))
    sv.push_chars(b"ACGTTGCA" * 5)
    out += [len(sv), str(sv), sv.to_simple_sds(), sv.get_kmer_u64(13, 32),
            sv.get_base(7), [x.data for x in sv.iter_kmers(31)][:5],
            list(sv.iter_minimizers(21, 7, c.lex_hash_state(7)))]
    sl = sv.slice(10, 150)
    out += [len(sl), str(sl), sl.slice(5, 100).get_kmer_u64(3, 20),
            list(sl.iter_minimizers(15, 5, c.mix_hash_state(1)))]
    out += [c.MASK64, c.MASK_TABLE[32], c.MASK_TABLE[31],
            c.complement_base(1), c.is_valid_nuc(4),
            c.encode_binary("g"), c.encode_binary_u8(ord("N")),
            int(c.MatchType.TwinMatch), int(c.Orientation.NotCanonical)]
    with pytest.raises(ValueError):
        c.encode_binary("N")
    return [tuple(x) if isinstance(x, list) else x for x in out]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compat_sequences_match_jax(seed):
    assert drive(tcompat, seed) == drive(jcompat, seed)


def test_compat_is_the_ports_own_copy():
    from kmers_tpu.oracle import numpy_ref as jref
    from kmers_tpu_torch.oracle import numpy_ref as tref

    assert tref.NAIVE_PERMS == jref.NAIVE_PERMS
    assert tref.MASK_TABLE == jref.MASK_TABLE and tref.MASK_TABLE[32] == 0
    assert all(tref.word_for_k(w, k) == jref.word_for_k(w, k)
               for w in (8, 16, 32, 64, 128) for k in range(1, 70))
    assert tcompat.__all__ == jcompat.__all__
    for name in tcompat.__all__:
        obj = getattr(tcompat, name)
        if isinstance(obj, type) or callable(obj):
            assert obj is not getattr(jcompat, name), name
            assert obj.__module__.startswith("kmers_tpu_torch."), name
        else:
            assert obj == getattr(jcompat, name), name


# -- utils ---------------------------------------------------------------------

def test_utils_match_jax():
    for k in range(1, 33):
        assert tutils.kmer_space(k) == jutils.kmer_space(k)
        assert tutils.canonical_space(k) == jutils.canonical_space(k)
    assert tutils.canonical_space(2) == 16 // 2 - 4       # the even-k quirk
    rng = random.Random(3)
    for _ in range(50):
        n = rng.randint(0, 40)
        mer = rng.getrandbits(2 * n + 3)
        assert tutils.bitmer_to_bytes(mer, n) == jutils.bitmer_to_bytes(mer, n)


# -- profiling --------------------------------------------------------------------

def test_timer_roofline_and_metrics_match_jax(monkeypatch):
    monkeypatch.setenv(tprof.HBM_ENV, "3350")
    monkeypatch.setenv("KMERS_TPU_HBM_GBPS", "3350")
    t = tprof.Timer()
    for _ in range(3):
        with t.round():
            torch.zeros(16).sum().item()
    assert len(t.times) == 3 and t.best > 0
    assert t.rate(10) == 10 / t.best
    assert tprof.roofline(1e9, 18.0) == jprof.roofline(1e9, 18.0)
    assert tprof.roofline(1e9, 18.0)["achieved_gbps"] == 18.0
    updates = [{"reads": 4, "kmers_emitted": 100},
               {"reads": 2, "kmers_emitted": 50, "route_overflow": 1}]
    tm, jm = tprof.MetricsAccumulator(), jprof.MetricsAccumulator()
    for u in updates:
        tm.update({k: torch.tensor(v) for k, v in u.items()})
        jm.update(u)
    assert tm.summary() == jm.summary()
    assert tm["reads"] == 6 and tm["absent"] == 0


def test_device_hbm_gbps_is_nvidia_only(monkeypatch):
    """The table holds NVIDIA figures: by the CUDA device's name, the
    override first; a CPU device or an unknown card raises (the JAX
    package falls back to a TPU figure off a TPU, the port does not)."""
    monkeypatch.delenv(tprof.HBM_ENV, raising=False)
    with pytest.raises(RuntimeError):
        tprof.device_hbm_gbps("cpu")
    name = {"n": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name["n"])
    assert tprof.device_hbm_gbps() == 3350.0
    assert tprof.device_hbm_gbps("cuda:0") == 3350.0
    name["n"] = "NVIDIA Imaginary 9000"
    with pytest.raises(RuntimeError):
        tprof.device_hbm_gbps()
    monkeypatch.setenv(tprof.HBM_ENV, "1234.5")
    assert tprof.device_hbm_gbps("cpu") == 1234.5
    assert all(not key.lower().startswith("v") for key in tprof.HBM_GBPS)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        (torch.arange(1000) * 3).sum().item()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# -- io.fastx: records and the native pack --------------------------------------

def write_records(tmp_path, fmt, gz):
    import gzip

    rng = random.Random(7)
    recs = [bytes(rng.choice(b"ACGTN") for _ in range(rng.randrange(1, 300)))
            for _ in range(29)]
    if fmt == "fasta":
        body = b"".join(b">r%d desc\n" % i + b"\n".join(
            r[j:j + 60] for j in range(0, len(r), 60)) + b"\n"
            for i, r in enumerate(recs))
    else:
        body = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"@" + b"I" * (len(r) - 1))
                        for i, r in enumerate(recs))
    path = str(tmp_path / (f"r.{fmt}" + (".gz" if gz else "")))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(body)
    return path, recs


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("gz", [False, True])
def test_read_records_match_jax(tmp_path, fmt, gz):
    assert tfastx.native_available() == jfastx.native_available()
    path, recs = write_records(tmp_path, fmt, gz)
    for force in (False, True):
        got = list(tfastx.read_records(path, 8, 128, force_python=force))
        want = list(jfastx.read_records(path, 8, 128, force_python=force))
        assert len(got) == len(want) == 4
        for (rows, lens), (jrows, jlens) in zip(got, want):
            np.testing.assert_array_equal(rows, jrows)
            np.testing.assert_array_equal(lens, jlens)
        assert [int(n) for _, lens in got for n in lens] == [len(r) for r in recs]


def test_pack2bit_native_matches_jax_on_both_paths(monkeypatch):
    rng = random.Random(9)
    seq = bytes(rng.choice(b"ACGTNacgtRY") for _ in range(1001))
    for data in (seq, seq[:64], b""):
        for got, want in zip(tfastx.pack2bit_native(data),
                             jfastx.pack2bit_native(data)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tfastx, "_load_native", lambda: None)
    monkeypatch.setattr(jfastx, "_load_native", lambda: None)
    for got, want in zip(tfastx.pack2bit_native(seq),
                         jfastx.pack2bit_native(seq)):
        np.testing.assert_array_equal(got, want)


# -- the package's exports -------------------------------------------------------

def test_every_jax_export_has_its_counterpart():
    for name in kmers_tpu.__all__:
        assert name in kmers_tpu_torch.__all__, name
        assert hasattr(kmers_tpu_torch, name), name
    assert kmers_tpu_torch.__version__ == kmers_tpu.__version__
    from kmers_tpu_torch.ops.seqvector import SeqVector

    assert kmers_tpu_torch.SeqVector is SeqVector
    assert kmers_tpu_torch.GenericSpec(64, 31, "ACGT").n_lanes == 2
    assert hasattr(kmers_tpu_torch, "make_mesh") and hasattr(
        kmers_tpu_torch.stream, "npz_digest")


# -- the pinned parity digest -------------------------------------------------------

def jax_parity_arrays() -> list:
    """kmers_tpu's outputs on the parity input, in smoke.parity_arrays'
    order."""
    seq, reads = smoke.parity_input()
    sv = JSeqVector.from_bytes(seq)
    out = [ju.to_numpy(sv.all_kmers(k)[0]) for k in (31, 32)]
    k, w = smoke.PARITY_MINIMIZER
    for fn in (jhash.mix_hash_fn(0), jhash.lex_hash_fn(w)):
        word, pos = sv.minimizers(k, w, fn)
        out += [ju.to_numpy(word), np.asarray(pos)]
    out.append(np.frombuffer(sv.to_simple_sds(), dtype=np.uint8))
    r = jnp.asarray(reads)
    for width, k, encoding in smoke.PARITY_SPECS:
        spec = jg.GenericSpec(width, k, encoding)
        lanes, _ = jg.encode_windows(spec, r)
        out += [np.asarray(x) for x in lanes]
        out.append(np.asarray(jg.decode(spec, lanes)))
        out += [np.asarray(x) for x in jg.rev_comp(spec, lanes)]
    return out


def test_parity_digest_is_kmers_tpus_and_the_ports():
    want = jax_parity_arrays()
    got = smoke.parity_arrays("cpu")
    assert [(a.dtype, a.shape) for a in got] == [(a.dtype, a.shape)
                                                 for a in want]
    assert smoke.digest_arrays(want) == smoke.PARITY_DIGEST
    assert smoke.digest_arrays(got) == smoke.PARITY_DIGEST
