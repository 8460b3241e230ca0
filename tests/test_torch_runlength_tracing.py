"""The run-length path at k = 32 and k = 64 (full-word keys, no spare
flag bit): its spans and counters (``kmers.emit.runs``; at k = 32 the
merge of sorted tables, ``kmers.consolidate.sorted_merge`` and
``kmers.consolidate.sorted_merges`` / ``.sorted_lanes``; at k = 64 the
re-count, ``kmers.consolidate.recount`` / ``.recount.sort`` and
``kmers.consolidate.recounts`` / ``.recount_lanes``), off with no
profiler, and the CLI's k = 32 table against the benchmark's plain
reference on reads that hold the word (0x80000000, 0), keys with bit 63
set and Ns, and the k = 64 table the same way, bit 127 set."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import kmer_count as ref
from kmers_tpu_torch import __main__ as cli
from kmers_tpu_torch import profiling
from kmers_tpu_torch.io import fastx, simulate
from kmers_tpu_torch.parallel import stream

BATCH, LENGTH = 64, 128
FULL_WORD_KS = [32, 64]


def user_spans(prof, path):
    """[(name, start, end, tid)] of the trace's record_function ranges."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def within(spans, name, parent, eps=1e-3):
    return [s for s in named(spans, name)
            if s[3] == parent[3] and s[1] >= parent[1] - eps
            and s[2] <= parent[2] + eps]


def no_record_function(*_args, **_kwargs):
    raise AssertionError("record_function entered with no profiler")


@pytest.fixture
def fastq(tmp_path):
    path = str(tmp_path / "reads.fq")
    simulate.write_fastq(path, 6000, 300, 100, 0.001, 0.01, seed=32)
    return path


def count_argv(path, out, k):
    return ["count", path, "-k", str(k), "-o", str(out), "--capacity",
            str(1 << 15), "--batch", str(BATCH), "--length", str(LENGTH),
            "--merge-every", "2", "--device", "cpu"]


@pytest.mark.parametrize("k", FULL_WORD_KS)
def test_cli_count_spans(tmp_path, fastq, k):
    """Under a CPU profiler: one kmers.emit.runs inside each
    kmers.emit.count; inside each kmers.consolidate, at k = 32 one
    kmers.consolidate.sorted_merge and no re-count, at k = 64 one
    kmers.consolidate.recount holding one .recount.join and, after it,
    one .recount.sort; one merge or re-count a consolidation on the
    counters."""
    n_batches = sum(1 for _ in fastx.read_packed_batches(
        fastq, k=k, batch=BATCH, length=LENGTH))
    assert n_batches >= 4
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert cli.main(count_argv(fastq, tmp_path / "t.npz", k)) == 0
    after = profiling.counters()
    spans = user_spans(prof, tmp_path / "trace.json")

    counts = named(spans, "kmers.emit.count")
    assert len(counts) == n_batches
    for c in counts:
        assert len(within(spans, "kmers.emit.runs", c)) == 1
    assert len(named(spans, "kmers.emit.runs")) == n_batches
    consolidations = named(spans, "kmers.consolidate")
    assert len(consolidations) == (n_batches + 1) // 2
    merge, other, counter = (
        ("kmers.consolidate.sorted_merge", "kmers.consolidate.recount",
         "kmers.consolidate.sorted_merges") if k == 32 else
        ("kmers.consolidate.recount", "kmers.consolidate.sorted_merge",
         "kmers.consolidate.recounts"))
    for c in consolidations:
        (inner,) = within(spans, merge, c)
        if k == 64:
            (sort,) = within(spans, "kmers.consolidate.recount.sort", inner)
            assert len(within(spans, "kmers.consolidate.recount.sort",
                              c)) == 1
            # the planes' join and concatenation come first, then the sort
            (join,) = within(spans, "kmers.consolidate.recount.join", inner)
            assert join[2] <= sort[1]
    assert len(named(spans, "kmers.consolidate.recount.join")) == (
        len(consolidations) if k == 64 else 0)
    assert len(named(spans, merge)) == len(consolidations)
    assert not named(spans, other)
    assert after.get(counter, 0) - before.get(counter, 0) == \
        len(consolidations)


def packed_batches(k, rows_per_batch, seed=3):
    """Packed batches of random reads with a few Ns, one per row count."""
    rng = np.random.default_rng(seed + k)
    out = []
    for rows in rows_per_batch:
        reads = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, (rows, LENGTH))]
        reads[rng.random(reads.shape) < 0.01] = ord("N")
        out.append(fastx.pack_batch_np(reads))
    return out


@pytest.mark.parametrize("k", FULL_WORD_KS)
@pytest.mark.parametrize("rows_per_batch", [
    [16] * 7,                 # two full consolidations, then 1 padded to 3
    [16, 8, 16, 16, 4],       # one of mixed shapes, then 2 of unequal ones
])
def test_recount_lanes_are_the_merged_capacities(monkeypatch, k,
                                                 rows_per_batch):
    """At every consolidation the counters move by one merge (k = 32) or
    re-count (k = 64), and by the lanes it took in: at k = 32 the table's
    live prefix and the pending tables' live lanes (runs), at k = 64 the
    summed capacities of the table and the pending tables (the padding
    to merge_every included)."""
    seen = []
    consolidate = stream.StreamingCounter._consolidate
    names = (("kmers.consolidate.sorted_merges",
              "kmers.consolidate.sorted_lanes") if k == 32 else
             ("kmers.consolidate.recounts",
              "kmers.consolidate.recount_lanes"))

    def recorded(self):
        if not self._pending:
            return consolidate(self)
        if k == 32:
            want = self.table.n_unique + sum(
                int((t.counts > 0).sum()) for t in self._pending)
        else:
            caps = [t.capacity for t in self._pending]
            if len(set(caps)) == 1:
                caps += [caps[0]] * (self.merge_every - len(caps))
            want = self.table.capacity + sum(caps)
        before = profiling.counters()
        consolidate(self)
        after = profiling.counters()
        seen.append(tuple(after.get(n, 0) - before.get(n, 0)
                          for n in names) + (want,))

    monkeypatch.setattr(stream.StreamingCounter, "_consolidate", recorded)
    sc = stream.StreamingCounter(k, 1 << 13, merge_every=3, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for words, validbits in packed_batches(k, rows_per_batch):
            sc.update_packed(words, validbits)
        sc.to_pairs()
    assert len(seen) == -(-len(rows_per_batch) // 3)
    for recounts, lanes, want in seen:
        assert recounts == 1
        assert lanes == want


@pytest.mark.parametrize("k", FULL_WORD_KS)
def test_off_records_nothing(monkeypatch, tmp_path, fastq, k):
    """A whole CLI count at k = 32 / 64 with no profiler: no
    record_function, and no counter moves."""
    before = profiling.counters()
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record_function)
    assert cli.main(count_argv(fastq, tmp_path / "t.npz", k)) == 0
    assert profiling.counters() == before


# -- the k = 32 table against the plain reference ------------------------------

#: (0x80000000, 0) as a key: A^31 G's forward word, smaller than its
#: reverse complement C T^31's, so canonical; the JAX package's folded
#: invalid pattern at k <= 31
FLAG_WORD = 1 << 63


def seeded_reads(seed=32, n=400, read_len=100, k=32):
    """Random reads with 1 % N, and rows that hold A^(k-1) G, its reverse
    complement C T^(k-1), A^(k-1) G before an N, and C^(k-1) T (canonical
    as its reverse complement A G^(k-1), the key's top bit set too)."""
    rng = np.random.default_rng(seed)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                          (n, read_len))]
    reads[rng.random(reads.shape) < 0.01] = ord("N")
    a, c, t = (b * (k - 1) for b in (b"A", b"C", b"T"))
    for i, motif in enumerate([a + b"G", b"C" + t, c + b"T", a + b"GN"]):
        at = 7 * i
        reads[i, at:at + len(motif)] = np.frombuffer(motif, np.uint8)
    return reads


def write_fastq(path, reads):
    with open(path, "wb") as f:
        for i, row in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, row.tobytes(),
                                            b"I" * len(row)))


def test_cli_k32_table_is_the_references(tmp_path):
    """The CLI's k = 32 count (packed ingest, run-length batch tables,
    weighted re-counts mid-stream and at save) equals the benchmark's
    reference key for key and count for count."""
    reads = seeded_reads()
    path = tmp_path / "reads.fq"
    write_fastq(path, reads)
    assert cli.main(count_argv(str(path), tmp_path / "t.npz", 32)) == 0
    with np.load(tmp_path / "t.npz") as z:
        nu = int(z["n_unique"])
        got = ((z["keys_hi"][:nu].astype(np.uint64) << np.uint64(32))
               | z["keys_lo"][:nu].astype(np.uint64))
        got_counts = z["counts"][:nu].astype(np.int64)
        kmers = int(z["kmers"])
    hi, lo, counts = (t.numpy() for t in ref.count_reads(reads, 32, "cpu"))
    assert not hi.any()
    want = lo.view(np.uint64)
    assert np.array_equal(got, want)
    assert np.array_equal(got_counts, counts)
    assert kmers == int(counts.sum())
    # the motifs' keys: the flag word (twice per strand, at least), and
    # keys past bit 63 in the thousands
    assert counts[np.searchsorted(want, np.uint64(FLAG_WORD))] >= 3
    assert want[np.searchsorted(want, np.uint64(FLAG_WORD))] == FLAG_WORD
    assert (want >= np.uint64(FLAG_WORD)).sum() > 1000


#: A^63 G's forward word as a 128-bit key: (1 << 63, 0) as (hi, lo), bit
#: 127 alone; smaller than its reverse complement C T^63's, so canonical
TOP_WORD = 1 << 63


def test_cli_k64_table_is_the_references(tmp_path):
    """The CLI's k = 64 count (packed ingest, wide run-length batch
    tables, weighted re-counts mid-stream and at save) equals the
    benchmark's reference key for key and count for count, over keys that
    fill both words."""
    reads = seeded_reads(k=64)
    path = tmp_path / "reads.fq"
    write_fastq(path, reads)
    assert cli.main(count_argv(str(path), tmp_path / "t.npz", 64)) == 0
    with np.load(tmp_path / "t.npz") as z:
        nu = int(z["n_unique"])
        join = lambda a, b: ((z[a][:nu].astype(np.uint64) << np.uint64(32))
                             | z[b][:nu].astype(np.uint64))
        got_hi = join("keys_hi_hi", "keys_hi_lo")
        got_lo = join("keys_lo_hi", "keys_lo_lo")
        got_counts = z["counts"][:nu].astype(np.int64)
        kmers = int(z["kmers"])
    hi, lo, counts = (t.numpy() for t in ref.count_reads(reads, 64, "cpu"))
    want_hi, want_lo = hi.view(np.uint64), lo.view(np.uint64)
    assert nu == len(counts) > 5_000
    assert np.array_equal(got_hi, want_hi)
    assert np.array_equal(got_lo, want_lo)
    assert np.array_equal(got_counts, counts)
    assert kmers == int(counts.sum())
    # bit 127 alone (A^63 G: twice per strand, at least), and keys with
    # bit 127 set in the thousands
    top = np.flatnonzero((want_hi == np.uint64(TOP_WORD)) & (want_lo == 0))
    assert len(top) == 1 and counts[top[0]] >= 3
    assert (want_hi >= np.uint64(TOP_WORD)).sum() > 1000
