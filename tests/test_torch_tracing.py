"""The port's own spans and counters (``kmers_tpu_torch.profiling``): off
unless a torch profiler records (no ``record_function``, clock read or
new object), where each sits on a CLI count and a lookup step when one
does, the counters under threads, and ``profiling.trace``'s files."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from kmers_tpu_torch import __main__ as cli
from kmers_tpu_torch import profiling
from kmers_tpu_torch.io import fastx, simulate
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline

#: the benchmark harness's own span names, which no program span takes
HARNESS_SPANS = ("job", "lookup_call", "ingest_wait", "update_packed",
                 "consolidate", "save", "harness")
BATCH, LENGTH = 64, 128


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


def inside(child, parent, eps=1e-3):
    return (child[3] == parent[3] and child[1] >= parent[1] - eps
            and child[2] <= parent[2] + eps)


def within(spans, name, parent):
    return [s for s in named(spans, name) if inside(s, parent)]


def no_record_function(*_args, **_kwargs):
    raise AssertionError("record_function entered with no profiler")


@pytest.fixture
def fastq(tmp_path):
    path = str(tmp_path / "reads.fq")
    simulate.write_fastq(path, 6000, 300, 100, 0.001, 0.01, seed=5)
    return path


def count_argv(fastq, out, k, ascii_ingest):
    argv = ["count", fastq, "-k", str(k), "-o", str(out), "--capacity",
            str(1 << 15), "--batch", str(BATCH), "--length", str(LENGTH),
            "--merge-every", "2", "--device", "cpu"]
    return argv + (["--ascii-ingest"] if ascii_ingest else [])


def small_lookup(d):
    """(lookup step, tables, queries, valid) of a k = 21 table over a
    CPU mesh of d shards."""
    rng = np.random.default_rng(d)
    rows = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (32, 64))]
    m = tmesh.make_mesh(devices=["cpu"] * d)
    tables = pipeline.make_sharded_counter(m, 21, route_capacity=4096)(
        torch.from_numpy(np.ascontiguousarray(rows))).table
    step = pipeline.make_sharded_lookup(m, query_capacity=128, max_k=21)
    queries = torch.from_numpy(rng.integers(0, 1 << 42, 64))
    valid = torch.from_numpy(rng.random(64) < 0.9)
    return step, tables, queries, valid


# -- the tables of names ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(profiling.SPANS)
                         + sorted(profiling.COUNTERS))
def test_names_are_the_programs(name):
    """Every span and counter is the program's, ``kmers.`` first, and no
    span or counter takes a harness span's name (its readers count those
    spans)."""
    assert name.startswith("kmers.")
    assert name not in HARNESS_SPANS
    assert not (set(profiling.SPANS) & set(profiling.COUNTERS))
    table = profiling.SPANS if name in profiling.SPANS else profiling.COUNTERS
    assert table[name].strip()


# -- off ----------------------------------------------------------------------

class NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with no profiler")


def test_off_is_one_shared_no_op(monkeypatch):
    """With no profiler: span returns one shared no-op context (no new
    object), and neither span nor add calls record_function, reads a
    clock, takes the counters' lock or checks a name."""
    assert not torch.autograd.profiler._is_profiler_enabled
    before = profiling.counters()
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    monkeypatch.setattr(profiling, "time", NoClock())
    monkeypatch.setattr(profiling, "_counts_lock", None)
    first = profiling.span("kmers.emit")
    assert profiling.span("kmers.save.write") is first
    timed = profiling.span("kmers.ingest.parse",
                           wall_ns="kmers.ingest.parse_ns",
                           cpu_ns="kmers.ingest.parse_cpu_ns")
    assert timed is first
    assert profiling.span("not.a.span") is first
    with timed:
        profiling.add("kmers.ingest.batches", 5)
        profiling.add("not.a.counter")
    monkeypatch.undo()
    assert profiling.counters() == before


@pytest.mark.parametrize("ascii_ingest", [False, True])
def test_off_cli_count_records_nothing(monkeypatch, tmp_path, fastq,
                                       ascii_ingest):
    """A whole CLI count (emission, consolidation mid-stream and at the
    end, save, the parser thread) and a lookup step with no profiler:
    no record_function, and no counter moves."""
    before = profiling.counters()
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record_function)
    rc = cli.main(count_argv(fastq, tmp_path / "t.npz", 31, ascii_ingest))
    assert rc == 0
    step, tables, queries, valid = small_lookup(2)
    counts, overflow = step(tables, queries, valid)
    assert counts.shape == queries.shape and int(overflow) == 0
    assert profiling.counters() == before


@pytest.mark.parametrize("packed", [True, False])
def test_batch_upload_is_dropped_before_absorb(monkeypatch, packed):
    """The emission span's locals hold the batch's device copies no
    longer than the count: _absorb, which may consolidate, runs after
    they are gone, so a consolidation's peak holds no batch."""
    import weakref

    from kmers_tpu_torch.parallel import stream

    uploads, seen = [], []
    to_device = stream._to_device

    def recorded(*args):
        t = to_device(*args)
        uploads.append(weakref.ref(t))
        return t

    def absorb(self, res):
        seen.append([ref() is None for ref in uploads])
        uploads.clear()

    monkeypatch.setattr(stream, "_to_device", recorded)
    monkeypatch.setattr(stream.StreamingCounter, "_absorb", absorb)
    sc = stream.StreamingCounter(31, 1 << 12, device="cpu")
    rows = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(1).integers(0, 4, (8, LENGTH))]
    for _ in range(2):
        if packed:
            sc.update_packed(*fastx.pack_batch_np(rows))
        else:
            sc.update(rows)
    assert seen == [[True] * (2 if packed else 1)] * 2


# -- on -----------------------------------------------------------------------

@pytest.mark.parametrize("k, ascii_ingest", [(31, False), (31, True),
                                             (32, False), (63, False),
                                             (63, True)])
def test_cli_count_spans_and_counters(tmp_path, fastq, k, ascii_ingest):
    """Under a CPU profiler: one kmers.emit a batch holding one upload and
    one count and no consolidation (which follows it, mid-stream every
    two batches); sort (unit tables), merge and bound inside each
    kmers.consolidate; fetch and write inside kmers.save; a wait a batch
    (and one for the end); the ingest counters of this count's batches."""
    read = fastx.read_kmer_batches if ascii_ingest else \
        fastx.read_packed_batches
    n_batches = sum(1 for _ in read(fastq, k=k, batch=BATCH, length=LENGTH))
    assert n_batches >= 4
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        rc = cli.main(count_argv(fastq, tmp_path / "t.npz", k, ascii_ingest))
    assert rc == 0 and not torch.autograd.profiler._is_profiler_enabled
    after = profiling.counters()
    spans = user_spans(prof, tmp_path / "trace.json")

    emits = named(spans, "kmers.emit")
    assert len(emits) == n_batches
    for e in emits:
        assert len(within(spans, "kmers.emit.upload", e)) == 1
        assert len(within(spans, "kmers.emit.count", e)) == 1
        assert not within(spans, "kmers.consolidate", e)
    consolidations = named(spans, "kmers.consolidate")
    # every two batches, and the rest at save
    assert len(consolidations) == (n_batches + 1) // 2
    for c in consolidations:
        assert len(within(spans, "kmers.consolidate.sort", c)) == \
            (0 if k == 32 else 1)     # k = 32: run-length tables, merge_many
        assert len(within(spans, "kmers.consolidate.merge", c)) == 1
        assert len(within(spans, "kmers.consolidate.bound", c)) == 1
    assert len(named(spans, "kmers.consolidate.merge")) == len(consolidations)
    (save,) = named(spans, "kmers.save")
    assert len(within(spans, "kmers.save.fetch", save)) == 1
    assert len(within(spans, "kmers.save.write", save)) == 1
    assert not within(spans, "kmers.consolidate", save)
    assert len(named(spans, "kmers.ingest.wait")) == n_batches + 1
    assert not set(s[0] for s in spans) - set(profiling.SPANS)

    got = {name: after.get(name, 0) - before.get(name, 0)
           for name in profiling.COUNTERS}
    assert got["kmers.ingest.batches"] == n_batches
    assert 0 <= got["kmers.ingest.ready"] <= n_batches
    assert got["kmers.ingest.parse_ns"] > 0
    assert got["kmers.ingest.parse_cpu_ns"] >= 0


@pytest.mark.parametrize("d", [1, 2])
def test_lookup_step_spans(tmp_path, d):
    """Each call of make_sharded_lookup's step records route, answer and
    reply once, in that order and apart, and answers as it does with no
    profiler."""
    step, tables, queries, valid = small_lookup(d)
    want, want_ov = step(tables, queries, valid)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = [step(tables, queries, valid) for _ in range(3)]
    for counts, overflow in got:
        assert torch.equal(counts, want) and int(overflow) == int(want_ov)
    spans = user_spans(prof, tmp_path / "trace.json")
    phases = [named(spans, f"kmers.lookup.{p}")
              for p in ("route", "answer", "reply")]
    assert [len(p) for p in phases] == [3, 3, 3]
    for call in zip(*phases):
        assert call[0][2] <= call[1][1] + 1e-3
        assert call[1][2] <= call[2][1] + 1e-3


def test_counters_under_threads(monkeypatch):
    """More adding threads than cores, switching every microsecond: no
    update is lost (the counters' lock), and a snapshot is a copy."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    name, n_threads, n_adds = "kmers.ingest.ready", 32, 2000
    before = profiling.counters().get(name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def adder():
            for _ in range(n_adds):
                profiling.add(name)

        threads = [threading.Thread(target=adder) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.counters()
    assert snap[name] - before == n_threads * n_adds
    snap[name] = -1
    assert profiling.counters()[name] != -1
    with pytest.raises(KeyError):
        profiling.add("kmers.not_a_counter")
    with pytest.raises(KeyError):
        profiling.span("kmers.not_a_span")


def test_parse_span_keeps_the_interpreter_lock(monkeypatch, tmp_path):
    """The parser thread's timed span makes no record_function op call
    (whose entry and exit give the interpreter lock away, so that a
    thread beside a busy one waits a switch interval each time), yet
    shows in the trace and adds to its counters."""
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(torch.profiler, "record_function",
                            no_record_function)
        with profiling.span("kmers.ingest.parse",
                            wall_ns="kmers.ingest.parse_ns",
                            cpu_ns="kmers.ingest.parse_cpu_ns"):
            sum(range(20000))
        monkeypatch.undo()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert "kmers.ingest.parse" in names
    after = profiling.counters()
    assert after["kmers.ingest.parse_ns"] > before.get(
        "kmers.ingest.parse_ns", 0)


# -- profiling.trace ----------------------------------------------------------

def test_trace_records_every_thread_and_the_counters(tmp_path):
    """profiling.trace records a span on a second thread beside the main
    thread's, and writes what the block added to every counter."""
    logdir = tmp_path / "t"

    def parser():
        with profiling.span("kmers.ingest.parse",
                            wall_ns="kmers.ingest.parse_ns",
                            cpu_ns="kmers.ingest.parse_cpu_ns"):
            sum(range(20000))
        profiling.add("kmers.ingest.batches", 3)

    with profiling.trace(str(logdir)):
        with profiling.span("kmers.ingest.wait"):
            t = threading.Thread(target=parser)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    with open(logdir / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    tids = {e["name"]: e["tid"] for e in events}
    assert {"kmers.ingest.parse", "kmers.ingest.wait"} <= set(tids)
    assert tids["kmers.ingest.parse"] != tids["kmers.ingest.wait"]
    with open(logdir / "counters.json") as f:
        counts = json.load(f)
    assert set(counts) == set(profiling.COUNTERS)
    assert counts["kmers.ingest.batches"] == 3
    assert counts["kmers.ingest.parse_ns"] > 0
    assert counts["kmers.ingest.ready"] == 0
