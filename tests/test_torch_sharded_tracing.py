"""The sharded step's spans and counters (``kmers_tpu_torch.profiling``):
under a profiler each batch of ``ShardedStreamingCounter`` is one
``kmers.emit`` holding its split, windows, routing, exchange, unmix and
shard tables, and each consolidation follows the gather of the pending
shard tables; the routing counters follow from the send buffers' shapes,
on a one-process CPU mesh and on two gloo processes of two shards each;
with no profiler nothing is recorded; and a ``--devices 4`` CLI count
gives the ``--devices 1`` table and ``kmers_tpu``'s."""

import json

import numpy as np
import pytest
import torch

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu_torch import __main__ as cli
from kmers_tpu_torch import profiling
from kmers_tpu_torch.io import fastx, simulate
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                             npz_digest)

from test_torch_cli import run
from test_torch_multihost import finish, spawn
from test_torch_tracing import (inside, named, no_record_function,
                                user_spans, within)

BATCH, LENGTH, D = 64, 128, 4
#: the spans of one batch of the sharded step, each once inside its
#: kmers.emit (kmers.route.bucket: the owner sort, then each pass's send
#: buffers; kmers.route.unmix: the Feistel domain's, k <= 32 only)
ONCE = ("kmers.shard.split", "kmers.shard.windows", "kmers.route.exchange",
        "kmers.shard.table")
ROUTE = ["--devices", str(D), "--partition", "hash", "--route-capacity",
         "2048"]


@pytest.fixture
def fastq(tmp_path):
    path = str(tmp_path / "reads.fq")
    simulate.write_fastq(path, 6000, 300, 100, 0.001, 0.01, seed=11)
    return path


def count_argv(fastq, out, k=31, devices=ROUTE, extra=()):
    return (["count", fastq, "-k", str(k), "-o", str(out), "--capacity",
             str(1 << 15), "--batch", str(BATCH), "--length", str(LENGTH),
             "--merge-every", "2", "--device", "cpu"] + list(devices)
            + list(extra))


def counted(before: dict) -> dict:
    after = profiling.counters()
    return {name: after.get(name, 0) - before.get(name, 0)
            for name in profiling.COUNTERS}


def random_rows(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, LENGTH))]


# -- on -----------------------------------------------------------------------

@pytest.mark.parametrize("k, ascii_ingest", [(31, False), (31, True),
                                             (63, False)])
def test_sharded_cli_count_spans(tmp_path, fastq, k, ascii_ingest):
    """A --devices 4 CLI count under a CPU profiler: one kmers.emit a
    batch, holding one split, windows, exchange and shard-table span, the
    routing's bucket spans, one unmix at k <= 32 (none for 128-bit
    words, which travel unmixed) and no consolidation; one gather before
    each kmers.consolidate, outside every kmers.emit."""
    read = fastx.read_kmer_batches if ascii_ingest else \
        fastx.read_packed_batches
    n_batches = sum(1 for _ in read(fastq, k=k, batch=BATCH, length=LENGTH))
    assert n_batches >= 4
    extra = ["--ascii-ingest"] if ascii_ingest else []
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rc = cli.main(count_argv(fastq, tmp_path / "t.npz", k, extra=extra))
    assert rc == 0
    spans = user_spans(prof, tmp_path / "trace.json")
    emits = named(spans, "kmers.emit")
    assert len(emits) == n_batches
    for e in emits:
        for name in ONCE:
            assert len(within(spans, name, e)) == 1, name
        assert len(within(spans, "kmers.route.bucket", e)) >= 2
        assert len(within(spans, "kmers.route.unmix", e)) == (k <= 32)
        assert not within(spans, "kmers.consolidate", e)
    for name in ONCE + ("kmers.route.bucket", "kmers.route.unmix"):
        assert all(any(inside(s, e) for e in emits)
                   for s in named(spans, name)), name
    gathers = named(spans, "kmers.consolidate.gather")
    consolidations = named(spans, "kmers.consolidate")
    assert len(gathers) == len(consolidations) == (n_batches + 1) // 2
    for g, c in zip(gathers, consolidations):
        assert g[2] <= c[1] + 1e-3
        assert not any(inside(g, e) for e in emits)
    assert not set(s[0] for s in spans) - set(profiling.SPANS)
    assert counted(before)["kmers.route.exchanges"] == n_batches


#: bytes a routed lane takes in a send buffer: every plane and the mask
#: share the planes' dtype, int64 (an int64 word and its mask at k <= 31,
#: the hi and lo words and the mask past k = 32)
LANE_BYTES = {31: 2 * 8, 63: 3 * 8}


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("k", [31, 63])
def test_routing_counters_follow_the_shapes(k, passes):
    """On a one-process CPU mesh of D shards: one exchange a pass a
    batch; cross_bytes (D^2 - D) send-buffer rows of capacity lanes an
    exchange, recv_bytes_max D - 1 of them; the counts do not depend on
    the data."""
    capacity, n_batches = 512, 3
    sc = ShardedStreamingCounter(
        k, 1 << 16, merge_every=2, mesh=tmesh.make_mesh(devices=["cpu"] * D),
        route_capacity=capacity, route_passes=passes)
    rng = np.random.default_rng(k + passes)
    batches = [random_rows(rng, 32) for _ in range(n_batches)]
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for rows in batches:
            sc.update(rows)
        sc._consolidate()
    got = counted(before)
    exchanges = n_batches * passes
    row = capacity * LANE_BYTES[k]
    assert got["kmers.route.exchanges"] == exchanges
    assert got["kmers.route.cross_bytes"] == (D * D - D) * row * exchanges
    assert got["kmers.route.recv_bytes_max"] == (D - 1) * row * exchanges
    assert sc.route_overflow == 0


# -- off ----------------------------------------------------------------------

def test_off_sharded_count_records_nothing(monkeypatch, tmp_path, fastq):
    """A whole --devices 4 CLI count with no profiler: no
    record_function, and no counter moves."""
    before = profiling.counters()
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record_function)
    assert cli.main(count_argv(fastq, tmp_path / "t.npz")) == 0
    assert profiling.counters() == before


# -- the table ----------------------------------------------------------------

@pytest.mark.parametrize("ascii_ingest", [False, True])
def test_sharded_cli_count_is_the_one_device_table(tmp_path, fastq,
                                                   ascii_ingest):
    """--devices 4 --partition hash on four CPU shards writes the table of
    --devices 1 and of kmers_tpu's CLI over its four-device CPU mesh."""
    extra = ["--ascii-ingest"] if ascii_ingest else []
    d4, d1, j4 = (str(tmp_path / f"{n}.npz") for n in ("d4", "d1", "j4"))
    assert cli.main(count_argv(fastq, d4, extra=extra)) == 0
    assert cli.main(count_argv(fastq, d1, devices=(), extra=extra)) == 0
    argv = count_argv(fastq, j4, extra=extra)
    argv.remove("--device")
    argv.remove("cpu")
    rc, _, err = run(jax_main, argv)
    assert rc == 0, err
    assert npz_digest(d4) == npz_digest(d1) == npz_digest(j4)


# -- across processes ---------------------------------------------------------

TWO_PROCESSES = r"""
import json
import sys
import numpy as np
import torch
from kmers_tpu_torch import profiling
from kmers_tpu_torch.parallel import mesh
from kmers_tpu_torch.parallel.stream import ShardedStreamingCounter
arg = lambda name: sys.argv[sys.argv.index(name) + 1]
rank = int(arg("--rank"))
mesh.init_distributed(arg("--init"), 2, rank, timeout=60)
m = mesh.make_mesh(devices=["cpu"] * 2)
sc = ShardedStreamingCounter(31, 1 << 16, merge_every=2, mesh=m,
                             route_capacity=512)
rng = np.random.default_rng(7)
rows = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (3, 32, 64))]
with profiling.trace(arg("--out") + f".rank{rank}"):
    for batch in rows:
        sc.update(batch[mesh.local_read_slice(32)])
    sc._consolidate()
print("RESULT", json.dumps({"overflow": sc.route_overflow,
                            "n_unique": sc.table.n_unique}))
"""


def test_routing_counters_across_processes(tmp_path):
    """Two gloo processes of two CPU shards each (D = 4): each counts its
    own senders' rows, one all_to_all_single an exchange, and records
    its spans; both hold the same table."""
    done = finish(spawn(["-c", TWO_PROCESSES, "--out", str(tmp_path / "t")],
                        tmp_path, "counters"), timeout=180)
    results = []
    for rank, (rc, text) in enumerate(done):
        assert rc == 0, text[-3000:]
        results.append(json.loads(text.split("RESULT ")[-1]))
        logdir = tmp_path / f"t.rank{rank}"
        with open(logdir / "counters.json") as f:
            got = json.load(f)
        row = 512 * LANE_BYTES[31]
        assert got["kmers.route.exchanges"] == 3
        assert got["kmers.route.cross_bytes"] == 2 * (D - 1) * row * 3
        assert got["kmers.route.recv_bytes_max"] == (D - 1) * row * 3
        with open(logdir / "trace.json") as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"]
        for name in ("kmers.emit",) + ONCE + ("kmers.route.unmix",):
            assert names.count(name) == 3, name
        assert names.count("kmers.consolidate.gather") == 2
    assert results[0] == results[1]
    assert results[0]["overflow"] == 0 and results[0]["n_unique"] > 0
