"""The port's multi-process mesh against the JAX package, on the CPU: two
gloo processes of kmers_tpu_torch.dryrun, with two CPU shards each
(D = 4) and with one (D = 2), every sharded pipeline's shard tables,
metrics and lookup answers held lane for lane against kmers_tpu's
one-process D-shard run on the 8-device CPU mesh of tests/conftest.py (the
same seeded inputs, capacities and seeds), the sequence-parallel tables
across the cut between the processes, and the streaming tables at
k = 31, 32, 63 and 64 against the port's one-process D-shard counter
(npz_digest) and kmers_tpu's (to_pairs); and a two-axis (2, 2) mesh
over two processes, the hash and sequence-parallel counters over each
axis against kmers_tpu's one-process (2, 2) run.  Exact integers, zero
tolerance.  Every spawn runs under a timeout, and every process group
under a 60 s one, so that a hang fails a test instead of the suite."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu.parallel.stream import ShardedStreamingCounter as JaxSharded
from kmers_tpu_torch import dryrun
from kmers_tpu_torch.io.fastx import pack_batch_np
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                             StreamingCounter, npz_digest)

from test_torch_hash import jax_u64
from test_torch_sharded_wide import jax_planes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_SHARDS = {4: 2, 2: 1}         # D -> shards a process, two processes
SPAWN_TIMEOUT = 300                 # seconds a worker may take
GROUP_TIMEOUT = 60                  # the process group's, each collective's


def start(cmd, tmp, name):
    """`python <cmd>` with its output in tmp/<name>.log (a file, not a
    pipe: a rank blocked on a full pipe would stall the other's
    collectives).  Returns (process, log path)."""
    log = tmp / f"{name}.log"
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable] + cmd, cwd=ROOT, env=env,
                                stdout=f, stderr=subprocess.STDOUT), log


def spawn(args, tmp, name):
    """Two ranks of `python <args>` over a file:// store in tmp."""
    store = f"file://{tmp / (name + '.store')}"
    return [start(args + ["--rank", str(r), "--world", "2", "--init", store],
                  tmp, f"{name}.rank{r}") for r in (0, 1)]


def finish(procs, timeout=SPAWN_TIMEOUT):
    """Every process's (exit code, output); kills them all on expiry."""
    deadline = time.time() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a worker ran past {timeout} s")
    return [(p.returncode, log.read_text()) for p, log in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (rank 0's arrays, rank 1's arrays, reports, out dir)}: both
    configurations spawned at once, four processes."""
    tmp = tmp_path_factory.mktemp("multihost")
    procs = {}
    for d, local in LOCAL_SHARDS.items():
        out = tmp / f"d{d}"
        procs[d] = (out, spawn(
            ["-m", "kmers_tpu_torch.dryrun", "--device", "cpu",
             "--local-shards", str(local), "--timeout", str(GROUP_TIMEOUT),
             "--out", str(out)], tmp, f"d{d}"))
    result = {}
    for d, (out, ps) in procs.items():
        done = finish(ps)
        for rc, text in done:
            assert rc == 0, text[-3000:]
        reports = [json.loads(text.strip().splitlines()[-1])
                   for _, text in done]
        arrays = [dict(np.load(out / f"dryrun.rank{r}.npz")) for r in (0, 1)]
        result[d] = (arrays[0], arrays[1], reports, out)
    return result


@pytest.fixture(scope="module")
def data():
    return dryrun.inputs(0)


def put(jm, a):
    return jax.device_put(jnp.asarray(a), jmesh.batch_sharding(jm))


def assert_shards(z, prefix, jt, d):
    """Every shard's planes lane for lane, counts and n_unique."""
    planes = jax_planes(jt)
    assert sum(f.startswith(f"{prefix}_keys") for f in z) == len(planes)
    for i, jp in enumerate(planes):
        np.testing.assert_array_equal(
            z[f"{prefix}_keys{i}"].view(np.uint32).reshape(d, -1),
            np.asarray(jp).reshape(d, -1))
    if hasattr(jt, "counts"):
        np.testing.assert_array_equal(z[f"{prefix}_counts"].reshape(d, -1),
                                      np.asarray(jt.counts).reshape(d, -1))
        np.testing.assert_array_equal(z[f"{prefix}_n_unique"],
                                      np.asarray(jt.n_unique))


def assert_metrics(z, prefix, metrics):
    names = {f[len(prefix) + 3:] for f in z if f.startswith(f"{prefix}_m_")}
    assert names == set(metrics)
    for name, value in metrics.items():
        assert int(z[f"{prefix}_m_{name}"]) == int(value), name


@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_both_ranks_pass_every_check_and_hold_one_result(runs, d):
    """Each rank's own checks against the independent counts, the same
    arrays on both ranks (gathered shard tables, psum'd metrics), and the
    global mesh's shape."""
    z0, z1, reports, _ = runs[d]
    assert sorted(z0) == sorted(z1)
    for name in z0:
        np.testing.assert_array_equal(z0[name], z1[name], err_msg=name)
    for r, rep in enumerate(reports):
        assert (rep["rank"], rep["processes"], rep["shards"]) == (r, 2, d)
        assert len(rep["checks"]) == 12
    assert reports[0]["digests"] == reports[1]["digests"]


@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_sharded_count_matches_jax(runs, data, d):
    """Scenario A: make_sharded_counter at k = 21, compact and unit shard
    tables (the unit ones keep the routed lane order: pass, global
    sender, lane) and every metric."""
    z = runs[d][0]
    jm = jmesh.make_mesh(d)
    reads = put(jm, data["reads"])
    for prefix, aggregate in (("count", "compact"), ("unit", "unit")):
        jres = jpipe.make_sharded_counter(jm, dryrun.K, aggregate=aggregate,
                                          **dryrun.COUNT)(reads)
        assert_shards(z, prefix, jres.table, d)
        assert_metrics(z, prefix, jres.metrics)
    assert int(z["count_m_route_overflow"]) == 0


@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_minimizer_and_superkmer_counters_match_jax(runs, data, d):
    """Scenario C: minimizer bucketing (k = 21, w = 7) and the super-k-mer
    counter, shard by shard and metric by metric."""
    z = runs[d][0]
    jm = jmesh.make_mesh(d)
    reads = put(jm, data["reads"])
    jres = jpipe.make_sharded_minimizer_counter(jm, dryrun.K, dryrun.W,
                                                **dryrun.MINIMIZER)(reads)
    assert_shards(z, "mini", jres.table, d)
    assert_metrics(z, "mini", jres.metrics)
    jres = jpipe.make_superkmer_counter(jm, dryrun.K, dryrun.W,
                                        **dryrun.SUPERKMER)(reads)
    assert_shards(z, "superkmer", jres.table, d)
    assert_metrics(z, "superkmer", jres.metrics)


@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_sharded_lookup_matches_jax(runs, data, d):
    """Scenario D: every window of the batch asked of the count's shard
    tables, each process its own rows; answers and overflow."""
    z = runs[d][0]
    jm = jmesh.make_mesh(d)
    jres = jpipe.make_sharded_counter(jm, dryrun.K, **dryrun.COUNT)(
        put(jm, data["reads"]))
    words, valid = tpipe.canonical_kmers(torch.from_numpy(data["reads"]),
                                         dryrun.K)
    q = jax_u64(words.numpy().view(np.uint64).reshape(-1))
    shape = dryrun.READS
    counts, overflow = jpipe.make_sharded_lookup(
        jm, query_capacity=dryrun.QUERY_CAPACITY)(
            jres.table, put(jm, q.hi.reshape(shape)),
            put(jm, q.lo.reshape(shape)), put(jm, valid.numpy()))
    np.testing.assert_array_equal(z["lookup_answers"], np.asarray(counts))
    assert int(z["lookup_overflow"]) == int(overflow) == 0
    assert (z["lookup_answers"] == -1).sum() == (~valid.numpy()).sum()


@pytest.mark.parametrize("k", dryrun.SEQ_KS)
@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_sequence_parallel_across_processes_matches_jax(runs, data, d, k):
    """One contig split over both processes, an N beside the cut between
    them: per-shard compact tables and the three metrics."""
    z = runs[d][0]
    jm = jmesh.make_mesh(d)
    jres = jpipe.make_sequence_parallel_counter(
        jm, k, route_capacity=dryrun.CONTIG // d)(put(jm, data["contig"]))
    assert_shards(z, f"seq{k}", jres.table, d)
    assert_metrics(z, f"seq{k}", jres.metrics)
    assert data["contig"][dryrun.CONTIG // 2 + 1] == ord("N")


@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_sequence_parallel_blocks_shorter_than_the_halo_match_jax(runs, data,
                                                                  d):
    """A 40-base contig at k = 17: at D = 4 each block (10 bases) is
    shorter than the halo, a window across two cuts is never formed, and
    the block that ships all of itself crosses the processes' cut; the
    shard tables and metrics are JAX's all the same."""
    z = runs[d][0]
    jm = jmesh.make_mesh(d)
    g, k = dryrun.SHORT["length"], dryrun.SHORT["k"]
    jres = jpipe.make_sequence_parallel_counter(jm, k, route_capacity=g // d)(
        put(jm, data["short"]))
    assert_shards(z, "short", jres.table, d)
    assert_metrics(z, "short", jres.metrics)
    assert (g // d < k - 1) == (d == 4)


def one_process_digest(d, k, batches, tmp_path):
    """The port's one-process D-shard streaming counter's checkpoint."""
    sc = ShardedStreamingCounter(
        k, dryrun.STREAM["capacity"], merge_every=dryrun.STREAM["merge_every"],
        mesh=tmesh.make_mesh(devices=["cpu"] * d),
        route_capacity=dryrun.STREAM["route_capacity"])
    for b in batches:
        if k in dryrun.PACKED_KS:
            sc.update_packed(*pack_batch_np(b))
        else:
            sc.update(b)
    path = str(tmp_path / f"one_k{k}.npz")
    sc.save(path)
    return npz_digest(path)


@pytest.mark.parametrize("k", dryrun.STREAM_KS)
@pytest.mark.parametrize("d", sorted(LOCAL_SHARDS))
def test_streaming_counter_across_processes(runs, data, d, k, tmp_path):
    """ShardedStreamingCounter fed each process's slice of three batches
    (the last one row, so rank 1's slice is empty): both ranks save the
    one-process counter's table, its pairs are kmers_tpu's, and the
    committed route counters are kmers_tpu's."""
    z, _, reports, out = runs[d]
    batches = dryrun.stream_batches(data["stream"])
    want = one_process_digest(d, k, batches, tmp_path)
    for r in (0, 1):
        assert npz_digest(str(out / f"stream_k{k}.rank{r}.npz")) == want
        assert reports[r]["digests"][str(k)] == want
    j = JaxSharded(k, capacity=dryrun.STREAM["capacity"],
                   merge_every=dryrun.STREAM["merge_every"], n_devices=d,
                   route_capacity=dryrun.STREAM["route_capacity"])
    for b in batches:
        if k in dryrun.PACKED_KS:
            j.update_packed(*pack_batch_np(b))
        else:
            j.update(b)
    got = StreamingCounter.load(str(out / f"stream_k{k}.rank0.npz"),
                                device="cpu")
    assert got.to_pairs() == j.to_pairs()
    assert (int(z[f"stream{k}_kmers"]), int(z[f"stream{k}_batches"])) == (
        j.kmers, j.batches) == (got.kmers, 3)
    assert int(z[f"stream{k}_route_overflow"]) == j.route_overflow == 0
    assert int(z[f"stream{k}_route_rerouted"]) == j.route_rerouted


# -- the process group's edges -------------------------------------------------------

UNEQUAL = r"""
import sys
from kmers_tpu_torch.parallel import mesh
rank = int(sys.argv[sys.argv.index("--rank") + 1])
mesh.init_distributed(sys.argv[sys.argv.index("--init") + 1], 2, rank,
                      timeout=60)
assert (mesh.process_count(), mesh.process_index()) == (2, rank)
try:
    mesh.make_mesh(devices=["cpu"] * (rank + 1))
except ValueError as e:
    print("VALUE-ERROR", e)
"""


def test_unequal_local_shards_raise(tmp_path):
    """make_mesh refuses processes with different local shard counts, on
    every process."""
    for rc, text in finish(spawn(["-c", UNEQUAL], tmp_path, "unequal"),
                           timeout=120):
        assert rc == 0 and "VALUE-ERROR" in text, text[-2000:]


def test_missing_peer_fails_within_the_group_timeout(tmp_path):
    """One rank of two alone: the rendezvous gives up after the group's
    timeout and the worker exits non-zero instead of hanging."""
    rc, text = finish([start(
        ["-m", "kmers_tpu_torch.dryrun", "--device", "cpu", "--rank", "0",
         "--world", "2", "--timeout", "5", "--init",
         f"file://{tmp_path / 'alone.store'}"], tmp_path, "alone")],
        timeout=120)[0]
    assert rc != 0, text[-2000:]


# -- a two-axis mesh across the processes --------------------------------------------

MESH2D = r"""
import sys
import numpy as np
import torch
from kmers_tpu_torch import dryrun
from kmers_tpu_torch.parallel import mesh, pipeline
arg = lambda name: sys.argv[sys.argv.index(name) + 1]
rank = int(arg("--rank"))
mesh.init_distributed(arg("--init"), 2, rank, timeout=60)
m = mesh.make_mesh(devices=["cpu"] * 2, seq_shards=2)
data, out = dryrun.inputs(0), {}


def part(x, axis):
    # this process's rows along the axis: the blocks of its shards' indices
    pos = mesh.axis_positions(m, axis)
    per = x.shape[0] // m.shape[axis]
    return torch.from_numpy(x[min(pos) * per:(max(pos) + 1) * per])


for axis in ("d", "s"):
    for name, res in (
            ("count", pipeline.make_sharded_counter(
                m, dryrun.K, axis=axis, **dryrun.COUNT)(
                    part(data["reads"], axis))),
            ("seq", pipeline.make_sequence_parallel_counter(
                m, dryrun.SEQ_KS[0], route_capacity=dryrun.CONTIG // 2,
                axis=axis)(part(data["contig"], axis)))):
        for local, t in enumerate(res.table):
            key = f"{name}_{axis}_{local}"
            for i, plane in enumerate(t.keys):
                out[f"{key}_keys{i}"] = plane.numpy()
            out[f"{key}_counts"] = t.counts.numpy()
            out[f"{key}_n_unique"] = t.n_unique
        for metric, value in res.metrics.items():
            out[f"{name}_{axis}_m_{metric}"] = int(value)
np.savez(arg("--out") + f".rank{rank}.npz", **out)
print("MESH2D", [len(mesh.axis_groups(m, a)) for a in ("d", "s")],
      [g.mesh.process_count for a in ("d", "s") for g in mesh.axis_groups(m, a)])
"""


@pytest.fixture(scope="module")
def mesh2d(tmp_path_factory):
    """Two ranks of two CPU shards each on a global (2, 2) mesh: rank r's
    arrays and output.  Over "d" every group spans both processes, over
    "s" each group lies inside one."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    done = finish(spawn(["-c", MESH2D, "--out", str(tmp / "m")], tmp,
                        "mesh2d"), timeout=180)
    for rc, text in done:
        assert rc == 0, text[-3000:]
    return [(dict(np.load(tmp / f"m.rank{r}.npz")), done[r][1])
            for r in (0, 1)]


@pytest.mark.parametrize("name", ["count", "seq"])
@pytest.mark.parametrize("axis", ["d", "s"])
def test_two_axis_mesh_across_processes_matches_jax(mesh2d, data, axis,
                                                    name):
    """The hash counter (k = 21) and the sequence-parallel counter
    (k = 31) over each axis of a (2, 2) mesh of two processes: every
    local shard holds JAX's one-process (2, 2) table at its index along
    the axis, and both ranks hold JAX's psum'd metrics."""
    jm = jmesh.make_mesh(4, seq_shards=2)
    put2 = lambda a: jax.device_put(jnp.asarray(a),
                                    NamedSharding(jm, PartitionSpec(axis)))
    if name == "count":
        jres = jpipe.make_sharded_counter(jm, dryrun.K, axis=axis,
                                          **dryrun.COUNT)(put2(data["reads"]))
    else:
        jres = jpipe.make_sequence_parallel_counter(
            jm, dryrun.SEQ_KS[0], route_capacity=dryrun.CONTIG // 2,
            axis=axis)(put2(data["contig"]))
    planes = [np.asarray(p).reshape(2, -1) for p in jax_planes(jres.table)]
    counts = np.asarray(jres.table.counts).reshape(2, -1)
    n_unique = np.asarray(jres.table.n_unique).reshape(-1)
    for rank, (z, out) in enumerate(mesh2d):
        assert out.strip().splitlines()[-1] == "MESH2D [2, 1] [2, 2, 1]"
        for local in (0, 1):
            g = 2 * rank + local
            pos = g // 2 if axis == "d" else g % 2
            key = f"{name}_{axis}_{local}"
            for i, jp in enumerate(planes):
                np.testing.assert_array_equal(
                    z[f"{key}_keys{i}"].view(np.uint32), jp[pos])
            np.testing.assert_array_equal(z[f"{key}_counts"], counts[pos])
            assert int(z[f"{key}_n_unique"]) == int(n_unique[pos])
        assert_metrics(z, f"{name}_{axis}", jres.metrics)
        assert int(z[f"{name}_{axis}_m_route_overflow"]) == 0


# -- one process: no process group ---------------------------------------------------

def test_without_a_process_group_the_mesh_is_one_process():
    assert (tmesh.process_count(), tmesh.process_index()) == (1, 0)
    assert tmesh.local_read_slice(10) == slice(0, 10)
    m = tmesh.make_mesh(devices=["cpu"] * 3)
    assert (m.n_shards, m.n_local, m.process_count, m.process_index) == (
        3, 3, 1, 0)
    assert m == (torch.device("cpu"),) * 3
    assert tmesh.process_local_batch(7, m) == 3
    rows = tmesh.make_global_array(np.arange(12, dtype=np.uint32)
                                   .reshape(6, 2), m)
    assert [b[:, 0].tolist() for b in rows] == [[0, 2], [4, 6], [8, 10]]
    assert rows[0].dtype == torch.int32
    assert tmesh.batch_sharding(rows, m) == list(rows)
    with pytest.raises(ValueError):
        tmesh.batch_sharding(rows, tmesh.make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(2, devices=["cpu"] * 3)


@pytest.mark.parametrize("index,batch,want", [
    (0, 16, (0, 8)), (1, 16, (8, 16)), (0, 5, (0, 3)), (1, 5, (3, 5)),
    (0, 1, (0, 1)), (1, 1, (1, 1))])
def test_local_read_slice_splits_a_batch_over_processes(monkeypatch, index,
                                                        batch, want):
    """Contiguous ceil(B / P) rows a process, the last one's shorter or
    empty (kmers_tpu/parallel/mesh.py:74-79)."""
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    monkeypatch.setattr(tmesh, "process_index", lambda: index)
    assert tmesh.local_read_slice(batch) == slice(*want)


def test_global_table_needs_the_mesh_under_a_process_group(monkeypatch):
    """A multi-process result merged without its mesh would be a part of
    the table: global_table raises instead."""
    m = tmesh.make_mesh(devices=["cpu"] * 2)
    res = tpipe.make_sharded_counter(m, 5, route_capacity=64)(
        torch.from_numpy(np.frombuffer(b"ACGTACGGTCA" * 2, np.uint8)
                         .reshape(2, 11).copy()))
    assert int(tpipe.global_table(res).counts.sum()) == 14
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="mesh"):
        tpipe.global_table(res)


def test_an_empty_slice_still_steps(tmp_path):
    """A process whose slice of a batch is empty pads to one row a local
    shard: the batch counts, and no k-mer comes of it."""
    m = tmesh.make_mesh(devices=["cpu"] * 2)
    sc = ShardedStreamingCounter(21, 1024, mesh=m, route_capacity=64)
    sc.update(np.zeros((0, 64), np.uint8))
    sc.update_packed(*pack_batch_np(np.zeros((0, 64), np.uint8)))
    assert (sc.batches, sc.kmers, sc.to_pairs()) == (2, 0, [])
