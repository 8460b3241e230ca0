"""The port's two-axis mesh against the JAX package, on the CPU: a
one-process mesh of CPU shards built by ``make_mesh(devices=...,
seq_shards=s)`` against kmers_tpu's ``make_mesh(n, seq_shards=s)`` on the
8 host devices of tests/conftest.py, at (d, s) = (2, 2) and (2, 4).
Every sharded factory runs over one axis; each local shard's table must be
JAX's table at the shard's index along that axis, lane for lane (so the
replicas over the other axis are equal), and every metric JAX's psum over
the axis.  Also the mesh's own functions: the shape, batch_sharding's
replication over "s", process_local_batch's divisor, and the errors.
Exact integers, zero tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel.stream import ShardedStreamingCounter

from test_torch_hash import as_u32, jax_u64
from test_torch_kmer import make_reads
from test_torch_sharded_wide import jax_planes

SHAPES = [(2, 2), (2, 4)]
K, W = 21, 7
ROUTE = 512


@pytest.fixture(scope="module")
def reads():
    return make_reads(2024, 16, 128)


@pytest.fixture(scope="module")
def contig():
    rng = np.random.default_rng(77)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1024)]
    seq[[255, 256, 513, 770]] = ord("N")
    return seq


def meshes(shape):
    d, s = shape
    return (jmesh.make_mesh(d * s, seq_shards=s),
            tmesh.make_mesh(devices=["cpu"] * (d * s), seq_shards=s))


def put(jm, a, axis):
    return jax.device_put(jnp.asarray(a), NamedSharding(jm, P(axis)))


def assert_tables(jt, tables, tm, axis):
    """Each local shard's table is JAX's at the shard's index along axis:
    every key plane, and the counts and n_unique of a compact table."""
    n = tm.shape[axis]
    planes = [np.asarray(p).reshape(n, -1) for p in jax_planes(jt)]
    assert len(tables) == tm.n_local
    for t, pos in zip(tables, tmesh.axis_positions(tm, axis)):
        assert len(t.keys) == len(planes)
        for jp, tp in zip(planes, t.keys):
            np.testing.assert_array_equal(as_u32(tp).reshape(-1), jp[pos])
        if hasattr(jt, "counts"):
            np.testing.assert_array_equal(
                t.counts.numpy(), np.asarray(jt.counts).reshape(n, -1)[pos])
            assert t.n_unique == int(np.asarray(jt.n_unique).reshape(-1)[pos])


def assert_metrics(jmetrics, tmetrics):
    assert set(jmetrics) == set(tmetrics)
    for name, value in jmetrics.items():
        assert int(tmetrics[name]) == int(value), name


def same_tables(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.keys, b.keys)) and (
        not hasattr(a, "counts") or (torch.equal(a.counts, b.counts)
                                     and a.n_unique == b.n_unique))


@pytest.mark.parametrize("k", [K, 63])
@pytest.mark.parametrize("axis", ["d", "s"])
@pytest.mark.parametrize("shape", SHAPES)
def test_hash_counter_over_an_axis_matches_jax(reads, shape, axis, k):
    """make_sharded_counter (k = 21) and make_sharded_counter_wide
    (k = 63) over one axis: the shard tables and metrics of JAX's run, and
    those of the port's one-axis run over as many shards as the axis."""
    jm, tm = meshes(shape)
    jmake, tmake = ((jpipe.make_sharded_counter, tpipe.make_sharded_counter)
                    if k <= 32 else (jpipe.make_sharded_counter_wide,
                                     tpipe.make_sharded_counter_wide))
    jres = jmake(jm, k, route_capacity=ROUTE, axis=axis)(
        put(jm, reads, axis))
    tres = tmake(tm, k, route_capacity=ROUTE, axis=axis)(
        torch.from_numpy(reads))
    assert_tables(jres.table, tres.table, tm, axis)
    assert_metrics(jres.metrics, tres.metrics)
    assert int(tres.metrics["route_overflow"]) == 0
    flat = tmake(tmesh.make_mesh(devices=["cpu"] * tm.shape[axis]), k,
                 route_capacity=ROUTE)(torch.from_numpy(reads))
    for t, pos in zip(tres.table, tmesh.axis_positions(tm, axis)):
        assert same_tables(t, flat.table[pos])
    assert_metrics(flat.metrics, tres.metrics)


@pytest.mark.parametrize("shape", SHAPES)
def test_minimizer_counter_over_s_matches_jax(reads, shape):
    jm, tm = meshes(shape)
    kw = dict(route_capacity=ROUTE, route_passes=2, axis="s")
    jres = jpipe.make_sharded_minimizer_counter(jm, K, W, **kw)(
        put(jm, reads, "s"))
    tres = tpipe.make_sharded_minimizer_counter(tm, K, W, **kw)(
        torch.from_numpy(reads))
    assert_tables(jres.table, tres.table, tm, "s")
    assert_metrics(jres.metrics, tres.metrics)


@pytest.mark.parametrize("shape", SHAPES)
def test_superkmer_counter_over_s_matches_jax(reads, shape):
    """The minimizer partition's unit shard tables (routed lane order)
    and metrics, the prefilter's budget taken over the axis's shards."""
    jm, tm = meshes(shape)
    jres = jpipe.make_superkmer_counter(jm, K, W, route_capacity=128,
                                        axis="s")(put(jm, reads, "s"))
    tres = tpipe.make_superkmer_counter(tm, K, W, route_capacity=128,
                                        axis="s")(torch.from_numpy(reads))
    assert_tables(jres.table, tres.table, tm, "s")
    assert_metrics(jres.metrics, tres.metrics)
    assert int(tres.metrics["route_overflow"]) == 0


@pytest.mark.parametrize("k", [K, 63])
@pytest.mark.parametrize("shape", SHAPES)
def test_sequence_parallel_over_s_matches_jax(contig, shape, k):
    """One contig split over "s" (Ns beside the cuts), the halo exchanged
    inside each group: the shard tables and the three metrics."""
    jm, tm = meshes(shape)
    cap = contig.shape[0] // tm.shape["s"]
    jres = jpipe.make_sequence_parallel_counter(
        jm, k, route_capacity=cap, axis="s")(put(jm, contig, "s"))
    tres = tpipe.make_sequence_parallel_counter(
        tm, k, route_capacity=cap, axis="s")(torch.from_numpy(contig))
    assert_tables(jres.table, tres.table, tm, "s")
    assert_metrics(jres.metrics, tres.metrics)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lookup_over_d_matches_jax(reads, shape, merge):
    """Every window of the batch asked of the "d" counter's shard tables,
    at both answer arms (JAX's merge in interpret mode): the answers (-1
    on invalid lanes) and the overflow; global_table over one group of
    the replicated tables is the single-device table."""
    jm, tm = meshes(shape)
    jres = jpipe.make_sharded_counter(jm, K, route_capacity=ROUTE,
                                      axis="d")(put(jm, reads, "d"))
    tres = tpipe.make_sharded_counter(tm, K, route_capacity=ROUTE,
                                      axis="d")(torch.from_numpy(reads))
    words, valid = tpipe.canonical_kmers(torch.from_numpy(reads), K)
    words, valid = words.reshape(-1), valid.reshape(-1)
    q = jax_u64(words.numpy().view(np.uint64))
    counts, overflow = jpipe.make_sharded_lookup(
        jm, query_capacity=1024, axis="d", max_k=K, merge_lookup=merge,
        interpret=True)(
            jres.table, put(jm, q.hi, "d"), put(jm, q.lo, "d"),
            put(jm, valid.numpy(), "d"))
    got, tover = tpipe.make_sharded_lookup(
        tm, query_capacity=1024, axis="d", max_k=K, merge_lookup=merge)(
            tres.table, words, valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(counts))
    assert int(tover) == int(overflow) == 0
    assert (got == -1).sum() == (~valid).sum()
    whole = tpipe.global_table(tres, tm, "d")
    flat = tpipe.count_reads(torch.from_numpy(reads), K).table
    assert same_tables(whole, flat)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_shape_and_groups(shape):
    d, s = shape
    jm, tm = meshes(shape)
    assert tm.axis_names == jm.axis_names == ("d", "s")
    assert tm.shape == dict(jm.shape) == {"d": d, "s": s}
    assert (tm.n_shards, tm.n_local) == (d * s, d * s)
    assert tmesh.axis_positions(tm, "d") == [g // s for g in range(d * s)]
    assert tmesh.axis_positions(tm, "s") == [g % s for g in range(d * s)]
    over_d = tmesh.axis_groups(tm, "d")
    assert [g.local for g in over_d] == [
        tuple(range(o, d * s, s)) for o in range(s)]
    assert [g.local for g in tmesh.axis_groups(tm, "s")] == [
        tuple(range(o * s, (o + 1) * s)) for o in range(d)]
    for g in over_d:
        assert g.mesh.axis_names == ("d",) and g.mesh.n_shards == d
    # a one-axis mesh is unchanged: one group, the mesh itself
    flat = tmesh.make_mesh(devices=["cpu"] * 4)
    assert (flat.axis_names, flat.shape) == (("d",), {"d": 4})
    assert tmesh.axis_groups(flat) == [(flat, (0, 1, 2, 3))]


@pytest.mark.parametrize("axis", ["d", "s"])
@pytest.mark.parametrize("shape", SHAPES)
def test_batch_sharding_splits_over_one_axis(shape, axis):
    """Each local shard's rows are those JAX's device at its place holds
    under P(axis): split over the axis, replicated over the other."""
    jm, tm = meshes(shape)
    rows = np.arange(16 * 3, dtype=np.uint8).reshape(16, 3)
    x = put(jm, rows, axis)
    want = {s.device.id: np.asarray(s.data) for s in x.addressable_shards}
    got = tmesh.batch_sharding(torch.from_numpy(rows), tm, axis)
    flat_ids = [dev.id for dev in jm.devices.reshape(-1)]
    for g, block in enumerate(got):
        np.testing.assert_array_equal(block.numpy(), want[flat_ids[g]])
    if axis == "d":
        glob = tmesh.make_global_array(rows, tm)
        assert isinstance(glob, tmesh.ShardedRows)
        assert all(torch.equal(a, b) for a, b in zip(glob, got))


@pytest.mark.parametrize("shape", SHAPES)
def test_process_local_batch_divides_by_d(shape):
    """The rows a shard takes of a global batch: ceil(B / d), not
    ceil(B / (d s))."""
    jm, tm = meshes(shape)
    for batch in (10, 16, 1):
        assert (tmesh.process_local_batch(batch, tm)
                == jmesh.process_local_batch(batch, jm)
                == -(-batch // shape[0]))
    assert tmesh.process_local_batch(10, tm) != -(-10 // tm.n_shards)


def test_seq_shards_must_divide_the_devices():
    with pytest.raises(ValueError, match="not divisible by seq_shards"):
        jmesh.make_mesh(6, seq_shards=4)
    with pytest.raises(ValueError, match="not divisible by seq_shards"):
        tmesh.make_mesh(devices=["cpu"] * 6, seq_shards=4)


FACTORIES = {
    "counter": lambda m, axis: tpipe.make_sharded_counter(
        m, K, route_capacity=8, axis=axis),
    "counter_wide": lambda m, axis: tpipe.make_sharded_counter_wide(
        m, 63, route_capacity=8, axis=axis),
    "sequence_parallel": lambda m, axis: tpipe.make_sequence_parallel_counter(
        m, K, route_capacity=8, axis=axis),
    "minimizer": lambda m, axis: tpipe.make_sharded_minimizer_counter(
        m, K, W, route_capacity=8, axis=axis),
    "superkmer": lambda m, axis: tpipe.make_superkmer_counter(
        m, K, W, route_capacity=8, axis=axis),
    "lookup": lambda m, axis: tpipe.make_sharded_lookup(
        m, query_capacity=8, axis=axis),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_an_axis_the_mesh_lacks_raises(name):
    two = tmesh.make_mesh(devices=["cpu"] * 4, seq_shards=2)
    one = tmesh.make_mesh(devices=["cpu"] * 4)
    for m, axis in ((two, "x"), (one, "s")):
        with pytest.raises(ValueError, match="axis"):
            FACTORIES[name](m, axis)


def test_one_axis_functions_refuse_a_two_axis_mesh():
    """The collectives and the streaming counter run over one axis; a
    two-axis mesh takes them group by group."""
    two = tmesh.make_mesh(devices=["cpu"] * 4, seq_shards=2)
    x = [torch.zeros(4, dtype=torch.int64) for _ in two]
    for call in (lambda: tmesh.all_to_all(x, two),
                 lambda: tmesh.psum([v.sum() for v in x], two),
                 lambda: tmesh.gather(x, two),
                 lambda: tmesh.shift_left(x, two),
                 lambda: ShardedStreamingCounter(21, 64, mesh=two,
                                                 route_capacity=8)):
        with pytest.raises(ValueError, match="one-axis"):
            call()
