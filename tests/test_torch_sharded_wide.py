"""The port's sharded layer past k = 31 against the JAX package, on the
CPU: owner_of_wide and route_wide, the wide sharded counter at
33 <= k <= 64, make_sharded_counter at k = 32, and
ShardedStreamingCounter at k = 32, 41, 63 and 64 (the port's mesh of 8
CPU shards against kmers_tpu's 8-device CPU mesh from tests/conftest.py,
the same capacities, passes and seeds), shard by shard and metric by
metric.  Everything is bit-exact: zero tolerance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kmers_tpu.core.u64 import U64
from kmers_tpu.core.u128 import U128
from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu.parallel import route as jroute
from kmers_tpu.parallel.stream import ShardedStreamingCounter as JaxSharded
from kmers_tpu_torch.core import u128 as tu128
from kmers_tpu_torch.io.fastx import pack_batch_np
from kmers_tpu_torch.ops import kmer as tkmer
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel import route as troute
from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                             StreamingCounter, npz_digest)

from test_superkmer import genome_reads
from test_torch_sharded import D, SEEDS, run_jax


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(D), tmesh.make_mesh(devices=["cpu"] * D)


def wide_planes(rng, n: int) -> np.ndarray:
    """[n, 4] uint32 planes (hh, hl, lh, ll) of random 128-bit words, a
    few with bit 127 set (k = 64 keys may set it)."""
    w = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    w[:8, 0] |= np.uint32(0x80000000)
    return w


def jax_u128(w: np.ndarray) -> U128:
    p = [jnp.asarray(w[..., i]) for i in range(4)]
    return U128(U64(p[0], p[1]), U64(p[2], p[3]))


def torch_words(w: np.ndarray) -> tuple:
    """[..., 4] uint32 planes -> (hi, lo) int64 tensors."""
    j = lambda a, b: ((a.astype(np.uint64) << np.uint64(32)) | b).view(
        np.int64)
    return (torch.from_numpy(j(w[..., 0], w[..., 1])),
            torch.from_numpy(j(w[..., 2], w[..., 3])))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).reshape(-1)


def jax_planes(t) -> list:
    k = t.keys
    if isinstance(k, U128):
        return [k.hi.hi, k.hi.lo, k.lo.hi, k.lo.lo]
    return [k.hi, k.lo]


def assert_same_tables(jt, tables):
    """Per-shard tables of any form, every plane lane for lane, the
    compact ones' counts and n_unique too."""
    assert len(tables) == D
    planes = jax_planes(jt)
    for s, t in enumerate(tables):
        assert len(t.keys) == len(planes)
        for jp, tp in zip(planes, t.keys):
            np.testing.assert_array_equal(as_u32(tp),
                                          np.asarray(jp[s]).reshape(-1))
        if hasattr(jt, "counts"):
            np.testing.assert_array_equal(t.counts.numpy(),
                                          np.asarray(jt.counts[s]))
            assert t.n_unique == int(jt.n_unique[s])


def assert_same_metrics(jres, tres):
    assert set(tres.metrics) == set(jres.metrics)
    for name, value in jres.metrics.items():
        assert int(tres.metrics[name]) == int(value), name


# -- routing ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_owner_of_wide_matches_jax(n_shards, seed):
    w = wide_planes(np.random.default_rng(n_shards + 7), 4096)
    got = troute.owner_of_wide(*torch_words(w), n_shards, seed)
    want = np.asarray(jroute.owner_of_wide(jax_u128(w), n_shards, seed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n_shards


def jax_route_wide(jm, w, valid, cap, passes, seed):
    def body(hh, hl, lh, ll, v):
        r = jroute.route_wide(U128(U64(hh, hl), U64(lh, ll)), v, "d", cap,
                              seed, passes=passes)
        return (r.words.hi.hi, r.words.hi.lo, r.words.lo.hi, r.words.lo.lo,
                r.valid, r.overflow[None], r.rerouted[None])

    fn = jax.jit(shard_map(body, mesh=jm, in_specs=(P("d"),) * 5,
                           out_specs=(P("d"),) * 7))
    return fn(*(jnp.asarray(w[:, i]) for i in range(4)), jnp.asarray(valid))


@pytest.mark.parametrize("cap,passes", [(24, 1), (24, 2), (128, 1)])
def test_route_wide_matches_jax(cap, passes, meshes):
    """Every shard's received lanes (pass, sender, lane), valid mask,
    overflow and rerouted.  A sender holds 256 lanes, about 29 valid ones
    a destination: capacity 24 drops the largest buckets in one pass and
    delivers them in two."""
    jm, tm = meshes
    rng = np.random.default_rng(11)
    n = 256
    w = wide_planes(rng, D * n)
    valid = rng.random(D * n) < 0.9
    seed = 5
    want = jax_route_wide(jm, w, valid, cap, passes, seed)
    hi, lo = torch_words(w)
    got = troute.route_wide(
        [(hi[s * n:(s + 1) * n], lo[s * n:(s + 1) * n]) for s in range(D)],
        [torch.from_numpy(valid[s * n:(s + 1) * n]) for s in range(D)],
        tm, cap, seed, passes=passes)
    lanes = passes * D * cap
    for s, r in enumerate(got):
        for i, tp in enumerate(tu128.split_planes(*r.words)):
            np.testing.assert_array_equal(
                as_u32(tp), np.asarray(want[i])[s * lanes:(s + 1) * lanes])
        np.testing.assert_array_equal(
            r.valid.numpy(), np.asarray(want[4])[s * lanes:(s + 1) * lanes])
        assert int(r.overflow) == int(want[5][s])
        assert int(r.rerouted) == int(want[6][s])
    overflow = sum(int(r.overflow) for r in got)
    assert (overflow > 0) == (passes == 1 and cap == 24)
    if passes == 2:
        assert sum(int(r.rerouted) for r in got) > 0
        assert sum(int(r.valid.sum()) for r in got) == int(valid.sum())


# -- the sharded counters -----------------------------------------------------------

def half_max_bucket(rows: np.ndarray, k: int, seed: int) -> int:
    """Half the largest (sender, destination) bucket of the rows' valid
    canonical k-mers over D shards, rounded up: a route capacity that
    overflows in one pass and is exact in two."""
    most = 0
    for block in np.split(rows, D):
        r = torch.from_numpy(block)
        if k > 32:
            win = tkmer.kmer_windows_wide(r, k)
            hi, lo = tkmer.canonical_word_wide(win.fw, win.rc)
            owner = troute.owner_of_wide(hi[win.valid], lo[win.valid], D,
                                         seed)
        else:
            win = tkmer.kmer_windows(r, k)
            owner = troute.owner_of(
                tkmer.canonical_word(win.fw, win.rc)[win.valid], D, seed)
        most = max(most, int(torch.bincount(owner, minlength=D).max()))
    return (most + 1) // 2


def run_both(jm, tm, jfn, tfn, rows, packed):
    args = pack_batch_np(rows) if packed else (rows,)
    jres = run_jax(jfn, jm, *args)
    tres = tfn(*(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                  else a) for a in args))
    return jres, tres


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k,aggregate", [
    (33, "unit"), (33, "compact"), (48, "unit"), (48, "compact"),
    (63, "unit"), (63, "compact"), (64, "compact")])
def test_sharded_counter_wide_matches_jax(k, aggregate, packed, meshes):
    """Shard by shard and metric by metric (route_bytes 17 B a received
    lane); the re-counted global table is the single-device one."""
    jm, tm = meshes
    rows = genome_reads(32, 96, n_rate=0.005, seed=k)
    cap = half_max_bucket(rows, k, 3)
    kw = dict(route_capacity=cap, route_passes=2, seed=3, packed=packed,
              aggregate=aggregate)
    jres, tres = run_both(jm, tm, jpipe.make_sharded_counter_wide(jm, k, **kw),
                          tpipe.make_sharded_counter_wide(tm, k, **kw),
                          rows, packed)
    assert_same_tables(jres.table, tres.table)
    assert_same_metrics(jres, tres)
    assert int(tres.metrics["route_bytes"]) == 17 * 2 * D * D * cap
    assert int(tres.metrics["route_rerouted"]) > 0
    assert int(tres.metrics["route_overflow"]) == 0
    flat = StreamingCounter(k, 1 << 13, device="cpu")
    flat.update(rows)
    g = tpipe.global_table(tres)
    nu = g.n_unique
    keys = tu128.to_ints(*tu128.join_planes(*(p[:nu] for p in g.keys)))
    assert list(zip(keys, g.counts[:nu].tolist())) == flat.to_pairs()


@pytest.mark.parametrize("packed,aggregate", [
    (False, "compact"), (True, "compact"), (False, "runlength")])
def test_sharded_counter_k32_matches_jax(packed, aggregate, meshes):
    """k = 32 keys fill the word: each shard gets count_words' compact
    table, for "runlength" too (kmers_tpu/parallel/pipeline.py:206-209)."""
    jm, tm = meshes
    rows = genome_reads(32, 64)
    cap = half_max_bucket(rows, 32, 1)
    kw = dict(route_capacity=cap, route_passes=2, seed=1, packed=packed,
              aggregate=aggregate)
    jres, tres = run_both(jm, tm, jpipe.make_sharded_counter(jm, 32, **kw),
                          tpipe.make_sharded_counter(tm, 32, **kw), rows,
                          packed)
    assert_same_tables(jres.table, tres.table)
    assert_same_metrics(jres, tres)
    assert int(tres.metrics["route_bytes"]) == 9 * 2 * D * D * cap
    assert int(tres.metrics["route_rerouted"]) > 0
    assert int(tres.metrics["route_overflow"]) == 0


@pytest.mark.parametrize("k", [32, 64])
def test_unit_tables_need_a_spare_bit(k, meshes):
    """At k = 32 and k = 64 the unit pattern (0x80000000, 0, ...) is a real
    key (A^31 G at k = 32), so the unit form is refused there."""
    _, tm = meshes
    mk = tpipe.make_sharded_counter if k == 32 else (
        tpipe.make_sharded_counter_wide)
    with pytest.raises(ValueError, match="spare"):
        mk(tm, k, route_capacity=8, aggregate="unit")
    with pytest.raises(ValueError):
        tpipe.make_sharded_counter_wide(tm, 32, route_capacity=8)
    with pytest.raises(ValueError):
        tpipe.make_sharded_counter(tm, 33, route_capacity=8)


# -- ShardedStreamingCounter ----------------------------------------------------------

@pytest.mark.parametrize("k,packed,capacity", [
    (32, False, 1 << 13), (41, True, 1 << 13), (63, False, 1 << 13),
    (63, True, 1 << 13), (64, True, 1 << 13),
    (63, False, 256),                                    # evicts
])
def test_sharded_streaming_counter_wide_matches_jax(tmp_path, k, packed,
                                                    capacity):
    """Batches of 30 rows (padded to split over 8 shards), merged every
    two: the same npz_digest, kmers, route_overflow and route_rerouted as
    kmers_tpu's ShardedStreamingCounter(n_devices=8); without eviction the
    table is the port's single-device one."""
    rows = genome_reads(90, 96, n_rate=0.005, seed=k)
    pad = np.full((2, 96), ord("N"), np.uint8)
    cap = max(half_max_bucket(np.concatenate([rows[i:i + 30], pad]), k, 0)
              for i in range(0, 90, 30))
    kw = dict(route_capacity=cap, route_passes=2)
    j = JaxSharded(k, capacity=capacity, merge_every=2, n_devices=D, **kw)
    t = ShardedStreamingCounter(k, capacity, merge_every=2,
                                mesh=tmesh.make_mesh(devices=["cpu"] * D),
                                **kw)
    flat = StreamingCounter(k, capacity, merge_every=2, device="cpu")
    for i in range(0, 90, 30):
        for sc in (j, t, flat):
            if packed:
                sc.update_packed(*pack_batch_np(rows[i:i + 30]))
            else:
                sc.update(rows[i:i + 30])
    for sc, name in ((j, "j"), (t, "t"), (flat, "f")):
        sc.save(str(tmp_path / name))
    digest = npz_digest(str(tmp_path / "t.npz"))
    assert digest == npz_digest(str(tmp_path / "j.npz"))
    assert (t.kmers, t.route_overflow, t.route_rerouted) == (
        j.kmers, j.route_overflow, j.route_rerouted)
    assert (t.dropped_unique, t.dropped_kmers) == (j.dropped_unique,
                                                   j.dropped_kmers)
    assert t.route_overflow == 0 and t.route_rerouted > 0
    assert (t.dropped_unique > 0) == (capacity == 256)
    if capacity > 256:
        assert digest == npz_digest(str(tmp_path / "f.npz"))
    # 17 B a received lane past k = 32, 9 B at k = 32
    assert t.route_bytes == 3 * 2 * D * D * cap * (17 if k > 32 else 9)
