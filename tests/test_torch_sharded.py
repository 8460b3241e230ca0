"""The port's sharded layer against the JAX package, on the CPU: the
routing helpers, super-k-mer emission and expansion, both sharded
counters at D = 8 (the port's mesh of 8 CPU shards against kmers_tpu's
8-device CPU mesh from tests/conftest.py, the same capacities, passes and
seeds), shard by shard and metric by metric, and ShardedStreamingCounter
end to end.  Everything is bit-exact: zero tolerance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kmers_tpu.core import u64 as ju
from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu.parallel import route as jroute
from kmers_tpu.parallel.stream import ShardedStreamingCounter as JaxSharded
from kmers_tpu.parallel.stream import pending_table_lanes as jax_lanes
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.io.fastx import pack_batch_np
from kmers_tpu_torch.ops import kmer as tkmer
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel import route as troute
from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                             StreamingCounter, npz_digest,
                                             pending_table_lanes)

from test_superkmer import genome_reads
from test_torch_hash import jax_u64, u64_words

D = 8
SEEDS = [0, 5, (1 << 35) + 7]
LAYOUTS = [(21, 7), (31, 11), (18, 4), (16, 5)]   # test_superkmer.py:29-34


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(D), tmesh.make_mesh(devices=["cpu"] * D)


def t64(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int64))


def words_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def run_jax(fn, m, *arrays):
    return fn(*(jax.device_put(jnp.asarray(a), jmesh.batch_sharding(m))
                for a in arrays))


def assert_same_result(jres, tres):
    """Per-shard unit tables lane for lane, and every metric."""
    jt = jres.table
    assert len(tres.table) == D
    for s in range(D):
        for jp, tp in ((jt.keys.hi, tres.table[s].keys_hi),
                       (jt.keys.lo, tres.table[s].keys_lo)):
            np.testing.assert_array_equal(
                tp.numpy().view(np.uint32).reshape(-1),
                np.asarray(jp[s]).reshape(-1))
    assert set(tres.metrics) == set(jres.metrics)
    for name, value in jres.metrics.items():
        assert int(tres.metrics[name]) == int(value), name


def single_device_table(rows, k):
    sc = StreamingCounter(k, 1 << 14, device="cpu")
    sc.update(rows)
    return sc.to_pairs()


def table_pairs(table):
    nu = table.n_unique
    keys = tu.join_planes(table.keys_hi[:nu], table.keys_lo[:nu]).tolist()
    return list(zip(keys, table.counts[:nu].tolist()))


# -- helpers --------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_feistel_round_trip_and_matches_jax(seed):
    words = u64_words(np.random.default_rng(seed & 0xFF), 4096)
    words[:4] = [0, 1, 2**64 - 1, 2**63]
    mixed = tu.feistel_mix(t64(words), seed)
    np.testing.assert_array_equal(
        words_of(mixed), ju.to_numpy(ju.feistel_mix(jax_u64(words), seed)))
    np.testing.assert_array_equal(words_of(tu.feistel_unmix(mixed, seed)),
                                  words)
    np.testing.assert_array_equal(
        words_of(tu.feistel_unmix(t64(words), seed)),
        ju.to_numpy(ju.feistel_unmix(jax_u64(words), seed)))


@pytest.mark.parametrize("n_shards", [1, 3, 8, 256])
def test_owner_of_matches_jax(n_shards):
    words = u64_words(np.random.default_rng(n_shards), 4096)
    got = troute.owner_of(t64(words), n_shards, seed=9)
    want = np.asarray(jroute.owner_of(jax_u64(words), n_shards, seed=9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n_shards
    assert troute._owner_boundaries(n_shards) == jroute._owner_boundaries(
        n_shards)


@pytest.mark.parametrize("n_shards", [1, 5, 8])
def test_bucket_sort_matches_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    words = u64_words(rng, 3000) >> np.uint64(2)
    valid = rng.random(3000) < 0.7
    jw, jv, jo, jc = jroute.bucket_sort(jax_u64(words), jnp.asarray(valid),
                                        n_shards, seed=3)
    tw, tv, to, tc = troute.bucket_sort(t64(words), torch.from_numpy(valid),
                                        n_shards, seed=3)
    np.testing.assert_array_equal(words_of(tw), ju.to_numpy(jw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(to.numpy()[tv.numpy()],
                                  np.asarray(jo)[np.asarray(jv)])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) == int(valid.sum())


def test_all_to_all_is_tiled_over_the_mesh():
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    bufs = [torch.arange(6).reshape(3, 2) + 10 * s for s in range(3)]
    got = tmesh.all_to_all(bufs, mesh)
    for r in range(3):
        for s in range(3):
            assert torch.equal(got[r][s], bufs[s][r])
    with pytest.raises(ValueError):
        tmesh.all_to_all(bufs[:2], mesh)


def test_make_mesh():
    assert tmesh.make_mesh(devices=["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert tmesh.mesh_for("cpu", 4) == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="requested"):
        tmesh.make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])
    parts = tmesh.batch_sharding(torch.arange(12).reshape(6, 2),
                                 tmesh.make_mesh(devices=["cpu"] * 3))
    assert [p[:, 0].tolist() for p in parts] == [[0, 2], [4, 6], [8, 10]]
    assert tmesh.process_local_batch(7, (torch.device("cpu"),) * 3) == 3
    with pytest.raises(ValueError):
        tmesh.batch_sharding(torch.zeros(5, 2), (torch.device("cpu"),) * 3)


@pytest.mark.parametrize("kw", [
    dict(devices=1), dict(devices=8, route_capacity=512),
    dict(devices=4, route_capacity=64, route_passes=3),
    dict(devices=4, partition="minimizer", k=21, minimizer_w=7)])
def test_pending_table_lanes_matches_jax(kw):
    assert pending_table_lanes(256, 160, **kw) == jax_lanes(256, 160, **kw)


# -- super-k-mers ----------------------------------------------------------------

@pytest.mark.parametrize("k,w", LAYOUTS)
def test_emit_superkmers_matches_jax(k, w):
    rows = genome_reads(16, 64, n_rate=0.05)
    j_owner, j_start, j_planes, j_kmers = jpipe.emit_superkmers(
        jnp.asarray(rows), k, w, seed=11)
    owner, start, planes, kmers = tpipe.emit_superkmers(
        torch.from_numpy(rows), k, w, seed=11)
    s = np.asarray(j_start)
    np.testing.assert_array_equal(start.numpy(), s)
    np.testing.assert_array_equal(words_of(owner)[s],
                                  ju.to_numpy(j_owner)[s])
    assert len(planes) == len(j_planes)
    for tp, jp in zip(planes, j_planes):
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy().view(np.uint32),
                                      np.asarray(jp))
    assert int(kmers) == int(j_kmers)


@pytest.mark.parametrize("k,w", LAYOUTS)
def test_expand_superkmers_matches_jax_and_roundtrips(k, w):
    """Every lane of the expansion equals the JAX package's, and the
    expanded windows' canonical multiset is the read batch's k-mers."""
    rows = genome_reads(16, 64, n_rate=0.05)
    _, start, planes, kmers = tpipe.emit_superkmers(torch.from_numpy(rows), k,
                                                    w, seed=0)
    flat = tuple(p.reshape(-1) for p in planes)
    fw, wv = tpipe.expand_superkmers(flat, start.reshape(-1), k, w)
    j_fw, j_wv = jpipe.expand_superkmers(
        tuple(jnp.asarray(p.numpy().view(np.uint32)) for p in flat),
        jnp.asarray(start.numpy().reshape(-1)), k, w)
    np.testing.assert_array_equal(wv.numpy(), np.asarray(j_wv))
    np.testing.assert_array_equal(words_of(fw), ju.to_numpy(j_fw))
    canon = tkmer.canonical_word(fw, tu.reverse_complement(fw, k))
    got = torch.unique(canon[wv], return_counts=True)
    want = single_device_table(rows, k)
    assert list(zip(*(x.tolist() for x in got))) == want
    assert int(kmers) == int(wv.sum()) > 2 * int(start.sum())


@pytest.mark.parametrize("cap,passes", [(64, 1), (8, 2)])
def test_prefilter_matches_jax(cap, passes, meshes, monkeypatch):
    """The K4 prefilter against the JAX package's, run in interpret mode
    (KMERS_TPU_SK_PREFILTER=interpret); a budget that truncates too."""
    monkeypatch.setenv("KMERS_TPU_SK_PREFILTER", "interpret")
    k, w = 21, 7
    rows = genome_reads(64, 64)
    jm, tm = meshes
    jres = run_jax(jpipe.make_superkmer_counter(
        jm, k, w, route_capacity=cap, route_passes=passes), jm, rows)
    tres = tpipe.make_superkmer_counter(
        tm, k, w, route_capacity=cap, route_passes=passes)(
            torch.from_numpy(rows))
    assert_same_result(jres, tres)
    mass = int(tpipe.global_table(tres).counts.sum())
    assert mass + int(tres.metrics["route_overflow"]) == int(
        tres.metrics["kmers_emitted"])
    owner, start, planes, _ = tpipe.emit_superkmers(torch.from_numpy(rows[:8]),
                                                    k, w, 0)
    n_start = int(start.sum())
    o2, v2, p2, dw = tpipe._prefilter_superkmers(owner, start, planes,
                                                 n_start - 5, 6, len(planes))
    jo, jv, jp, jdw = jpipe._prefilter_superkmers(
        ju.from_numpy(words_of(owner)), jnp.asarray(start.numpy()),
        tuple(jnp.asarray(p.numpy().view(np.uint32)) for p in planes),
        n_start - 5, 6, len(planes), interpret=True)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(words_of(o2), ju.to_numpy(jo))
    for a, b in zip(p2, jp):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    assert int(dw) == int(jdw) > 0


# -- the sharded counters at D = 8 -----------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cap,passes", [(256, 2), (24, 2), (16, 1)])
def test_sharded_counter_matches_jax(cap, passes, packed, meshes):
    """Hash partition, shard by shard; (24, 2) re-routes, (16, 1)
    overflows."""
    k = 21
    rows = genome_reads(64, 64)
    jm, tm = meshes
    kw = dict(route_capacity=cap, route_passes=passes, seed=3)
    args = pack_batch_np(rows) if packed else (rows,)
    jres = run_jax(jpipe.make_sharded_counter(
        jm, k, packed=packed, aggregate="unit", **kw), jm, *args)
    tres = tpipe.make_sharded_counter(tm, k, packed=packed, aggregate="unit",
                                      **kw)(
        *(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
          for a in args))
    assert_same_result(jres, tres)
    if (cap, passes) == (24, 2):
        assert int(tres.metrics["route_rerouted"]) > 0
    g = tpipe.global_table(tres)
    mass = int(g.counts.sum())
    assert mass + int(tres.metrics["route_overflow"]) == int(
        tres.metrics["kmers_emitted"])
    if int(tres.metrics["route_overflow"]) == 0:
        assert table_pairs(g) == single_device_table(rows, k)


@pytest.mark.parametrize("cap,passes", [(512, 2), (40, 2), (8, 1)])
def test_superkmer_counter_matches_jax(cap, passes, meshes):
    """Minimizer partition, shard by shard; (8, 1) overflows: the table
    mass plus route_overflow (k-mers) is kmers_emitted
    (test_superkmer.py:91-104)."""
    k, w = 21, 7
    rows = genome_reads(64, 64)
    jm, tm = meshes
    kw = dict(route_capacity=cap, route_passes=passes, seed=1)
    jres = run_jax(jpipe.make_superkmer_counter(jm, k, w, **kw), jm, rows)
    tres = tpipe.make_superkmer_counter(tm, k, w, **kw)(
        torch.from_numpy(rows))
    assert_same_result(jres, tres)
    g = tpipe.global_table(tres)
    overflow = int(tres.metrics["route_overflow"])
    assert (overflow > 0) == (cap == 8)
    assert int(g.counts.sum()) + overflow == int(tres.metrics["kmers_emitted"])
    jg = jpipe.global_table(jres)
    nu = int(jg.n_unique)
    assert g.n_unique == nu
    np.testing.assert_array_equal(g.keys_hi.numpy()[:nu].view(np.uint32),
                                  np.asarray(jg.keys.hi)[:nu])
    np.testing.assert_array_equal(g.keys_lo.numpy()[:nu].view(np.uint32),
                                  np.asarray(jg.keys.lo)[:nu])
    np.testing.assert_array_equal(g.counts.numpy()[:nu],
                                  np.asarray(jg.counts)[:nu])
    if not overflow:
        assert table_pairs(g) == single_device_table(rows, k)
        assert (int(tres.metrics["superkmers"])
                < int(tres.metrics["kmers_emitted"]) / 2)


@pytest.mark.parametrize("partition", ["hash", "minimizer"])
def test_three_shards_match_jax(partition):
    """A shard count that is not a power of two (owner boundaries by
    multiply-shift), three routing passes."""
    k, w = 21, 7
    rows = genome_reads(48, 64)
    jm, tm = jmesh.make_mesh(3), tmesh.make_mesh(devices=["cpu"] * 3)
    # buckets past one pass's capacity, within three
    kw = dict(route_capacity=64 if partition == "hash" else 12,
              route_passes=3, seed=2)
    if partition == "hash":
        jfn = jpipe.make_sharded_counter(jm, k, aggregate="unit", **kw)
        tfn = tpipe.make_sharded_counter(tm, k, aggregate="unit", **kw)
    else:
        jfn = jpipe.make_superkmer_counter(jm, k, w, **kw)
        tfn = tpipe.make_superkmer_counter(tm, k, w, **kw)
    jres, tres = run_jax(jfn, jm, rows), tfn(torch.from_numpy(rows))
    for s in range(3):
        for jp, tp in ((jres.table.keys.hi, tres.table[s].keys_hi),
                       (jres.table.keys.lo, tres.table[s].keys_lo)):
            np.testing.assert_array_equal(
                tp.numpy().view(np.uint32).reshape(-1),
                np.asarray(jp[s]).reshape(-1))
    for name, value in jres.metrics.items():
        assert int(tres.metrics[name]) == int(value), name
    assert int(tres.metrics["route_rerouted"]) > 0
    assert int(tres.metrics["route_overflow"]) == 0
    assert table_pairs(tpipe.global_table(tres)) == single_device_table(rows,
                                                                        k)


def test_superkmer_reverse_complement_pairs_exact(meshes):
    """Forward-strand minimizers send a canonical key's reverse-complement
    occurrences elsewhere (test_superkmer.py:107-): shards are not
    key-disjoint, and the re-counted global table is still exact."""
    k, w = 21, 7
    fwd = genome_reads(32, 64, n_rate=0.0)
    comp = {ord("A"): ord("T"), ord("T"): ord("A"),
            ord("C"): ord("G"), ord("G"): ord("C")}
    rc = np.vectorize(comp.get)(fwd[:, ::-1]).astype(np.uint8)
    rows = np.concatenate([fwd, rc], axis=0)
    jm, tm = meshes
    kw = dict(route_capacity=1024, route_passes=2)
    jres = run_jax(jpipe.make_superkmer_counter(jm, k, w, **kw), jm, rows)
    tres = tpipe.make_superkmer_counter(tm, k, w, **kw)(torch.from_numpy(rows))
    assert_same_result(jres, tres)
    g = tpipe.global_table(tres)
    pairs = table_pairs(g)
    assert pairs == single_device_table(rows, k)
    assert all(c % 2 == 0 for _, c in pairs)


def test_counters_reject_what_is_not_ported(meshes):
    """The hash partition builds at k = 32 and past it (test_torch_sharded_
    wide.py holds those against JAX); an unknown aggregate or partition,
    super-k-mers past k = 31 and the minimizer partition past k = 31 (a
    ValueError, as in the JAX package) are refused."""
    _, tm = meshes
    with pytest.raises(ValueError, match="aggregate"):
        tpipe.make_sharded_counter(tm, 21, route_capacity=8,
                                   aggregate="sorted")
    assert callable(tpipe.make_sharded_counter(tm, 32, route_capacity=8))
    with pytest.raises(ValueError):
        tpipe.make_superkmer_counter(tm, 33, 11, route_capacity=8)
    for k in (32, 41, 64):
        sc = ShardedStreamingCounter(k, 64, mesh=tm)
        assert sc.wide == (k > 32) and sc.n_devices == D
    with pytest.raises(ValueError, match="k <= 31"):
        ShardedStreamingCounter(41, 64, mesh=tm, partition="minimizer")
    with pytest.raises(ValueError):
        ShardedStreamingCounter(21, 64, mesh=tm, partition="range")


# -- ShardedStreamingCounter -----------------------------------------------------

def jax_sharded(partition, k, **kw):
    return JaxSharded(k, capacity=1 << 13, merge_every=2, n_devices=D,
                      partition=partition, **kw)


def port_sharded(partition, k, **kw):
    return ShardedStreamingCounter(k, 1 << 13, merge_every=2,
                                   mesh=tmesh.make_mesh(devices=["cpu"] * D),
                                   partition=partition, **kw)


@pytest.mark.parametrize("partition,packed", [("hash", False), ("hash", True),
                                              ("minimizer", False)])
def test_sharded_streaming_counter_matches_jax(tmp_path, partition, packed):
    """Batches of 30 rows (padded to split over 8 shards): the same
    digest as kmers_tpu's ShardedStreamingCounter(n_devices=8) and as the
    port's single-device counter, and the same routing counters."""
    k = 21
    rows = genome_reads(90, 64)
    kw = dict(route_capacity=64, route_passes=2, minimizer_w=7)
    j, t = jax_sharded(partition, k, **kw), port_sharded(partition, k, **kw)
    flat = StreamingCounter(k, 1 << 13, merge_every=2, device="cpu")
    for i in range(0, 90, 30):
        batch = rows[i:i + 30]
        for sc in (j, t, flat):
            if packed:
                sc.update_packed(*pack_batch_np(batch))
            else:
                sc.update(batch)
    for sc, name in ((j, "j"), (t, "t"), (flat, "f")):
        sc.save(str(tmp_path / name))
    digest = npz_digest(str(tmp_path / "t.npz"))
    assert digest == npz_digest(str(tmp_path / "j.npz"))
    assert digest == npz_digest(str(tmp_path / "f.npz"))
    assert (t.route_overflow, t.route_rerouted, t.route_superkmers) == (
        j.route_overflow, j.route_rerouted, j.route_superkmers)
    assert (t.route_superkmers > 0) == (partition == "minimizer")
    if partition == "minimizer":
        with pytest.raises(NotImplementedError):
            t.update_packed(*pack_batch_np(rows[:8]))


def test_sharded_counter_overflow_commits_with_the_merge():
    """Overflow counters move only at consolidation, and discard_pending
    drops them with the batches."""
    rows = genome_reads(32, 64)
    t = port_sharded("hash", 21, route_capacity=4)
    t.merge_every = 4
    t.update(rows)
    assert t.route_overflow == 0 and t.batches == 1
    t.discard_pending()
    assert t.batches == 0
    t.update(rows)
    t.to_pairs()
    assert t.route_overflow > 0
    assert t.kmers == sum(c for _, c in t.to_pairs()) + t.route_overflow


@pytest.mark.parametrize("partition", ["hash", "minimizer"])
def test_sharded_checkpoints_resume_across_packages(tmp_path, partition):
    """A checkpoint saved by either package's sharded counter resumes in
    the other's (the flat table moves into a sharded counter, as the CLI
    does), and both continuations save the same content."""
    k = 21
    rows = genome_reads(96, 64)
    kw = dict(route_capacity=64, route_passes=2, minimizer_w=7)
    j, t = jax_sharded(partition, k, **kw), port_sharded(partition, k, **kw)
    for sc in (j, t):
        sc.update(rows[:32])
        sc.update(rows[32:64])
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    assert npz_digest(str(tmp_path / "j.npz")) == npz_digest(
        str(tmp_path / "t.npz"))

    from kmers_tpu.parallel.stream import StreamingCounter as JaxFlat

    t2, j2 = port_sharded(partition, k, **kw), jax_sharded(partition, k, **kw)
    for dst, src in ((t2, StreamingCounter.load(str(tmp_path / "j"),
                                                device="cpu")),
                     (j2, JaxFlat.load(str(tmp_path / "t")))):
        dst.table = src.table
        dst.batches, dst.kmers = src.batches, src.kmers
        dst.update(rows[64:])
    t2.save(str(tmp_path / "t2"))
    j2.save(str(tmp_path / "j2"))
    whole = port_sharded(partition, k, **kw)
    for i in range(0, 96, 32):
        whole.update(rows[i:i + 32])
    whole.save(str(tmp_path / "w"))
    assert whole.route_overflow == 0
    digest = npz_digest(str(tmp_path / "w.npz"))
    assert npz_digest(str(tmp_path / "t2.npz")) == digest
    assert npz_digest(str(tmp_path / "j2.npz")) == digest


def test_count_fastx_sharded_matches_single_device(tmp_path):
    from kmers_tpu_torch.io import simulate
    from kmers_tpu_torch.parallel.stream import count_fastx

    fq = str(tmp_path / "r.fastq")
    simulate.write_fastq(fq, 3000, 70, 100, 0.01, 0.005, 6)
    args = dict(k=21, capacity=4096, batch=16, length=128, merge_every=2,
                device="cpu")
    flat = count_fastx(fq, **args)
    for partition in ("hash", "minimizer"):
        sh = count_fastx(fq, devices=4, partition=partition,
                         route_capacity=256, minimizer_w=9, **args)
        assert isinstance(sh, ShardedStreamingCounter)
        assert sh.to_pairs() == flat.to_pairs() and sh.route_overflow == 0
        assert (sh.batches, sh.kmers) == (flat.batches, flat.kmers)
