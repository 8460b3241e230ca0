"""The sharded counters' counted per-shard tables against the JAX package
on the CPU: make_sharded_counter with its default (compact) aggregate,
make_superkmer_counter(aggregate="compact") and
make_sharded_minimizer_counter, the port's mesh of 8 CPU shards against
kmers_tpu's 8-device CPU mesh (tests/conftest.py), shard by shard, lane
for lane, and metric by metric; global_table over counted shard tables.
Exact equality."""

import numpy as np
import pytest
import torch

from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu_torch.io.fastx import pack_batch_np
from kmers_tpu_torch.ops import hash as thash
from kmers_tpu_torch.ops import minimizer as tmini
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe

from test_superkmer import genome_reads
from test_torch_count_forms import assert_same_table
from test_torch_sharded import run_jax, single_device_table, table_pairs

D = 8


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(D), tmesh.make_mesh(devices=["cpu"] * D)


def assert_same_shards(jres, tres):
    assert len(tres.table) == D
    for s in range(D):
        keys = jres.table.keys
        jt = type(jres.table)(keys=type(keys)(keys.hi[s], keys.lo[s]),
                              counts=jres.table.counts[s],
                              n_unique=jres.table.n_unique[s])
        assert_same_table(tres.table[s], jt)
    assert set(tres.metrics) == set(jres.metrics)
    for name, value in jres.metrics.items():
        assert int(tres.metrics[name]) == int(value), name


def as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cap,passes", [(256, 1), (24, 2), (16, 1)])
def test_sharded_counter_default_is_compact_and_matches_jax(meshes, packed,
                                                            cap, passes):
    """Default arguments: each shard's compact table equals kmers_tpu's;
    (24, 2) re-routes, (16, 1) overflows; global_table is kmers_tpu's."""
    k = 21
    rows = genome_reads(64, 64)
    jm, tm = meshes
    kw = dict(route_capacity=cap, route_passes=passes, seed=3)
    args = pack_batch_np(rows) if packed else (rows,)
    jres = run_jax(jpipe.make_sharded_counter(jm, k, packed=packed, **kw), jm,
                   *args)
    tres = tpipe.make_sharded_counter(tm, k, packed=packed, **kw)(
        *(as_torch(a) for a in args))
    assert_same_shards(jres, tres)
    g, jg = tpipe.global_table(tres), jpipe.global_table(jres)
    assert_same_table(g, jg)
    if int(tres.metrics["route_overflow"]) == 0:
        assert table_pairs(g) == single_device_table(rows, k)


def test_superkmer_counter_compact_matches_jax(meshes):
    k, w = 21, 7
    rows = genome_reads(64, 64)
    jm, tm = meshes
    kw = dict(route_capacity=512, route_passes=2, seed=1, aggregate="compact")
    jres = run_jax(jpipe.make_superkmer_counter(jm, k, w, **kw), jm, rows)
    tres = tpipe.make_superkmer_counter(tm, k, w, **kw)(torch.from_numpy(rows))
    assert_same_shards(jres, tres)
    assert table_pairs(tpipe.global_table(tres)) == single_device_table(rows,
                                                                        k)


def minimizer_count(rows, k, w, hash_fn):
    """Independent count: torch.unique over the valid minimizer words."""
    mm = tmini.minimizer_stream(torch.from_numpy(rows), k, w, hash_fn)
    keys, counts = torch.unique(mm.word[mm.valid], return_counts=True)
    return list(zip(keys.tolist(), counts.tolist()))


@pytest.mark.parametrize("k,w,use_lex", [(21, 7, False), (31, 11, False),
                                         (15, 5, True)])
@pytest.mark.parametrize("cap,passes", [(256, 2), (16, 1)])
def test_sharded_minimizer_counter_matches_jax(meshes, k, w, use_lex, cap,
                                               passes):
    """Minimizer bucketing (BASELINE config 4) shard by shard; without
    overflow the global table is an independent count of the minimizer
    words, and the mass plus the overflow is the k-mer count."""
    rows = genome_reads(64, 64)
    jm, tm = meshes
    kw = dict(route_capacity=cap, route_passes=passes, seed=5,
              use_lex=use_lex)
    jres = run_jax(jpipe.make_sharded_minimizer_counter(jm, k, w, **kw), jm,
                   rows)
    tres = tpipe.make_sharded_minimizer_counter(tm, k, w, **kw)(
        torch.from_numpy(rows))
    assert_same_shards(jres, tres)
    g = tpipe.global_table(tres)
    overflow = int(tres.metrics["route_overflow"])
    assert (overflow > 0) == (cap == 16)
    assert int(g.counts.sum()) + overflow == int(
        tres.metrics["kmers_emitted"])
    if not overflow:
        hash_fn = thash.lex_hash_fn(w) if use_lex else thash.mix_hash_fn(5)
        assert table_pairs(g) == minimizer_count(rows, k, w, hash_fn)


def test_sharded_minimizer_counter_checks_its_arguments(meshes):
    _, tm = meshes
    with pytest.raises(ValueError):
        tpipe.make_sharded_minimizer_counter(tm, 33, 11, route_capacity=8)
    with pytest.raises(ValueError):
        tpipe.make_sharded_minimizer_counter(tm, 21, 22, route_capacity=8)
