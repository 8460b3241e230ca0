"""The port's distributed lookup service against the JAX package on the
CPU: K3's plain source-index output (Pallas in interpret mode),
lookup_merge, route_queries (inside shard_map on the 8-device CPU mesh
of tests/conftest.py), make_sharded_lookup at both answer arms and
lookup_sharded, on seeded inputs.  Everything is exact: zero tolerance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kmers_tpu.core import u64 as ju
from kmers_tpu.core.u64 import U64
from kmers_tpu.kernels import merge as jmerge
from kmers_tpu.parallel import count as jcount
from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu.parallel import route as jroute
from kmers_tpu_torch import kernels
from kmers_tpu_torch.kernels import merge as tmerge
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel import route as troute
from kmers_tpu_torch.parallel.stream import StreamingCounter

from test_superkmer import genome_reads
from test_torch_merge import as_u32, t32, table_planes, unit_planes

MAX64 = (1 << 64) - 1


def jax_u64(words: np.ndarray) -> U64:
    return U64(jnp.asarray((words >> np.uint64(32)).astype(np.uint32)),
               jnp.asarray((words & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def t64(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.astype(np.uint64).view(np.int64))


def jax_table(hi, lo, counts, n_live):
    return jcount.CountTable(keys=U64(jnp.asarray(hi), jnp.asarray(lo)),
                             counts=jnp.asarray(counts),
                             n_unique=jnp.int32(n_live))


def port_table(hi, lo, counts, n_live):
    return tcount.CountTable(t32(hi), t32(lo), torch.from_numpy(counts),
                             n_live)


# -- K3's source-index plane ------------------------------------------------------

@pytest.mark.parametrize("nA,capA,nB,totB,bits", [
    (0, 512, 300, 512, 8),
    (512, 512, 0, 512, 10),
    (15, 1024, 1500, 2048, 4),     # heavy duplicates across A and B
    (300, 700, 1200, 1300, 40),    # keys above 2^32, ragged lengths
])
def test_merge_sorted_idx_plain_matches_pallas(nA, capA, nB, totB, bits):
    """Keys and weights on every one of the nA + nB lanes; the index plane
    where the merged key is live (JAX's tile pad and the dead sentinels
    share the MAX key, so their order differs)."""
    rng = np.random.default_rng(nA + nB + 7)
    a_hi, a_lo, a_w, keys = table_planes(rng, nA, capA, bits)
    b_hi, b_lo = unit_planes(rng, totB, nB, bits, keys)
    want = jmerge.merge_sorted(*(jnp.asarray(x) for x in
                                 (a_hi, a_lo, a_w, b_hi, b_lo)),
                               tile=1024, interpret=True, with_idx=True)
    args = tuple(t32(x) for x in (a_hi, a_lo, a_w, b_hi, b_lo))
    kernels.reset_launch_counts()
    got = tmerge.merge_sorted(*args, with_idx=True)
    assert set(kernels.launch_counts().values()) == {0}
    n = capA + totB
    assert len(got) == 4 and all(g.shape == (n,) for g in got)
    assert got[3].dtype == torch.int32
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(as_u32(g), np.asarray(w)[:n])
    live = as_u32(got[0]) >> 31 == 0
    np.testing.assert_array_equal(as_u32(got[3])[live],
                                  np.asarray(want[3])[:n][live])
    # every lane's source: A ranks 0..capA-1, then B ranks with bit 31
    idx = as_u32(got[3]).astype(np.int64)
    assert sorted(idx) == list(range(capA)) + [(1 << 31) + i
                                               for i in range(totB)]
    for g, w in zip(got[:3], tmerge.merge_sorted(*args)):
        assert torch.equal(g, w)


# -- lookup_merge -------------------------------------------------------------------

@pytest.mark.parametrize("cap,n_live,nq,bits,vf", [
    (1024, 700, 2048, 12, 1.0),
    (1024, 700, 2048, 12, 0.7),   # some invalid queries
    (512, 0, 1024, 8, 1.0),       # empty table
    (2048, 1500, 256, 40, 1.0),   # mostly-absent queries
])
def test_lookup_merge_matches_jax(cap, n_live, nq, bits, vf):
    """The four cases of tests/test_merge_kernel.py:182-202 (duplicate
    queries in the first three), answer for answer against kmers_tpu's
    lookup_merge (interpret mode) and against the port's binary search."""
    rng = np.random.default_rng(cap + n_live + nq + bits)
    keys = np.sort(rng.choice(1 << bits, size=n_live, replace=False)
                   .astype(np.uint64))
    hi = np.zeros(cap, np.uint32)
    lo = np.zeros(cap, np.uint32)
    counts = np.zeros(cap, np.int32)
    hi[:n_live] = keys >> np.uint64(32)
    lo[:n_live] = keys & np.uint64(0xFFFFFFFF)
    counts[:n_live] = rng.integers(1, 100, n_live)
    q = rng.integers(0, 1 << bits, nq).astype(np.uint64)
    valid = rng.random(nq) < vf
    want = np.asarray(jcount.lookup_merge(
        jax_table(hi, lo, counts, n_live), jax_u64(q),
        valid=jnp.asarray(valid), interpret=True))
    table = port_table(hi, lo, counts, n_live)
    got = tcount.lookup_merge(table, t64(q), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    search = tcount.lookup(table, t64(q)).numpy()
    np.testing.assert_array_equal(got.numpy()[valid], search[valid])
    assert (got.numpy()[~valid] == 0).all()
    if vf == 1.0:
        np.testing.assert_array_equal(tcount.lookup_merge(table, t64(q))
                                      .numpy(), search)


def test_lookup_merge_keeps_the_queries_shape():
    rng = np.random.default_rng(3)
    hi, lo, w, keys = table_planes(rng, 100, 256, 30)
    hi[100:] = lo[100:] = w[100:] = 0
    table = port_table(hi, lo, w.astype(np.int32), 100)
    q = np.concatenate([keys[:40], rng.integers(0, 1 << 30, 8)
                        .astype(np.uint64)]).reshape(6, 8)
    valid = rng.random((6, 8)) < 0.8
    got = tcount.lookup_merge(table, t64(q), torch.from_numpy(valid))
    want = torch.where(torch.from_numpy(valid), tcount.lookup(table, t64(q)),
                       0)
    assert got.shape == (6, 8) and torch.equal(got, want)
    assert tcount.lookup_merge(table, t64(q[:0])).shape == (0, 8)


# -- route_queries ------------------------------------------------------------------

def query_lanes(rng, n, alias_seed):
    """n query words below 2^62 with duplicates and a fifth invalid; lanes
    0-4 invalid and lane 5 the word whose mix is MAX (it must sort ahead
    of those earlier invalid lanes)."""
    words = rng.integers(0, 1 << 62, n).astype(np.uint64)
    words[n // 2: n // 2 + n // 8] = words[: n // 8]
    valid = rng.random(n) >= 0.2
    valid[:5] = False
    words[5] = ju.to_numpy(ju.feistel_unmix(jax_u64(np.array([MAX64],
                                                             np.uint64)),
                                            alias_seed))[0]
    valid[5] = True
    return words, valid


def answer_of(words, valid, shard):
    """The owners' test answer: low 24 bits of the word and the owner."""
    return torch.where(valid, ((words & 0xFFFFFF) + (shard << 24))
                       .to(torch.int32), -1)


def jax_route_queries(d, words, valid, capacity, seed):
    m = jmesh.make_mesh(d)

    def body(hi, lo, v):
        recv, rv, reply, overflow = jroute.route_queries(
            U64(hi, lo), v, "d", capacity, seed)
        ans = ((recv.lo & 0xFFFFFF).astype(jnp.int32)
               + (jax.lax.axis_index("d") << 24).astype(jnp.int32))
        back = reply(jnp.where(rv, ans, -1))
        return recv.hi, recv.lo, rv, overflow[None], back

    fn = jax.jit(shard_map(body, mesh=m, in_specs=(P("d"),) * 3,
                           out_specs=(P("d"),) * 5))
    q = jax_u64(words)
    put = lambda x: jax.device_put(x, jmesh.batch_sharding(m))
    r_hi, r_lo, rv, ov, back = fn(put(q.hi), put(q.lo),
                                  put(jnp.asarray(valid)))
    recv = (np.asarray(r_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        r_lo)
    shape = (d, d, capacity)
    return (recv.reshape(shape), np.asarray(rv).reshape(shape),
            np.asarray(ov), np.asarray(back))


@pytest.mark.parametrize("d,capacity", [(2, 64), (2, 20), (3, 64), (3, 12),
                                        (8, 64), (8, 5)])
@pytest.mark.parametrize("seed", [0, 9])
def test_route_queries_matches_jax(d, capacity, seed):
    """Received words and validity on every lane, per-sender overflow and
    the replies, with 64 queries a sender; the smaller capacity
    overflows."""
    n = 64 * d
    rng = np.random.default_rng(d * capacity + seed)
    words, valid = query_lanes(rng, n, seed)
    j_recv, j_valid, j_ov, j_back = jax_route_queries(d, words, valid,
                                                      capacity, seed)
    mesh = tmesh.make_mesh(devices=["cpu"] * d)
    routed, reply = troute.route_queries(
        tmesh.batch_sharding(t64(words), mesh),
        tmesh.batch_sharding(torch.from_numpy(valid), mesh), mesh, capacity,
        seed)
    for r, rq in enumerate(routed):
        assert rq.words.shape == rq.valid.shape == (d, capacity)
        np.testing.assert_array_equal(rq.words.numpy().view(np.uint64),
                                      j_recv[r])
        np.testing.assert_array_equal(rq.valid.numpy(), j_valid[r])
    np.testing.assert_array_equal([int(rq.overflow) for rq in routed], j_ov)
    back = reply([answer_of(rq.words, rq.valid, r)
                  for r, rq in enumerate(routed)])
    got = torch.cat(back).numpy()
    np.testing.assert_array_equal(got, j_back)
    overflow = int(sum(int(rq.overflow) for rq in routed))
    answered = got != -1
    assert not answered[~valid].any()
    assert answered.sum() == valid.sum() - overflow
    assert (overflow > 0) == (capacity < 64)
    if not overflow:
        assert answered[5]                 # the query whose mix is MAX
        assert (got[answered] & 0xFFFFFF == words[answered].astype(np.int64)
                & 0xFFFFFF).all()


# -- make_sharded_lookup and lookup_sharded -------------------------------------------

K = 21


def sharded_tables(d):
    """make_sharded_counter's compact tables of one read batch, in both
    packages, and the batch's single-device counts."""
    rows = genome_reads(48, 64, n_rate=0.0)
    cap = 4224 // d           # twice a sender's 2112 / D windows
    jm = jmesh.make_mesh(d)
    jres = jpipe.make_sharded_counter(jm, K, route_capacity=cap)(
        jax.device_put(jnp.asarray(rows), jmesh.batch_sharding(jm)))
    tm = tmesh.make_mesh(devices=["cpu"] * d)
    tres = tpipe.make_sharded_counter(tm, K, route_capacity=cap)(
        torch.from_numpy(rows))
    assert int(tres.metrics["route_overflow"]) == 0
    sc = StreamingCounter(K, 1 << 14, device="cpu")
    sc.update(rows)
    return jm, jres.table, tm, tres.table, dict(sc.to_pairs())


def lookup_queries(want: dict, n: int = 96):
    """Present, absent (random 2k-bit words) and invalid queries."""
    rng = np.random.default_rng(n)
    present = sorted(want)
    words = np.zeros(n, np.uint64)
    valid = np.ones(n, bool)
    for i in range(n):
        if i % 4 == 3:
            words[i] = int(rng.integers(0, 1 << (2 * K)))
        elif i % 4 == 2:
            valid[i] = False
        else:
            words[i] = present[(7 * i) % len(present)]
    return words, valid


@pytest.mark.parametrize("d,merge,capacity", [
    (d, merge, cap) for d in (1, 2, 3, 8) for merge in (False, True)
    for cap in (96, 1) if not merge or cap == 96 or d == 8])
def test_make_sharded_lookup_matches_jax(d, merge, capacity):
    """Both answer arms against kmers_tpu's (the merge arm in interpret
    mode) on make_sharded_counter's tables: counts, -1 for invalid and
    overflowed queries (capacity 1), and the summed overflow; at a
    capacity that drops nothing, the single-device counts."""
    jm, jt, tm, tt, want = sharded_tables(d)
    words, valid = lookup_queries(want)
    put = lambda x: jax.device_put(x, jmesh.batch_sharding(jm))
    q = jax_u64(words)
    j_counts, j_ov = jpipe.make_sharded_lookup(
        jm, query_capacity=capacity, max_k=K, merge_lookup=merge,
        interpret=True)(jt, put(q.hi), put(q.lo), put(jnp.asarray(valid)))
    kernels.reset_launch_counts()
    counts, overflow = tpipe.make_sharded_lookup(
        tm, query_capacity=capacity, max_k=K, merge_lookup=merge)(
            tt, t64(words), torch.from_numpy(valid))
    assert counts.dtype == torch.int32 and counts.shape == (96,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert int(overflow) == int(j_ov)
    assert (int(overflow) > 0) == (capacity == 1)
    if not int(overflow):
        expect = [want.get(int(w), 0) if v else -1
                  for w, v in zip(words, valid)]
        assert counts.tolist() == expect


def test_sharded_lookup_default_arm_and_refusal():
    """The default arm (the binary search) and the merge give the same
    counts; merge_lookup=True past k = 31 raises (kmers_tpu answers
    wrongly there)."""
    _, _, tm, tt, want = sharded_tables(2)
    words, valid = lookup_queries(want)
    args = (tt, t64(words), torch.from_numpy(valid))
    default, _ = tpipe.make_sharded_lookup(tm, query_capacity=96, max_k=K)(
        *args)
    merged, _ = tpipe.make_sharded_lookup(tm, query_capacity=96, max_k=K,
                                          merge_lookup=True)(*args)
    assert torch.equal(default, merged)
    with pytest.raises(ValueError, match="merge_lookup"):
        tpipe.make_sharded_lookup(tm, query_capacity=8, max_k=32,
                                  merge_lookup=True)
    tpipe.make_sharded_lookup(tm, query_capacity=8, max_k=32)


@pytest.mark.parametrize("d,seed", [(1, 0), (3, 0), (8, 0), (8, 5)])
def test_lookup_sharded_matches_jax(d, seed):
    """Each query against its owner's table: kmers_tpu's answers, which
    are the single-device counts (0 where absent); seed 5 sends most
    queries to a table that does not hold them."""
    jm, jt, _, tt, want = sharded_tables(d)
    words, _ = lookup_queries(want)
    got = tpipe.lookup_sharded(tt, t64(words), d, seed=seed)
    expect = np.asarray(jpipe.lookup_sharded(jt, jax_u64(words), d,
                                             seed=seed))
    np.testing.assert_array_equal(got.numpy(), expect)
    if seed == 0:
        assert got.tolist() == [want.get(int(w), 0) for w in words]
    with pytest.raises(ValueError):
        tpipe.lookup_sharded(tt, t64(words), d + 1)
