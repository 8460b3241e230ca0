"""The port's sequence parallelism against the JAX package, on the CPU:
halo_exchange, sharded_windows(_wide) and make_sequence_parallel_counter
over the port's mesh of 8 CPU shards and kmers_tpu's 8-device CPU mesh
(tests/conftest.py), shard by shard, lane for lane and metric by metric,
on one seeded sequence with Ns (tests/test_halo.py:53-86).  Zero
tolerance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kmers_tpu.parallel import halo as jhalo
from kmers_tpu.parallel import mesh as jmesh
from kmers_tpu.parallel import pipeline as jpipe
from kmers_tpu_torch.core import u64 as tu
from kmers_tpu_torch.parallel import halo as thalo
from kmers_tpu_torch.parallel import mesh as tmesh
from kmers_tpu_torch.parallel import pipeline as tpipe
from kmers_tpu_torch.parallel.stream import StreamingCounter

from test_torch_sharded import D
from test_torch_sharded_wide import assert_same_metrics, assert_same_tables


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(D), tmesh.make_mesh(devices=["cpu"] * D)


def sequence(g: int, seed: int = 777, n_count: int = 5) -> np.ndarray:
    """[g] ASCII bases with n_count Ns at seeded positions."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, g)].copy()
    seq[rng.integers(0, g, n_count)] = ord("N")
    return seq


def blocks_of(seq: np.ndarray, mesh) -> list:
    return tmesh.batch_sharding(torch.from_numpy(seq), mesh)


def run_jax(body, jm, seq, out_specs):
    fn = jax.jit(shard_map(body, mesh=jm, in_specs=(P("d"),),
                           out_specs=out_specs))
    return fn(jax.device_put(jnp.asarray(seq), jmesh.batch_sharding(jm)))


def test_shift_left_is_a_left_ppermute():
    """Receiver i gets shard i + 1's buffer, the last shard zeros of its
    own shape; a buffer count off the mesh size raises."""
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    bufs = [torch.arange(4) + 10 * (s + 1) for s in range(3)]
    got = tmesh.shift_left(bufs, mesh)
    assert torch.equal(got[0], bufs[1]) and torch.equal(got[1], bufs[2])
    assert torch.equal(got[2], torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tmesh.shift_left(bufs[:2], mesh)


@pytest.mark.parametrize("halo", [1, 20, 63, 100])
def test_halo_exchange_matches_jax(halo, meshes):
    """Each shard's block and its right neighbour's first `halo` bytes
    (all 64 when halo > 64), zeros on the last shard."""
    jm, tm = meshes
    seq = sequence(D * 64, seed=halo)
    want = np.asarray(run_jax(lambda b: jhalo.halo_exchange(b, halo, "d"),
                              jm, seq, P("d"))).reshape(D, -1)
    got = thalo.halo_exchange(blocks_of(seq, tm), halo, tm)
    for s in range(D):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
    assert not got[-1][64:].any()


@pytest.mark.parametrize("k", [5, 21, 32, 33, 63, 64])
def test_sharded_windows_match_jax(k, meshes):
    """fw, rc and valid of every extended block, lane for lane."""
    jm, tm = meshes
    seq = sequence(D * 64, seed=k)
    wide = k > 32

    def body(block):
        if wide:
            win = jhalo.sharded_windows_wide(block, k, "d")
            return (win.fw.hi.hi, win.fw.hi.lo, win.fw.lo.hi, win.fw.lo.lo,
                    win.rc.hi.hi, win.rc.hi.lo, win.rc.lo.hi, win.rc.lo.lo,
                    win.valid)
        win = jhalo.sharded_windows(block, k, "d")
        return win.fw.hi, win.fw.lo, win.rc.hi, win.rc.lo, win.valid

    n_out = 9 if wide else 5
    want = [np.asarray(a).reshape(D, -1)
            for a in run_jax(body, jm, seq, (P("d"),) * n_out)]
    fn = thalo.sharded_windows_wide if wide else thalo.sharded_windows
    got = fn(blocks_of(seq, tm), k, tm)
    for s, win in enumerate(got):
        assert win.n_windows == 64
        words = (win.fw + win.rc) if wide else (win.fw, win.rc)
        planes = [p for w in words for p in tu.split_word(w)]
        for tp, jp in zip(planes, want):
            np.testing.assert_array_equal(
                tp.numpy().view(np.uint32).reshape(-1), jp[s])
        np.testing.assert_array_equal(win.valid.numpy().reshape(-1),
                                      want[-1][s])


def jax_counter_result(jm, seq, k, cap):
    return jpipe.make_sequence_parallel_counter(jm, k, route_capacity=cap)(
        jax.device_put(jnp.asarray(seq), jmesh.batch_sharding(jm)))


@pytest.mark.parametrize("k", [21, 31, 32, 63, 64])
def test_sequence_parallel_counter_matches_jax(k, meshes):
    """One 512-base sequence with Ns over 8 shards: per-shard compact
    tables and the three metrics equal the JAX package's, and the union
    of the shard tables (no key on two shards) is the single-device count
    of the whole sequence, windows across the cuts included."""
    jm, tm = meshes
    seq = sequence(D * 64)
    jres = jax_counter_result(jm, seq, k, 128)
    tres = tpipe.make_sequence_parallel_counter(tm, k, route_capacity=128)(
        torch.from_numpy(seq))
    assert_same_tables(jres.table, tres.table)
    assert_same_metrics(jres, tres)
    assert int(tres.metrics["route_overflow"]) == 0
    merged = tpipe.global_table(tres)
    assert merged.n_unique == sum(t.n_unique for t in tres.table)
    flat = StreamingCounter(k, 1 << 12, device="cpu")
    flat.update(seq[None, :])
    flat.to_pairs()
    assert flat.kmers == int(tres.metrics["kmers_emitted"])
    nu = merged.n_unique
    for a, b in zip(merged.keys, flat.table.keys):
        assert torch.equal(a[:nu], b[:nu])
    assert torch.equal(merged.counts[:nu], flat.table.counts[:nu])


def test_blocks_shorter_than_the_halo_match_jax(meshes):
    """L = 16 < k - 1 = 20: the halo is the whole 16-byte next block, as in
    the JAX package, so a window spanning two cuts is never formed.  The
    shards equal JAX's; the k-mers counted are the valid windows starting
    at offset <= 2 * 16 - 21 of a block."""
    jm, tm = meshes
    k, L = 21, 16
    seq = sequence(D * L, seed=3, n_count=2)
    jres = jax_counter_result(jm, seq, k, 64)
    tres = tpipe.make_sequence_parallel_counter(tm, k, route_capacity=64)(
        torch.from_numpy(seq))
    assert_same_tables(jres.table, tres.table)
    assert_same_metrics(jres, tres)
    ok = np.frombuffer(b"ACGT", np.uint8)
    formed = [p for p in range(D * L - k + 1)
              if p % L <= 2 * L - k and np.isin(seq[p:p + k], ok).all()]
    assert int(tres.metrics["kmers_emitted"]) == len(formed)
    whole = [p for p in range(D * L - k + 1)
             if np.isin(seq[p:p + k], ok).all()]
    assert len(formed) < len(whole)


def test_sequence_not_divisible_raises(meshes):
    """G % D != 0 is a ValueError, as JAX's shard_map refuses it."""
    jm, tm = meshes
    seq = sequence(D * 64 + 3)
    with pytest.raises(ValueError):
        tpipe.make_sequence_parallel_counter(tm, 21, route_capacity=64)(
            torch.from_numpy(seq))
    with pytest.raises(ValueError):
        jax_counter_result(jm, seq, 21, 64)
