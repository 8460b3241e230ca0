"""Merge (K3) and compress (K4) kernels of the port, and the consolidation
built on them, against the JAX package on the CPU (Pallas in interpret
mode).  The CUDA kernels are compared with these plain versions on the
card by test_torch_cuda.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from kmers_tpu.core.u64 import U64
from kmers_tpu.kernels import merge as jmerge
from kmers_tpu.parallel import count as jcount
from kmers_tpu_torch import kernels
from kmers_tpu_torch.kernels import merge as tmerge
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel.stream import _sort_units


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def table_planes(rng, n_live, cap, bits):
    """A sorted table: unique live keys with counts, then dead
    (MAX, MAX, 0) lanes."""
    if bits <= 20:
        keys = rng.choice(1 << bits, size=n_live, replace=False)
    else:
        keys = rng.permutation(np.unique(rng.integers(
            0, 1 << bits, 2 * n_live + 8, dtype=np.uint64)))[:n_live]
    keys = np.sort(keys.astype(np.uint64))
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    w = np.zeros(cap, np.uint32)
    hi[:n_live] = keys >> np.uint64(32)
    lo[:n_live] = keys & np.uint64(0xFFFFFFFF)
    w[:n_live] = rng.integers(1, 50, n_live)
    return hi, lo, w, keys


def unit_planes(rng, n, n_valid, bits, table_keys=None):
    """Sorted folded unit keys: n_valid live (some drawn from the table's
    keys when given), the rest dead (0x80000000, 0) at the end."""
    keys = rng.integers(0, 1 << bits, n_valid).astype(np.uint64)
    if table_keys is not None and table_keys.size:
        dup = rng.random(n_valid) < 0.5
        keys[dup] = rng.choice(table_keys, size=int(dup.sum()))
    keys = np.sort(keys)
    hi = np.full(n, 0x80000000, np.uint32)
    lo = np.zeros(n, np.uint32)
    hi[:n_valid] = keys >> np.uint64(32)
    lo[:n_valid] = keys & np.uint64(0xFFFFFFFF)
    return hi, lo


@pytest.mark.parametrize("nA,capA,nB,totB,bits", [
    (0, 512, 300, 512, 8),
    (512, 512, 0, 512, 10),
    (15, 1024, 1500, 2048, 4),     # heavy duplicates across A and B
    (300, 700, 1200, 1300, 40),    # keys above 2^32, ragged lengths
])
def test_merge_sorted_plain_matches_pallas(nA, capA, nB, totB, bits):
    rng = np.random.default_rng(nA + nB)
    a_hi, a_lo, a_w, keys = table_planes(rng, nA, capA, bits)
    b_hi, b_lo = unit_planes(rng, totB, nB, bits, keys)
    want = jmerge.merge_sorted(*(jnp.asarray(x) for x in
                                 (a_hi, a_lo, a_w, b_hi, b_lo)),
                               tile=1024, interpret=True)
    got = tmerge.merge_sorted_plain(*(t32(x) for x in
                                      (a_hi, a_lo, a_w, b_hi, b_lo)))
    n = capA + totB
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_array_equal(as_u32(g), np.asarray(w)[:n])


@pytest.mark.parametrize("n,p_keep", [(20000, 0.3), (3000, 1.0),
                                      (65537, 0.5), (65537, 0.0)])
def test_compress_flagged_plain_matches_pallas(n, p_keep):
    """Across JAX's 65536-lane block, and with nothing kept."""
    rng = np.random.default_rng(n)
    planes = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(3)]
    keep = (rng.random(n) < p_keep).astype(np.uint8)
    want = jmerge.compress_flagged(*(jnp.asarray(x) for x in planes),
                                   jnp.asarray(keep), interpret=True)
    got = tmerge.compress_flagged_plain(*(t32(x) for x in planes),
                                        torch.from_numpy(keep))
    cnt = int(keep.sum())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_u32(g)[:cnt], np.asarray(w)[:cnt])


@pytest.mark.parametrize("cap,n_live,n_units,valid_frac,bits", [
    (4096, 3000, 8192, 0.8, 16),
    (4096, 0, 8192, 0.5, 8),
    (2048, 64, 4096, 1.0, 6),
    (1024, 512, 16384, 0.3, 30),
    (1024, 100, 2048, 0.0, 10),
])
def test_merge_table_with_sorted_units_matches_merge_many(
        cap, n_live, n_units, valid_frac, bits):
    """The port's consolidation against kmers_tpu's sort-based merge."""
    rng = np.random.default_rng(cap + n_live + bits)
    n_live = min(n_live, 1 << bits)
    a_hi, a_lo, a_w, keys = table_planes(rng, n_live, cap, bits)
    # a count table stores zeros, not sentinels, past n_unique
    a_hi[n_live:] = 0
    a_lo[n_live:] = 0
    n_valid = int(n_units * valid_frac)
    u_hi, u_lo = unit_planes(rng, n_units, n_valid, bits, keys)
    perm = rng.permutation(n_units)          # pending units arrive unsorted
    u_hi, u_lo = u_hi[perm], u_lo[perm]

    jt = jcount.CountTable(keys=U64(jnp.asarray(a_hi), jnp.asarray(a_lo)),
                           counts=jnp.asarray(a_w.astype(np.int32)),
                           n_unique=jnp.int32(n_live))
    ju = jcount.UnitTable(keys=U64(jnp.asarray(u_hi), jnp.asarray(u_lo)))
    want = jcount.merge_many([jt, ju], max_k=31)

    tt = tcount.CountTable(t32(a_hi), t32(a_lo),
                           torch.from_numpy(a_w.astype(np.int32)), n_live)
    s_hi, s_lo = _sort_units([tcount.UnitTable(t32(u_hi), t32(u_lo))])
    got = tcount.merge_table_with_sorted_units(tt, s_hi, s_lo)

    nu = int(want.n_unique)
    assert got.n_unique == nu
    assert got.capacity == max(cap, nu)
    np.testing.assert_array_equal(as_u32(got.keys_hi)[:nu],
                                  np.asarray(want.keys.hi)[:nu])
    np.testing.assert_array_equal(as_u32(got.keys_lo)[:nu],
                                  np.asarray(want.keys.lo)[:nu])
    np.testing.assert_array_equal(got.counts.numpy()[:nu],
                                  np.asarray(want.counts)[:nu])
    assert (got.counts.numpy()[nu:] == 0).all()
    assert (got.keys_hi.numpy()[nu:] == 0).all()


def test_lookup_matches_jax():
    rng = np.random.default_rng(8)
    a_hi, a_lo, a_w, keys = table_planes(rng, 500, 1024, 36)
    a_hi[500:] = 0
    a_lo[500:] = 0
    queries = np.concatenate([rng.choice(keys, 200),
                              rng.integers(0, 1 << 36, 200).astype(np.uint64)])
    jt = jcount.CountTable(keys=U64(jnp.asarray(a_hi), jnp.asarray(a_lo)),
                           counts=jnp.asarray(a_w.astype(np.int32)),
                           n_unique=jnp.int32(500))
    want = jcount.lookup(jt, U64(
        jnp.asarray((queries >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((queries & np.uint64(0xFFFFFFFF)).astype(np.uint32))))
    tt = tcount.CountTable(t32(a_hi), t32(a_lo),
                           torch.from_numpy(a_w.astype(np.int32)), 500)
    got = tcount.lookup(tt, torch.from_numpy(queries.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_merge_wrappers_take_plain_on_cpu_and_check_inputs():
    rng = np.random.default_rng(2)
    a = [t32(x) for x in table_planes(rng, 10, 16, 8)[:3]]
    b = [t32(x) for x in unit_planes(rng, 16, 12, 8)]
    kernels.reset_launch_counts()
    got = tmerge.merge_sorted(*a, *b)
    assert all(torch.equal(x, y)
               for x, y in zip(got, tmerge.merge_sorted_plain(*a, *b)))
    keep = torch.zeros(16, dtype=torch.uint8)
    keep[::3] = 1
    got = tmerge.compress_flagged(*a, keep)
    assert all(torch.equal(x, y) for x, y in
               zip(got, tmerge.compress_flagged_plain(*a, keep)))
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        tmerge.merge_sorted(a[0][:5], *a[1:], *b)
    with pytest.raises(TypeError):
        tmerge.compress_flagged(*a, keep.to(torch.int32))
