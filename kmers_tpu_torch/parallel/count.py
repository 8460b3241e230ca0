"""Single-device count tables (counterpart of ``kmers_tpu/parallel/count.py``).

Tables hold int32 planes of uint32 bit patterns, as the JAX package's
U64 / U128 lane pairs do, so that the kernels and the checkpoint read them
as they are.  A table's keys ascend as unsigned words over its planes,
most significant plane first; slots past n_unique are zero.  Two key
widths, one code path:

  k <= 31        CountTable / UnitTable, planes (hi, lo)
  33 <= k <= 63  CountTableWide / UnitTableWide, planes (hh, hl, lh, ll)

This module holds the streaming path: ``unit_table(_wide)`` per batch,
and ``merge_table_with_sorted_units(_wide)`` (the merge kernel K3 / K6,
run starts, a weight cumsum and the compress kernel K4) per
consolidation, and ``lookup(_wide)``.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch

from ..core import u64, u128
from ..kernels import merge as kmerge

UNIT_INVALID_HI = 0x80000000                  # folded invalid flag (uint32)
_INVALID_HI_I32 = UNIT_INVALID_HI - (1 << 32)  # its int32 bit pattern


class CountTable(NamedTuple):
    """Fixed-capacity k-mer count table (k <= 31).

    keys_hi, keys_lo: int32 [cap] planes, ascending as unsigned (hi, lo)
    over the first n_unique slots, zero past them.
    counts: int32 [cap], zero past n_unique.
    n_unique: number of live slots.
    """

    keys_hi: torch.Tensor
    keys_lo: torch.Tensor
    counts: torch.Tensor
    n_unique: int

    @property
    def capacity(self) -> int:
        return self.counts.shape[-1]

    @property
    def keys(self) -> tuple:
        return self.keys_hi, self.keys_lo


class UnitTable(NamedTuple):
    """Per-batch passthrough table: every valid lane is one occurrence.

    keys in the folded spare-bit layout (k <= 31): bit 31 of hi is the
    invalid flag; invalid lanes are exactly (0x80000000, 0)."""

    keys_hi: torch.Tensor
    keys_lo: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys_lo.numel()

    @property
    def keys(self) -> tuple:
        return self.keys_hi, self.keys_lo


class CountTableWide(NamedTuple):
    """Fixed-capacity count table of 128-bit keys (33 <= k <= 63).

    keys: (hh, hl, lh, ll) int32 [cap] planes, most significant first,
    ascending as unsigned 128-bit words over the first n_unique slots,
    zero past them.  counts, n_unique: as CountTable's.
    """

    keys: tuple
    counts: torch.Tensor
    n_unique: int

    @property
    def capacity(self) -> int:
        return self.counts.shape[-1]


class UnitTableWide(NamedTuple):
    """Per-batch passthrough table of 128-bit keys: bit 31 of hh is the
    invalid flag (clear in any k <= 63 key); invalid lanes are exactly
    (0x80000000, 0, 0, 0)."""

    keys: tuple

    @property
    def capacity(self) -> int:
        return self.keys[-1].numel()


def make_table(keys: tuple, counts: torch.Tensor, n_unique: int):
    """CountTable for two key planes, CountTableWide for four."""
    if len(keys) == 2:
        return CountTable(*keys, counts, n_unique)
    return CountTableWide(tuple(keys), counts, n_unique)


def empty_table(capacity: int, device) -> CountTable:
    z = torch.zeros(capacity, dtype=torch.int32, device=device)
    return CountTable(z, z.clone(), z.clone(), 0)


def empty_table_wide(capacity: int, device) -> CountTableWide:
    z = torch.zeros(capacity, dtype=torch.int32, device=device)
    return CountTableWide(tuple(z.clone() for _ in range(4)), z, 0)


def unit_table(words: torch.Tensor, valid: torch.Tensor) -> UnitTable:
    """Wrap canonical int64 words + validity as a UnitTable; invalid lanes
    become exactly (0x80000000, 0)."""
    return UnitTable(*u64.fold_invalid(words, valid))


def unit_table_wide(words: tuple, valid: torch.Tensor) -> UnitTableWide:
    """Wrap canonical (hi, lo) words + validity as a UnitTableWide
    (k <= 63); invalid lanes become exactly (0x80000000, 0, 0, 0)."""
    return UnitTableWide(u128.fold_invalid(*words, valid))


def empty_like_table(t):
    """An all-dead table of t's shape (consolidation padding).  A unit
    table lane must carry the INVALID pattern (0x80000000, 0[, 0, 0]): an
    all-zero unit table would claim `capacity` occurrences of key 0."""
    if isinstance(t, (UnitTable, UnitTableWide)):
        keys = (torch.full_like(t.keys[0], _INVALID_HI_I32),) + tuple(
            torch.zeros_like(p) for p in t.keys[1:])
        return UnitTable(*keys) if len(keys) == 2 else UnitTableWide(keys)
    return make_table(tuple(torch.zeros_like(p) for p in t.keys),
                      torch.zeros_like(t.counts), 0)


def sort_unit_keys(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """Folded unit keys (any shape) -> one unsigned sort of them, flagged
    lanes last, as (hi, lo) int32 planes.  Equal keys are interchangeable
    (unit weight), so no stability is needed."""
    key = u64.to_unsigned_order(u64.join_planes(hi.reshape(-1),
                                                lo.reshape(-1)))
    return u64.split_word(u64.to_unsigned_order(torch.sort(key).values))


def _counts_from_positions(pos: torch.Tensor, idx: torch.Tensor,
                           n_unique: int, last_total: torch.Tensor
                           ) -> torch.Tensor:
    """counts[g] = pos[g+1] - pos[g] for slots g < n_unique, the last run
    closed by `last_total`.  pos holds uint32 prefix sums as int64; the
    difference is taken mod 2^32, exact for every count below 2^31 (as
    the JAX package's uint32 differences are).  Returns int32."""
    live = idx < n_unique
    nxt = torch.where(idx + 1 < n_unique, torch.roll(pos, -1), last_total)
    return u64.low32_as_int32(torch.where(live, (nxt - pos) & u64.LOW32, 0))


def _merge_with_sorted_units(table, b_keys: tuple, merge):
    """The body of both widths: `merge` (K3 or K6) of the table, dead
    slots as MAX sentinels, with the sorted unit keys; run starts; an
    int64 weight cumsum; K4 over the key planes and the exclusive cumsum,
    three planes a pass; run counts as differences of the compacted
    prefix sums.  Returns the merged table (capacity = table.capacity +
    number of unit keys)."""
    cap = table.capacity
    device = table.counts.device
    live = torch.arange(cap, device=device) < table.n_unique
    # dead table slots become MAX sentinels, so A ascends with its dead
    # tail last
    a_keys = tuple(torch.where(live, p, -1) for p in table.keys)
    a_w = torch.where(live, table.counts, 0)
    m_keys, m_w = merge(a_keys, a_w, b_keys)
    n = m_w.shape[0]
    pos = torch.arange(n, device=device)
    valid = m_keys[0] >= 0                # flag bit clear; valid lanes first
    # lane 0's "previous key" differs from it in plane 0
    first = [m_keys[0][:1] ^ 1] + [p[:1] for p in m_keys[1:]]
    starts = valid & functools.reduce(operator.or_, (
        p != torch.cat([f, p[:-1]]) for p, f in zip(m_keys, first)))
    mw = torch.where(valid, u64.as_uint32(m_w), 0)
    csum = torch.cumsum(mw, 0)
    planes = list(m_keys) + [u64.low32_as_int32(csum - mw)]
    keep = starts.to(torch.uint8)
    compact = []
    for i in range(0, len(planes), 3):    # K4 carries three planes
        chunk = planes[i:i + 3]
        out = kmerge.compress_flagged(*(chunk + [chunk[0]] * (3 - len(chunk))),
                                      keep)
        compact += out[:len(chunk)]
    n_unique = int(starts.sum())
    live2 = pos < n_unique
    counts = _counts_from_positions(u64.as_uint32(compact[-1]), pos, n_unique,
                                    csum[-1] & u64.LOW32)
    return make_table(tuple(torch.where(live2, c, 0) for c in compact[:-1]),
                      counts, n_unique)


def _merge_narrow(a_keys, a_w, b_keys):
    m_hi, m_lo, m_w = kmerge.merge_sorted(*a_keys, a_w, *b_keys)
    return (m_hi, m_lo), m_w


def merge_table_with_sorted_units(table: CountTable, s_hi: torch.Tensor,
                                  s_lo: torch.Tensor) -> CountTable:
    """Weighted merge of a compact key-sorted CountTable with PRE-SORTED
    unit keys (folded layout, invalid lanes flagged and sorted last):
    K3, run starts, a weight cumsum, one K4 pass
    (kmers_tpu/parallel/count.py:424)."""
    return _merge_with_sorted_units(table, (s_hi, s_lo), _merge_narrow)


def merge_table_with_sorted_units_wide(table: CountTableWide,
                                       s_keys: tuple) -> CountTableWide:
    """merge_table_with_sorted_units for 128-bit keys: s_keys = four
    planes ascending as unsigned words with the folded dead flag sorted
    last.  K6, run starts, a weight cumsum, two K4 passes
    (kmers_tpu/parallel/count.py:840-888)."""
    return _merge_with_sorted_units(table, tuple(s_keys),
                                    kmerge.merge_sorted_wide)


def lookup(table: CountTable, queries: torch.Tensor) -> torch.Tensor:
    """Count of each int64 query word (0 if absent), by binary search over
    the live keys (k <= 31 keys are non-negative as int64)."""
    nu = table.n_unique
    if nu == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    keys = u64.join_planes(table.keys_hi[:nu], table.keys_lo[:nu])
    at = torch.searchsorted(keys, queries)
    at_c = at.clamp(max=nu - 1)
    hit = (at < nu) & (keys[at_c] == queries)
    return torch.where(hit, table.counts[at_c], 0)


def lookup_wide(table: CountTableWide, q_hi: torch.Tensor,
                q_lo: torch.Tensor) -> torch.Tensor:
    """Count of each 128-bit query word (q_hi, q_lo int64; 0 if absent),
    by a branch-free binary search over the live keys: torch.searchsorted
    has no 128-bit key (kmers_tpu/parallel/count.py:891)."""
    nu = table.n_unique
    if nu == 0:
        return torch.zeros(q_lo.shape, dtype=torch.int32, device=q_lo.device)
    k_hi, k_lo = u128.sort_keys(*u128.join_planes(
        *(p[:nu] for p in table.keys)))
    qh, ql = u128.sort_keys(q_hi, q_lo)
    lo = torch.zeros(q_lo.shape, dtype=torch.int64, device=q_lo.device)
    hi = torch.full_like(lo, nu)
    for _ in range(nu.bit_length()):
        mid = (lo + hi) // 2
        m = mid.clamp(max=nu - 1)
        key_lt = (k_hi[m] < qh) | ((k_hi[m] == qh) & (k_lo[m] < ql))
        active = lo < hi
        lo, hi = (torch.where(active & key_lt, mid + 1, lo),
                  torch.where(active & ~key_lt, mid, hi))
    at = lo.clamp(max=nu - 1)
    hit = (lo < nu) & u128.eq(k_hi[at], k_lo[at], qh, ql)
    return torch.where(hit, table.counts[at], 0)
