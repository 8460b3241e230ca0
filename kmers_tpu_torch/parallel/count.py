"""Single-device count tables (counterpart of ``kmers_tpu/parallel/count.py``).

Tables hold int32 planes of uint32 bit patterns, as the JAX package's
U64 pairs do, so that the kernels and the checkpoint read them as they
are.  A table's keys ascend as unsigned (hi, lo); slots past n_unique
are zero.  This module holds the k <= 31 streaming path only:
``unit_table`` per batch, and ``merge_table_with_sorted_units`` (the
merge kernel, run starts, a weight cumsum and the compress kernel) per
consolidation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import u64
from ..kernels import merge as kmerge

UNIT_INVALID_HI = 0x80000000                  # folded invalid flag (uint32)
_INVALID_HI_I32 = UNIT_INVALID_HI - (1 << 32)  # its int32 bit pattern


class CountTable(NamedTuple):
    """Fixed-capacity k-mer count table.

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


class UnitTable(NamedTuple):
    """Per-batch passthrough table: every valid lane is one occurrence.

    keys in the folded spare-bit layout (k <= 31): bit 31 of hi is the
    invalid flag; invalid lanes are exactly (0x80000000, 0)."""

    keys_hi: torch.Tensor
    keys_lo: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys_lo.numel()


def empty_table(capacity: int, device) -> CountTable:
    z = torch.zeros(capacity, dtype=torch.int32, device=device)
    return CountTable(z, z.clone(), z.clone(), 0)


def unit_table(words: torch.Tensor, valid: torch.Tensor) -> UnitTable:
    """Wrap canonical int64 words + validity as a UnitTable; invalid lanes
    become exactly (0x80000000, 0)."""
    return UnitTable(*u64.fold_invalid(words, valid))


def empty_like_table(t):
    """An all-dead table of t's shape (consolidation padding).  A
    UnitTable lane must carry the INVALID pattern (0x80000000, 0): an
    all-zero UnitTable would claim `capacity` occurrences of key 0."""
    if isinstance(t, UnitTable):
        return UnitTable(torch.full_like(t.keys_hi, _INVALID_HI_I32),
                         torch.zeros_like(t.keys_lo))
    return CountTable(torch.zeros_like(t.keys_hi), torch.zeros_like(t.keys_lo),
                      torch.zeros_like(t.counts), 0)


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


def merge_table_with_sorted_units(table: CountTable, s_hi: torch.Tensor,
                                  s_lo: torch.Tensor) -> CountTable:
    """Weighted merge of a compact key-sorted CountTable with PRE-SORTED
    unit keys (folded layout, invalid lanes flagged and sorted last).

    Two kernel passes and cheap scans: the merge kernel (K3), run starts,
    an int64 weight cumsum, the compress kernel (K4) over the run starts,
    and run counts as differences of the compacted prefix sums.  Capacity
    of the result = table.capacity + number of unit keys."""
    cap = table.capacity
    device = table.counts.device
    live = torch.arange(cap, device=device) < table.n_unique
    # dead table slots become MAX sentinels, so A ascends with its dead
    # tail last
    a_hi = torch.where(live, table.keys_hi, -1)
    a_lo = torch.where(live, table.keys_lo, -1)
    a_w = torch.where(live, table.counts, 0)
    m_hi, m_lo, m_w = kmerge.merge_sorted(a_hi, a_lo, a_w, s_hi, s_lo)
    n = m_hi.shape[0]
    pos = torch.arange(n, device=device)
    valid = m_hi >= 0                     # flag bit clear; valid lanes first
    prev_hi = torch.cat([m_hi[:1] ^ 1, m_hi[:-1]])
    prev_lo = torch.cat([m_lo[:1], m_lo[:-1]])
    starts = valid & ((m_hi != prev_hi) | (m_lo != prev_lo))
    mw = torch.where(valid, u64.as_uint32(m_w), 0)
    csum = torch.cumsum(mw, 0)
    csum_excl = csum - mw
    c_hi, c_lo, c_excl = kmerge.compress_flagged(
        m_hi, m_lo, u64.low32_as_int32(csum_excl), starts.to(torch.uint8))
    n_unique = int(starts.sum())
    live2 = pos < n_unique
    counts = _counts_from_positions(u64.as_uint32(c_excl), pos, n_unique,
                                    csum[-1] & u64.LOW32)
    return CountTable(torch.where(live2, c_hi, 0), torch.where(live2, c_lo, 0),
                      counts, n_unique)


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
