"""Single-device count tables (counterpart of ``kmers_tpu/parallel/count.py``).

Tables hold int32 planes of uint32 bit patterns, as the JAX package's
U64 / U128 lane pairs do, so that the kernels and the checkpoint read them
as they are.  A table's keys ascend as unsigned words over its planes,
most significant plane first; slots past n_unique are zero.  Two key
widths, one code path:

  k <= 32        CountTable / UnitTable, planes (hi, lo)
  33 <= k <= 64  CountTableWide / UnitTableWide, planes (hh, hl, lh, ll)

Two ways to build a table:

  streaming     ``unit_table(_wide)`` per batch (k <= 31, 33 <= k <= 63),
                and ``merge_table_with_sorted_units(_wide)`` (the merge
                kernel K3 / K6 over the table's live prefix, then the
                run-reduce kernel K13) per consolidation; key-sorted
                count tables of two planes (k = 32's run-length batch
                tables, compact shard tables) ``merge_sorted_tables``
                (K4, pairwise weighted K3 merges, K13);
  sort-based    ``count_words(_wide)`` (compact, or run-length: sorted
                with duplicates, counts at run starts), ``count_weighted
                (_wide)`` and ``merge_many(_wide)``, a re-count by weight
                of any mix of table forms.  k = 32 and k = 64 fill every
                key bit, so their batch tables are built only this way.
                The key-only sort of the compact form at k <= 31 is the
                radix sort K11; the run-length form at k <= 31 / k <= 63
                is the segment-count kernel K10 (a per-segment layout,
                exact after a re-count).

Sorts are stable and unsigned: bit 63 of each int64 word is flipped
around every sort, compare and search (``u64.to_unsigned_order``), since
a k = 32 key may carry bit 63 and a k = 64 key bit 127.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import profiling
from ..core import u64, u128
from ..core.spec import MAX_K, NARROW_MAX_K
from ..kernels import count_tile as kct
from ..kernels import lookup as klookup
from ..kernels import merge as kmerge
from ..kernels import sort as ksort

UNIT_INVALID_HI = 0x80000000                  # folded invalid flag (uint32)
_INVALID_HI_I32 = UNIT_INVALID_HI - (1 << 32)  # its int32 bit pattern


class CountTable(NamedTuple):
    """Fixed-capacity k-mer count table (k <= 32).

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
    """Fixed-capacity count table of 128-bit keys (33 <= k <= 64).

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
    """The body of both widths: `merge` (K3 or K6) of the table's live
    prefix with the sorted unit keys, then K13's reduction of the merged
    lanes' runs.  Returns the merged compact table, of capacity
    max(table.capacity, its n_unique)."""
    nu = table.n_unique
    m_keys, m_w = merge(tuple(p[:nu] for p in table.keys),
                        table.counts[:nu], b_keys)
    profiling.add("kmers.consolidate.merges")
    profiling.add("kmers.consolidate.reduced", int(m_w.is_cuda))
    keys, counts, n_unique = kmerge.reduce_runs(m_keys, m_w, table.capacity)
    return make_table(keys, counts, n_unique)


def _merge_narrow(a_keys, a_w, b_keys):
    m_hi, m_lo, m_w = kmerge.merge_sorted(*a_keys, a_w, *b_keys)
    return (m_hi, m_lo), m_w


def merge_table_with_sorted_units(table: CountTable, s_hi: torch.Tensor,
                                  s_lo: torch.Tensor) -> CountTable:
    """Weighted merge of a compact key-sorted CountTable with PRE-SORTED
    unit keys (folded layout, invalid lanes flagged and sorted last):
    K3 and K13 (kmers_tpu/parallel/count.py:424)."""
    return _merge_with_sorted_units(table, (s_hi, s_lo), _merge_narrow)


def merge_table_with_sorted_units_wide(table: CountTableWide,
                                       s_keys: tuple) -> CountTableWide:
    """merge_table_with_sorted_units for 128-bit keys: s_keys = four
    planes ascending as unsigned words with the folded dead flag sorted
    last.  K6 and K13 (kmers_tpu/parallel/count.py:840-888)."""
    return _merge_with_sorted_units(table, tuple(s_keys),
                                    kmerge.merge_sorted_wide)


def _live_lists(pending):
    """The live lanes (counts > 0) of key-sorted count tables as key-sorted
    (hi, lo, counts) lists, one a table, or one a row of a stacked
    [D, cap] shard table; tables and rows with none give none.  Each
    table's live lanes go to the front by K4; a 1-D table has n_unique of
    them, and the rows of the stacked ones take one host read together.
    A generator: a table is compacted when the merge asks for it."""
    stacked = [t for t in pending if t.counts.dim() > 1]
    rows = iter(torch.cat([(t.counts > 0).sum(-1) for t in stacked]).tolist()
                if stacked else ())
    for t in pending:
        lens = ([next(rows) for _ in range(t.counts.shape[0])]
                if t.counts.dim() > 1 else [t.n_unique])
        if not sum(lens):
            continue
        counts = t.counts.reshape(-1)
        planes = kmerge.compress_flagged(
            *(p.reshape(-1) for p in t.keys), counts,
            (counts > 0).view(torch.uint8))
        at = 0
        for n in lens:
            if n:
                yield tuple(p[at:at + n] for p in planes)
            at += n


def merge_sorted_tables(table: CountTable, pending,
                        capacity: int) -> CountTable:
    """Consolidate count tables of two key planes that are key-sorted over
    their live lanes (compact tables, globally sorted run-length tables,
    stacked [D, cap] compact shard tables) into the compact table, by
    merging, with no sort: each pending table's live lanes (_live_lists),
    merged pairwise by K3 with B's weights (merge_sorted_weighted) as a
    binary counter adds, so that at most one list a level waits; the
    result merged with the table's live prefix; K13 with every lane valid
    (reduce_runs(all_valid=True)) over the merged lanes.  Keys may fill
    the word (k = 32).  Returns the compact table of max(capacity,
    n_unique) slots, which stream._bound_table bounds: the keys, counts
    mod 2^32, n_unique, eviction and dropped mass of merge_many's
    re-count of the same tables.  The table's live prefix is taken as it
    is: a count past 2^31 stays live, as in the JAX package's uint32
    tables, where merge_many's counts > 0 test drops it."""
    with profiling.span("kmers.consolidate.sorted_merge"):
        nu = table.n_unique
        lanes = nu
        stack = []                            # (level, list), levels falling
        for x in _live_lists(pending):
            lanes += x[0].shape[0]
            level = 0
            while stack and stack[-1][0] == level:
                x = kmerge.merge_sorted_weighted(*stack.pop()[1], *x)
                level += 1
            stack.append((level, x))
        while len(stack) > 1:
            x = stack.pop()[1]
            level, y = stack.pop()
            stack.append((level, kmerge.merge_sorted_weighted(*y, *x)))
        live = tuple(p[:nu] for p in table.keys) + (table.counts[:nu],)
        if stack and nu:
            live = kmerge.merge_sorted_weighted(*live, *stack.pop()[1])
        elif stack:
            live = stack.pop()[1]
        profiling.add("kmers.consolidate.sorted_merges")
        profiling.add("kmers.consolidate.sorted_reduced", int(live[2].is_cuda))
        profiling.add("kmers.consolidate.sorted_lanes", lanes)
        keys, counts, n_unique = kmerge.reduce_runs(live[:2], live[2],
                                                    capacity, all_valid=True)
        return CountTable(*keys, counts, n_unique)


def lookup(table: CountTable, queries: torch.Tensor) -> torch.Tensor:
    """Count of each int64 query word (0 if absent), by binary search over
    the live keys in unsigned order (a k = 32 key may carry bit 63): the
    search kernel K12 on the card (kernels/lookup.py)."""
    return klookup.search_counts(table.keys_hi, table.keys_lo, table.counts,
                                 table.n_unique, queries.contiguous())


_INVALID_QUERY = -2          # (0xFFFFFFFF, 0xFFFFFFFE) as an int64 word


def lookup_merge(table: CountTable, queries: torch.Tensor,
                 valid=None) -> torch.Tensor:
    """Count of each int64 query word (int32, in the queries' shape; 0 if
    absent or invalid) by sort and merge instead of a binary search
    (kmers_tpu/parallel/count.py:491-571), for k <= 31 keys.

    The queries are sorted stably with their positions and merged into
    the table by K3 with its source-index plane; the table's (unique)
    lane of a key is its run's start (A before B on equal keys), so each
    run start's table count is broadcast forward over its run; K4
    compacts the query lanes, which come out in sorted-query order, and a
    scatter by position un-sorts them.  Invalid queries are keyed
    (MAX, MAX-1): after every real key, before the table's dead (MAX, MAX)
    slots.  The broadcast is a cumsum, a scatter and a gather (JAX's
    log-doubling; torch.cummax would do, but on the card it scans a 1-D
    tensor in one block) and the un-sort a scatter (JAX's sort by
    position): positions are unique, so the answers are the same."""
    q = queries.reshape(-1)
    nq = q.shape[0]
    device = q.device
    if nq == 0:
        return torch.zeros(queries.shape, dtype=torch.int32, device=device)
    if valid is not None:
        q = torch.where(valid.reshape(-1), q, _INVALID_QUERY)
    s_q, s_pos = torch.sort(u64.to_unsigned_order(q), stable=True)
    s_hi, s_lo = u64.split_word(u64.to_unsigned_order(s_q))
    live = torch.arange(table.capacity, device=device) < table.n_unique
    m_hi, m_lo, m_w, m_idx = kmerge.merge_sorted(
        torch.where(live, table.keys_hi, -1),
        torch.where(live, table.keys_lo, -1),
        torch.where(live, table.counts, 0), s_hi, s_lo, with_idx=True)
    is_q = m_idx < 0                      # bit 31: a query lane
    n = m_hi.shape[0]
    starts = torch.arange(n, device=device) == 0
    starts[1:] = (m_hi[1:] != m_hi[:-1]) | (m_lo[1:] != m_lo[:-1])
    # each lane's run is a cumsum of the starts; a run's value, scattered
    # at its start (slot n takes the other lanes' zeros), is gathered by
    # every lane of it
    run = torch.cumsum(starts, 0) - 1
    run_val = torch.zeros(n + 1, dtype=torch.int32, device=device)
    run_val[torch.where(starts, run, n)] = torch.where(starts & ~is_q, m_w, 0)
    _, _, c_val = kmerge.compress_flagged(
        m_idx & 0x7FFFFFFF, m_lo, run_val[run], is_q.to(torch.uint8))
    answers = torch.empty(nq, dtype=torch.int32, device=device)
    answers[s_pos] = c_val[:nq]
    return answers.reshape(queries.shape)


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


# -- sort-based tables (kmers_tpu/parallel/count.py:141-421, :644-837) ---------
#
# One body for both widths: a key is a tuple of int64 words, most
# significant first -- (word,) for k <= 32, (hi, lo) for 33 <= k <= 64.

_LOW63 = (1 << 63) - 1           # clears the folded flag (bit 63 of word 0)


def _planes(words: tuple) -> tuple:
    """int64 words (most significant first) -> their int32 planes."""
    return tuple(p for w in words for p in u64.split_word(w))


def _table(words: tuple, counts: torch.Tensor, n_unique: int):
    return make_table(_planes(words), counts, n_unique)


def _lex_order(words: tuple) -> torch.Tensor:
    """Stable ascending order of lanes by their unsigned words, most
    significant first: stable sorts from the least significant word up."""
    order = None
    for w in reversed(words):
        key = u64.to_unsigned_order(w if order is None else w[order])
        step = torch.sort(key, stable=True).indices
        order = step if order is None else order[step]
    return order


def _spare(words: tuple, max_k) -> bool:
    """Whether the top bit of word 0 is free for a flag: k <= 31 keys in
    one word, k <= 63 keys in two."""
    return max_k is not None and max_k <= (NARROW_MAX_K if len(words) == 1
                                           else MAX_K)


def _sort_by_key(words: tuple, valid: torch.Tensor, extras: tuple,
                 spare_hi_bit: bool):
    """Stable sort of flat lanes by (invalid, words); returns (words, valid,
    extras) reordered, invalid lanes last.

    spare_hi_bit (the top bit of word 0 is clear in every valid key): the
    invalid flag folds into that bit, one key instead of two, and valid
    becomes lane < n_valid.  A payload-free one-word sort there is K11:
    equal keys are bit-identical, so it needs no stability.  Otherwise the
    sort is stable on the invalid flag, then on the words
    (count.py:158-173, :656-671)."""
    if spare_hi_bit:
        keyed = (words[0] | torch.where(valid, 0, u64.SIGN_BIT),) + words[1:]
        if len(keyed) == 1 and not extras:
            s = (u64.join_planes(*ksort.radix_sort_u64(
                *u64.split_word(keyed[0]))),)
        else:
            order = _lex_order(keyed)
            s = tuple(w[order] for w in keyed)
            extras = tuple(e[order] for e in extras)
        sv = torch.arange(valid.shape[0], device=valid.device) < valid.sum()
        return (s[0] & _LOW63,) + s[1:], sv, extras
    order = _lex_order(words)
    order = order[torch.sort((~valid[order]).to(torch.uint8),
                             stable=True).indices]
    return (tuple(w[order] for w in words), valid[order],
            tuple(e[order] for e in extras))


def _flat(words: tuple, valid: torch.Tensor, *extras) -> tuple:
    return (tuple(w.reshape(-1) for w in words), valid.reshape(-1)) + tuple(
        e.reshape(-1) for e in extras)


def sort_by_word(words: torch.Tensor, valid: torch.Tensor, *extras,
                 spare_hi_bit: bool = False):
    """int64 words (k <= 32) + validity -> (words, valid, extras) sorted by
    (invalid, unsigned word), stably; spare_hi_bit needs k <= 31."""
    s, v, ex = _sort_by_key(*_flat((words,), valid), extras=tuple(
        e.reshape(-1) for e in extras), spare_hi_bit=spare_hi_bit)
    return s[0], v, ex


def sort_by_word_wide(words: tuple, valid: torch.Tensor, *extras,
                      spare_hi_bit: bool = False):
    """sort_by_word for (hi, lo) 128-bit words; spare_hi_bit needs k <= 63."""
    return _sort_by_key(*_flat(tuple(words), valid), extras=tuple(
        e.reshape(-1) for e in extras), spare_hi_bit=spare_hi_bit)


def _run_starts(words: tuple, valid: torch.Tensor):
    """Run starts of sorted lanes (invalid lanes are last and start no
    run), and the lane index."""
    idx = torch.arange(valid.shape[0], device=valid.device)
    diff = ~torch.roll(valid, 1)
    for w in words:
        diff |= w != torch.roll(w, 1)
    return valid & ((idx == 0) | diff), idx


def _compact_starts(words: tuple, starts: torch.Tensor,
                    payload: torch.Tensor, spare_hi_bit: bool):
    """Stable-compact the run-start lanes of key-sorted lanes to the front,
    carrying `payload`: (words, payload).  spare_hi_bit: a stable sort by
    the key with not-start folded into its top bit, which orders the starts
    as a sort by not-start alone does (they are unique per key and in key
    order already); else a stable sort by not-start (count.py:198-217)."""
    not_start = ~starts
    if spare_hi_bit:
        order = _lex_order((words[0] | torch.where(not_start, u64.SIGN_BIT,
                                                   0),) + words[1:])
        out = tuple(w[order] for w in words)
        return (out[0] & _LOW63,) + out[1:], payload[order]
    order = torch.sort(not_start.to(torch.uint8), stable=True).indices
    return tuple(w[order] for w in words), payload[order]


def _compacted_table(words: tuple, starts: torch.Tensor, idx: torch.Tensor,
                     pos: torch.Tensor, last_total, spare_hi_bit: bool):
    """The compact table of sorted lanes: run starts to the front, each
    count the difference of consecutive compacted positions (or prefix
    sums), zeros past n_unique."""
    n_unique = int(starts.sum())
    keys, pos = _compact_starts(words, starts, pos, spare_hi_bit)
    live = idx < n_unique
    counts = _counts_from_positions(pos, idx, n_unique, last_total)
    return _table(tuple(torch.where(live, w, 0) for w in keys), counts,
                  n_unique)


def _count_sorted(words: tuple, valid: torch.Tensor, spare_hi_bit: bool):
    starts, idx = _run_starts(words, valid)
    return _compacted_table(words, starts, idx, idx, valid.sum(),
                            spare_hi_bit)


def _count_sorted_runs(words: tuple, valid: torch.Tensor):
    """Run-length table of sorted lanes: the keys as they are (duplicates
    included), counts = run length at run starts, 0 elsewhere; the next
    run start comes from a reverse cummin (count.py:237-261)."""
    starts, idx = _run_starts(words, valid)
    n = valid.shape[0]
    s_pos = torch.where(starts, idx, n)
    ns_incl = torch.cummin(s_pos.flip(0), 0).values.flip(0)
    ns_excl = torch.cat([ns_incl[1:], ns_incl.new_full((1,), n)])
    counts = torch.where(starts, torch.minimum(ns_excl, valid.sum()) - idx, 0)
    return _table(words, counts.to(torch.int32), int(starts.sum()))


def count_sorted(words: torch.Tensor, valid: torch.Tensor,
                 spare_hi_bit: bool = False) -> CountTable:
    """Compact CountTable of sorted int64 words (invalid lanes last and
    ignored); spare_hi_bit needs k <= 31 keys."""
    return _count_sorted((words,), valid, spare_hi_bit)


def count_sorted_runs(words: torch.Tensor, valid: torch.Tensor) -> CountTable:
    """Run-length CountTable of sorted int64 words (see _count_sorted_runs)."""
    return _count_sorted_runs((words,), valid)


def _count_words(words: tuple, valid: torch.Tensor, max_k, compact: bool):
    """Sort + count flat lanes of either width.  The run-length form at
    k <= 31 / k <= 63 is K10's per-segment layout on every device (the
    JAX package's TPU dispatch, count.py:279-280, :769-770); else a global
    sort, compacted or run-length."""
    spare = _spare(words, max_k)
    if compact:
        s, sv, _ = _sort_by_key(words, valid, (), spare)
        return _count_sorted(s, sv, spare)
    if spare:
        seg = count_words_segmented if len(words) == 1 else (
            count_words_segmented_wide)
        return seg(words[0] if len(words) == 1 else words, valid)
    with profiling.span("kmers.emit.runs"):
        s, sv, _ = _sort_by_key(words, valid, (), False)
        return _count_sorted_runs(s, sv)


def count_words(words: torch.Tensor, valid: torch.Tensor, max_k=None,
                compact: bool = True) -> CountTable:
    """Count a lane array of int64 k-mer words (k <= 32).  max_k <= 31
    frees the flag bit (one-key sorts; K11 for the compact form's sort).
    compact=False gives a run-length table: K10's per-segment layout when
    max_k <= 31, else the globally sorted one -- both exact only through
    a merge, and n_unique then counts runs, not keys."""
    return _count_words(*_flat((words,), valid), max_k=max_k, compact=compact)


def count_words_wide(words: tuple, valid: torch.Tensor, max_k=None,
                     compact: bool = True) -> CountTableWide:
    """count_words for (hi, lo) 128-bit words (33 <= k <= 64; max_k <= 63
    frees the flag bit, and gives K10's wide layout for compact=False)."""
    return _count_words(*_flat(tuple(words), valid), max_k=max_k,
                        compact=compact)


def count_words_segmented(words: torch.Tensor, valid: torch.Tensor,
                          seg_lanes: int = 64,
                          block_lanes: int = 1 << 14) -> CountTable:
    """Run-length table without a global sort (k <= 31): invalid lanes
    folded to exactly (0x80000000, 0), then K10 sorts and run-length
    encodes each seg_lanes segment.  Capacity: n rounded up to
    block_lanes; n_unique counts (segment, key) runs."""
    hi, lo = u64.fold_invalid(words.reshape(-1), valid.reshape(-1))
    kh, kl, counts = kct.segment_count_keys(hi, lo, seg_lanes, block_lanes)
    return CountTable(kh, kl, counts, int((counts > 0).sum()))


def count_words_segmented_wide(words: tuple, valid: torch.Tensor,
                               seg_lanes: int = 64,
                               block_lanes: int = 1 << 14) -> CountTableWide:
    """count_words_segmented for (hi, lo) 128-bit words (33 <= k <= 63):
    K10 on four planes."""
    planes = u128.fold_invalid(words[0].reshape(-1), words[1].reshape(-1),
                               valid.reshape(-1))
    *keys, counts = kct.segment_count_keys_wide(*planes, seg_lanes=seg_lanes,
                                                block_lanes=block_lanes)
    return CountTableWide(tuple(keys), counts, int((counts > 0).sum()))


def _count_weighted(words: tuple, valid: torch.Tensor, weights: torch.Tensor,
                    max_k):
    """Each lane adds its int32 weight to its key.  A run's weight is the
    difference of the exclusive prefix sums at consecutive run starts,
    taken mod 2^32 as the JAX package's uint32 sums wrap: exact while
    every key's count stays below 2^31 (count.py:347-373)."""
    spare = _spare(words, max_k)
    with profiling.span("kmers.consolidate.recount.sort"):
        s, sv, (w,) = _sort_by_key(words, valid, (weights,), spare)
    starts, idx = _run_starts(s, sv)
    mw = torch.where(sv, u64.as_uint32(w), 0)
    csum = torch.cumsum(mw, 0)
    last = csum[-1] if csum.numel() else csum.new_zeros(())
    return _compacted_table(s, starts, idx, csum - mw, last, spare)


def count_weighted(words: torch.Tensor, valid: torch.Tensor,
                   weights: torch.Tensor, max_k=None) -> CountTable:
    """count_words (compact) where each lane counts its int32 weight: the
    merge of pre-counted tables."""
    return _count_weighted(*_flat((words,), valid, weights), max_k=max_k)


def count_weighted_wide(words: tuple, valid: torch.Tensor,
                        weights: torch.Tensor, max_k=None) -> CountTableWide:
    """count_weighted for (hi, lo) 128-bit words."""
    return _count_weighted(*_flat(tuple(words), valid, weights), max_k=max_k)


def _live_lanes(t) -> torch.Tensor:
    """Flat mask of the slots that carry mass: counts > 0 for every count
    table form (compact, run-length, per-segment), the clear flag bit for
    a unit table."""
    if isinstance(t, (UnitTable, UnitTableWide)):
        return t.keys[0].reshape(-1) >= 0
    return t.counts.reshape(-1) > 0


def _table_parts(t, device=None) -> tuple:
    """(words, weights, valid) flat views of any table form of either
    width, on `device`: a unit table's weights are its validity, its
    words have the flag stripped."""
    valid = _live_lanes(t)
    planes = [p.reshape(-1) for p in t.keys]
    if isinstance(t, (UnitTable, UnitTableWide)):
        planes[0] = planes[0] & 0x7FFFFFFF
        weights = valid.to(torch.int32)
    else:
        weights = t.counts.reshape(-1)
    words = tuple(u64.join_planes(planes[i], planes[i + 1])
                  for i in range(0, len(planes), 2))
    move = lambda x: x.to(device) if device is not None else x
    return tuple(move(w) for w in words), move(weights), move(valid)


def _merge_many(tables, max_k):
    """One concat + weighted re-count of tables of one width (a list
    stands for per-shard tables; all move to the first table's device):
    one sort for N tables instead of N - 1 pairwise merges."""
    flat = [t for x in tables for t in (x if isinstance(x, list) else [x])]
    device = flat[0].counts.device if hasattr(flat[0], "counts") else (
        flat[0].keys[0].device)
    with profiling.span("kmers.consolidate.recount"):
        with profiling.span("kmers.consolidate.recount.join"):
            parts = [_table_parts(t, device) for t in flat]
            n_words = len(parts[0][0])
            words = tuple(torch.cat([p[0][i] for p in parts])
                          for i in range(n_words))
            valid = torch.cat([p[2] for p in parts])
            weights = torch.cat([p[1] for p in parts])
        profiling.add("kmers.consolidate.recounts")
        profiling.add("kmers.consolidate.recount_lanes", words[0].numel())
        return _count_weighted(words, valid, weights, max_k)


def merge_many(tables, max_k=None) -> CountTable:
    """Merge narrow tables of any form (compact, run-length, per-segment,
    unit) into one compact CountTable (capacity = the sum)."""
    return _merge_many(tables, max_k)


def merge_many_wide(tables, max_k=None) -> CountTableWide:
    """merge_many for 128-bit tables."""
    return _merge_many(tables, max_k)


def merge_tables(a: CountTable, b: CountTable, max_k=None) -> CountTable:
    return _merge_many([a, b], max_k)


def merge_tables_wide(a: CountTableWide, b: CountTableWide,
                      max_k=None) -> CountTableWide:
    return _merge_many([a, b], max_k)
