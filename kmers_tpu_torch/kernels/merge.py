"""Consolidation kernels K3, K6, K4 and K13.

Counterparts of ``kmers_tpu/kernels/merge.py``'s ``merge_sorted`` (K3,
two key planes, and ``with_idx``'s source-index plane),
``merge_sorted_wide`` (K6, four key planes: 128-bit keys) and
``compress_flagged`` (K4); ``reduce_runs`` (K13) has no TPU kernel: it
is the glue around K4 in ``kmers_tpu/parallel/count.py``'s table merge.
All planes are 1-D int32 tensors holding uint32 bit patterns.  CUDA
source: ``csrc/merge.cu`` (K3 and K6 are one kernel template, the index
plane a compile-time flag of it; K13 one template on the key planes).

Two variants serve keys that fill the word (k = 32), for the merge of
key-sorted count tables (``parallel.count.merge_sorted_tables``):
``merge_sorted_weighted`` (K3 whose B side carries its weights) and
``reduce_runs(..., all_valid=True)`` (K13 with no flag bit).  Neither
replaces a TPU kernel: the JAX package's k = 32 path re-counts by weight
(``kmers_tpu/parallel/count.py:347-373``).  Both are bound by bytes, 12 B
in and 12 B out a lane.
"""

from __future__ import annotations

import functools
import operator

import torch

from ..core import u64, u128
from . import _build, check_tensor, count_launch, on_cuda


def _check_planes(n: int, **planes) -> None:
    for name, t in planes.items():
        check_tensor(t, name, torch.int32, (n,))


def _merge_plain(a_hi, a_lo, a_w, b_hi, b_lo, b_w):
    """One stable sort of A then B by the unsigned key, so equal keys keep
    A before B and their order within each side: the merged (hi, lo, w)
    and the sort's order."""
    hi, lo = torch.cat([a_hi, b_hi]), torch.cat([a_lo, b_lo])
    order = torch.sort(u64.to_unsigned_order(u64.join_planes(hi, lo)),
                       stable=True).indices
    return (hi[order], lo[order], torch.cat([a_w, b_w])[order]), order


def merge_sorted_plain(a_hi, a_lo, a_w, b_hi, b_lo, with_idx: bool = False):
    """Plain version of K3: _merge_plain with B's weights from its flag.
    with_idx: the sort's order is the source index, a B lane's rank in B
    carrying bit 31."""
    out, order = _merge_plain(a_hi, a_lo, a_w, b_hi, b_lo,
                              ((b_hi >> 31) & 1) ^ 1)
    if not with_idx:
        return out
    na = a_hi.shape[0]
    idx = torch.where(order < na, order, (order - na) - (1 << 31))
    return out + (idx.to(torch.int32),)


def merge_sorted(a_hi, a_lo, a_w, b_hi, b_lo, with_idx: bool = False):
    """K3: merge a sorted table A (key_hi, key_lo, weight) with sorted
    unit keys B (key_hi, key_lo in the folded layout: bit 31 of hi set =
    dead lane, weight = flag ^ 1) into one (hi, lo, w) of nA + nB lanes.

    Both sides must ascend by unsigned (hi, lo), dead lanes last; equal
    keys keep A before B.  with_idx=True adds a fourth int32 plane, the
    source index (kmers_tpu/kernels/merge.py:138-140): an A lane's rank
    in A, or 0x80000000 | a B lane's rank in B (negative as int32); its
    launches count as "merge_sorted_idx"."""
    na, nb = a_hi.shape[0], b_hi.shape[0]
    _check_planes(na, a_hi=a_hi, a_lo=a_lo, a_w=a_w)
    _check_planes(nb, b_hi=b_hi, b_lo=b_lo)
    if not on_cuda(a_hi, a_lo, a_w, b_hi, b_lo):
        return merge_sorted_plain(a_hi, a_lo, a_w, b_hi, b_lo, with_idx)
    n = na + nb
    if with_idx and max(na, nb) >= 1 << 31:
        raise ValueError("merge_sorted(with_idx=True) takes sides below 2^31 "
                         "lanes")
    device = a_hi.device
    out = [torch.empty(n, dtype=torch.int32, device=device)
           for _ in range(4 if with_idx else 3)]
    name = "merge_sorted_idx" if with_idx else "merge_sorted"
    with torch.cuda.device(device):
        lib = _build.lib()
        tile = lib.kt_merge_tile()
        part = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=device)
        launch = lib.kt_merge_sorted_idx if with_idx else lib.kt_merge_sorted
        code = launch(
            a_hi.data_ptr(), a_lo.data_ptr(), a_w.data_ptr(), na,
            b_hi.data_ptr(), b_lo.data_ptr(), nb, part.data_ptr(),
            *(o.data_ptr() for o in out),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    count_launch(name)
    return tuple(out)


def merge_sorted_weighted_plain(a_hi, a_lo, a_w, b_hi, b_lo, b_w):
    """Plain version of merge_sorted_weighted: _merge_plain."""
    return _merge_plain(a_hi, a_lo, a_w, b_hi, b_lo, b_w)[0]


def merge_sorted_weighted(a_hi, a_lo, a_w, b_hi, b_lo, b_w):
    """K3 with B's own weights (its WEIGHTED_B instantiation): merge two
    key-sorted weighted lists (hi, lo, w) into one of nA + nB lanes.
    Every lane of both is live: the order is unsigned over (hi, lo) for
    any key, bit 63 included, and no weight comes from a flag.  Equal
    keys keep A before B.  Launches count as "merge_sorted_weighted"."""
    na, nb = a_hi.shape[0], b_hi.shape[0]
    _check_planes(na, a_hi=a_hi, a_lo=a_lo, a_w=a_w)
    _check_planes(nb, b_hi=b_hi, b_lo=b_lo, b_w=b_w)
    if not on_cuda(a_hi, a_lo, a_w, b_hi, b_lo, b_w):
        return merge_sorted_weighted_plain(a_hi, a_lo, a_w, b_hi, b_lo, b_w)
    n = na + nb
    device = a_hi.device
    out = [torch.empty(n, dtype=torch.int32, device=device) for _ in range(3)]
    with torch.cuda.device(device):
        lib = _build.lib()
        tile = lib.kt_merge_tile_weighted()
        part = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=device)
        code = lib.kt_merge_sorted_weighted(
            a_hi.data_ptr(), a_lo.data_ptr(), a_w.data_ptr(), na,
            b_hi.data_ptr(), b_lo.data_ptr(), b_w.data_ptr(), nb,
            part.data_ptr(), *(o.data_ptr() for o in out),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "merge_sorted_weighted")
    count_launch("merge_sorted_weighted")
    return tuple(out)


def merge_sorted_wide_plain(a_keys, a_w, b_keys):
    """Plain version of K6: one stable unsigned 128-bit sort of A then B."""
    keys = [torch.cat([a, b]) for a, b in zip(a_keys, b_keys)]
    b_w = ((b_keys[0] >> 31) & 1) ^ 1
    order = u128.argsort(*u128.join_planes(*keys))
    return (tuple(p[order] for p in keys), torch.cat([a_w, b_w])[order])


def merge_sorted_wide(a_keys, a_w, b_keys):
    """K6: merge_sorted for 128-bit keys.  a_keys / b_keys are 4-tuples of
    planes, most significant first (UnitTableWide's layout: the folded
    dead flag is bit 31 of plane 0).  Returns (keys 4-tuple, w) of exactly
    nA + nB lanes (kmers_tpu/kernels/merge.py:509 pads to its tile)."""
    a_keys, b_keys = tuple(a_keys), tuple(b_keys)
    if len(a_keys) != 4 or len(b_keys) != 4:
        raise ValueError("merge_sorted_wide takes four key planes a side")
    na, nb = a_w.shape[0], b_keys[0].shape[0]
    _check_planes(na, **{f"a{i}": p for i, p in enumerate(a_keys)}, a_w=a_w)
    _check_planes(nb, **{f"b{i}": p for i, p in enumerate(b_keys)})
    if not on_cuda(*a_keys, a_w, *b_keys):
        return merge_sorted_wide_plain(a_keys, a_w, b_keys)
    n = na + nb
    device = a_w.device
    out = [torch.empty(n, dtype=torch.int32, device=device) for _ in range(5)]
    with torch.cuda.device(device):
        lib = _build.lib()
        tile = lib.kt_merge_tile_wide()
        part = torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=device)
        code = lib.kt_merge_sorted_wide(
            *(p.data_ptr() for p in a_keys), a_w.data_ptr(), na,
            *(p.data_ptr() for p in b_keys), nb, part.data_ptr(),
            *(o.data_ptr() for o in out),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "merge_sorted_wide")
    count_launch("merge_sorted_wide")
    return tuple(out[:4]), out[4]


def compress_flagged_plain(hi, lo, pay, keep):
    """Plain version of K4 (lanes past the kept count are zero here)."""
    idx = keep.nonzero().squeeze(1)
    out = []
    for x in (hi, lo, pay):
        o = torch.zeros_like(x)
        o[:idx.shape[0]] = x[idx]
        out.append(o)
    return tuple(out)


def compress_flagged(hi, lo, pay, keep):
    """K4: stable-compact the lanes with keep != 0 to the front, carrying
    `pay`: out[j] = (hi, lo, pay) of the j-th kept lane.  keep is uint8
    (any nonzero byte keeps its lane); lanes past the kept count are
    unspecified.  On the card one kernel with a decoupled look-back over
    its tiles, after one memset of the tiles' status words: no count pass
    and no host sync.  Planes may alias one another and need not be
    16-byte aligned."""
    n = hi.shape[0]
    _check_planes(n, hi=hi, lo=lo, pay=pay)
    check_tensor(keep, "keep", torch.uint8, (n,))
    if not on_cuda(hi, lo, pay, keep):
        return compress_flagged_plain(hi, lo, pay, keep)
    device = hi.device
    out = [torch.empty(n, dtype=torch.int32, device=device) for _ in range(3)]
    with torch.cuda.device(device):
        lib = _build.lib()
        scratch = torch.empty(lib.kt_compress_scratch_lanes(n),
                              dtype=torch.int64, device=device)
        code = lib.kt_compress_flagged(
            hi.data_ptr(), lo.data_ptr(), pay.data_ptr(), keep.data_ptr(), n,
            scratch.data_ptr(), *(o.data_ptr() for o in out),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "compress_flagged")
    count_launch("compress_flagged")
    return tuple(out)


def reduce_runs_plain(keys, w, capacity: int, all_valid: bool = False):
    """Plain version of K13: run starts of the valid lanes (all_valid:
    every lane), an int64 cumsum of their weights as uint32, the starts'
    keys and exclusive prefix sums compacted, each count the difference
    of consecutive prefixes (the last closed by the total), mod 2^32."""
    valid = torch.ones_like(w, dtype=torch.bool) if all_valid else (
        keys[0] >= 0)
    # lane 0's "previous key" differs from it in plane 0
    first = [keys[0][:1] ^ 1] + [p[:1] for p in keys[1:]]
    starts = valid & functools.reduce(operator.or_, (
        p != torch.cat([f, p[:-1]]) for p, f in zip(keys, first)))
    mw = torch.where(valid, u64.as_uint32(w), 0)
    csum = torch.cumsum(mw, 0)
    at = starts.nonzero().squeeze(1)
    n_unique = at.shape[0]
    pos = (csum - mw)[at]
    nxt = torch.cat([pos[1:], csum[-1:]])
    out_lanes = max(capacity, n_unique)

    def put(x):
        out = torch.zeros(out_lanes, dtype=torch.int32, device=w.device)
        out[:n_unique] = x
        return out

    counts = u64.low32_as_int32((nxt - pos) & u64.LOW32)
    return tuple(put(p[at]) for p in keys), put(counts), n_unique


def reduce_runs(keys, w, capacity: int, all_valid: bool = False):
    """K13: the compact table of merged lanes (K3's or K6's output: keys
    ascending as unsigned words over the planes, most significant first,
    flagged lanes last).  Each run of equal valid keys (bit 31 of plane 0
    clear) becomes one slot: its key and its weight sum mod 2^32 (exact
    below 2^31).  all_valid (its ALL_VALID instantiation, launches
    counted as "reduce_runs_all_valid"): every lane is valid and no bit
    is tested, for keys that fill the word.  Returns (key planes, counts,
    n_unique): int32 planes of max(capacity, n_unique) lanes, zero past
    n_unique.

    On the card two kernels over the lanes' tiles and one host read,
    n_unique, in between (it sizes the outputs); no lane-wide temporary
    but the outputs."""
    keys = tuple(keys)
    nk = len(keys)
    if nk not in (2, 4):
        raise ValueError("reduce_runs takes two or four key planes")
    n = w.shape[0]
    _check_planes(n, **{f"k{i}": p for i, p in enumerate(keys)}, w=w)
    if not on_cuda(*keys, w):
        return reduce_runs_plain(keys, w, capacity, all_valid)
    device = w.device
    planes = [p.data_ptr() for p in keys + (w,)]
    planes += [None] * (5 - len(planes))
    with torch.cuda.device(device):
        lib = _build.lib()
        stream = torch.cuda.current_stream().cuda_stream
        scratch = torch.empty(lib.kt_reduce_scratch_lanes(n, nk),
                              dtype=torch.int64, device=device)
        code = lib.kt_reduce_runs_tiles(nk, int(all_valid), *planes, n,
                                        scratch.data_ptr(), stream)
        _build.check(code, "reduce_runs")
        n_unique = int(scratch[-1])
        out = [torch.empty(max(capacity, n_unique), dtype=torch.int32,
                           device=device) for _ in range(nk + 1)]
        outs = [o.data_ptr() for o in out] + [None] * (4 - nk)
        code = lib.kt_reduce_runs(nk, int(all_valid), *planes, n,
                                  scratch.data_ptr(), n_unique,
                                  out[0].shape[0], *outs, stream)
    name = "reduce_runs_all_valid" if all_valid else "reduce_runs"
    _build.check(code, name)
    count_launch(name)
    return tuple(out[:nk]), out[nk], n_unique
