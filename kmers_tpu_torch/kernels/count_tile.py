"""Segment-count kernel K10: per-segment sort and run-length count of
folded k-mer keys.

Counterpart of ``kmers_tpu/kernels/count_tile.py``'s
``segment_count_keys`` (two uint32 planes, k <= 31) and
``segment_count_keys_wide`` (four planes, 33 <= k <= 63).  Keys arrive
folded: bit 31 of plane 0 is the invalid flag and an invalid lane is
exactly (0x80000000, 0[, 0, 0]).  The output has n_pad = ceil(n /
block_lanes) * block_lanes lanes (padding lanes are invalid): within each
seg_lanes segment the keys ascend as unsigned words over the planes,
valid first; counts hold the run length at run starts and 0 elsewhere;
invalid lanes are zero.  It is NOT globally sorted: a key owns one run
per segment it appears in, so only a merge (count.merge_many) makes it
exact.  Segments are powers of two from 8 lanes to block_lanes, as in
JAX.  CUDA source: ``csrc/count_tile.cu``: one kernel sorts and counts a
segment of up to SEG_LANES_MAX lanes in one thread block (a template on
the plane count and the segment size); a larger segment is sorted in
4096-lane tiles by the same kernel, merged through global memory in
log2(seg_lanes / 4096) rounds and counted by the same kernel again, with
n_planes x n_pad lanes of scratch.  Either way a call is one launch of
its name in the counts.
"""

from __future__ import annotations

import torch

from ..core import u64
from . import _build, check_tensor, count_launch, on_cuda

INVALID_HI = 0x80000000
_INVALID_HI_I32 = INVALID_HI - (1 << 32)
# the largest segment one thread block sorts (csrc/count_tile.cu's
# SC_MAX_SEG); larger ones take the merge rounds
SEG_LANES_MAX = 4096


def _check_sizes(seg_lanes: int, block_lanes: int) -> None:
    pow2 = lambda x: x > 0 and x & (x - 1) == 0
    if not (seg_lanes >= 8 and pow2(seg_lanes) and pow2(block_lanes)
            and block_lanes % seg_lanes == 0):
        raise ValueError(f"seg_lanes={seg_lanes}, block_lanes={block_lanes}: "
                         "need powers of two, 8 <= seg_lanes <= block_lanes")


def _padded(planes: tuple, n_pad: int) -> list:
    n = planes[0].shape[0]
    out = []
    for i, p in enumerate(planes):
        fill = _INVALID_HI_I32 if i == 0 else 0
        out.append(torch.cat([p, p.new_full((n_pad - n,), fill)]))
    return out


def segment_count_plain(planes: tuple, seg_lanes: int,
                        block_lanes: int) -> tuple:
    """Plain version of K10 over 2 or 4 planes: per-segment torch.sort of
    [n_pad / S, S] rows (unsigned; two stable sorts for 4 planes), then
    run lengths by a reverse cummin over boundary positions, as
    count.count_sorted_runs does."""
    n = planes[0].shape[0]
    S = seg_lanes
    n_pad = -(-n // block_lanes) * block_lanes
    rows = [p.view(-1, S) for p in _padded(planes, n_pad)]
    if len(rows) == 2:
        key = u64.to_unsigned_order(u64.join_planes(*rows))
        rows = list(u64.split_word(u64.to_unsigned_order(
            torch.sort(key, dim=1).values)))
    else:
        hi = u64.to_unsigned_order(u64.join_planes(rows[0], rows[1]))
        lo = u64.to_unsigned_order(u64.join_planes(rows[2], rows[3]))
        by_lo = torch.sort(lo, dim=1, stable=True).indices
        order = by_lo.gather(1, torch.sort(hi.gather(1, by_lo), dim=1,
                                           stable=True).indices)
        rows = [r.gather(1, order) for r in rows]
    valid = rows[0] >= 0                       # flag bit clear
    neq = torch.zeros_like(valid)
    for r in rows:
        neq |= torch.cat([torch.ones_like(r[:, :1], dtype=torch.bool),
                          r[:, 1:] != r[:, :-1]], 1)
    starts = valid & neq
    col = torch.arange(S, device=valid.device).expand_as(rows[0])
    m = torch.where(starts | ~valid, col, S)
    ns_incl = torch.cummin(m.flip(1), 1).values.flip(1)
    ns_excl = torch.cat([ns_incl[:, 1:], torch.full_like(ns_incl[:, :1], S)],
                        1)
    counts = torch.where(starts, ns_excl - col, 0).to(torch.int32)
    return tuple(torch.where(valid, r, 0).reshape(-1) for r in rows) + (
        counts.reshape(-1),)


def _segment_count(planes: tuple, seg_lanes: int, block_lanes: int,
                   name: str) -> tuple:
    _check_sizes(seg_lanes, block_lanes)
    n = planes[0].shape[0] if planes[0].dim() == 1 else -1
    for i, p in enumerate(planes):
        check_tensor(p, f"plane {i}", torch.int32, (n,))
    if not on_cuda(*planes):
        return segment_count_plain(planes, seg_lanes, block_lanes)
    n_pad = -(-n // block_lanes) * block_lanes
    device = planes[0].device
    out = [torch.empty(n_pad, dtype=torch.int32, device=device)
           for _ in range(len(planes) + 1)]
    scratch = (torch.empty(len(planes) * n_pad, dtype=torch.int32,
                           device=device)
               if seg_lanes > SEG_LANES_MAX else None)
    ins = list(planes) + [planes[0]] * (4 - len(planes))
    outs = out[:-1] + [out[0]] * (4 - len(planes))
    with torch.cuda.device(device):
        code = _build.lib().kt_segment_count(
            *(p.data_ptr() for p in ins), n, n_pad, seg_lanes, len(planes),
            *(o.data_ptr() for o in outs), out[-1].data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    count_launch(name)
    return tuple(out)


def segment_count_keys(key_hi: torch.Tensor, key_lo: torch.Tensor,
                       seg_lanes: int = 1 << 10, block_lanes: int = 1 << 14):
    """K10, two planes (k <= 31): (keys_hi, keys_lo, counts), int32 [n_pad]
    each (kmers_tpu/kernels/count_tile.py:234, with its defaults)."""
    return _segment_count((key_hi, key_lo), seg_lanes, block_lanes,
                          "segment_count_keys")


def segment_count_keys_wide(key_hh: torch.Tensor, key_hl: torch.Tensor,
                            key_lh: torch.Tensor, key_ll: torch.Tensor,
                            seg_lanes: int = 1 << 6,
                            block_lanes: int = 1 << 14):
    """K10, four planes (33 <= k <= 63): (hh, hl, lh, ll, counts), int32
    [n_pad] each (kmers_tpu/kernels/count_tile.py:262, with its
    defaults)."""
    return _segment_count((key_hh, key_hl, key_lh, key_ll), seg_lanes,
                          block_lanes, "segment_count_keys_wide")
