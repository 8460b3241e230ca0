"""Sort kernel K11: ascending sort of 64-bit keys held as uint32 planes.

Counterpart of ``kmers_tpu/kernels/sort.py``'s ``bitonic_sort_u64``: the
keys are two flat int32 planes holding uint32 bit patterns, ordered as
unsigned ``(uint32)hi << 32 | (uint32)lo``; no payload.  The result is
byte-identical to the bitonic kernel and to ``lax.sort((hi, lo),
num_keys=2)`` for any n (the TPU kernel needs a power of two >= 512).  On
the card it is an LSD radix sort (``csrc/sort.cu``).
"""

from __future__ import annotations

import torch

from ..core import u64
from . import _build, check_tensor, count_launch, on_cuda


def radix_sort_u64_plain(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """Plain version of K11: torch.sort of the joined words in unsigned
    order (bit 63 flipped around the sort)."""
    key = u64.to_unsigned_order(u64.join_planes(hi, lo))
    return u64.split_word(u64.to_unsigned_order(torch.sort(key).values))


def radix_sort_u64(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """K11: (hi, lo) int32 [n] -> the keys sorted ascending as unsigned
    64-bit values, as new (hi, lo) planes (kmers_tpu/kernels/sort.py:184).

    On the card: one census of all eight digits (one host sync to read
    it), then an 8-bit LSD pass for each digit on which the keys differ."""
    n = hi.shape[0] if hi.dim() == 1 else -1
    check_tensor(hi, "hi", torch.int32, (n,))
    check_tensor(lo, "lo", torch.int32, (n,))
    if not on_cuda(hi, lo):
        return radix_sort_u64_plain(hi, lo)
    if n >= 1 << 31:
        raise ValueError(f"radix_sort_u64 takes n < 2^31 keys, got {n}")
    device = hi.device
    out = (torch.empty_like(hi), torch.empty_like(lo))
    if n == 0:
        return out
    with torch.cuda.device(device):
        lib = _build.lib()
        stream = torch.cuda.current_stream().cuda_stream
        census = torch.zeros(8 * 256, dtype=torch.int64, device=device)
        _build.check(lib.kt_radix_hist8(hi.data_ptr(), lo.data_ptr(), n,
                                        census.data_ptr(), stream),
                     "radix_sort_u64 (census)")
        count_launch("radix_sort_u64")
        bins = (census.view(8, 256) > 0).sum(1).tolist()
        passes = [p for p in range(8) if bins[p] > 1]
        if not passes:                      # every key is the same
            out[0].copy_(hi)
            out[1].copy_(lo)
            return out
        tile = lib.kt_radix_tile()
        hist = torch.empty(256 * (-(-n // tile)), dtype=torch.int32,
                           device=device)
        totals = torch.empty(256, dtype=torch.int32, device=device)
        tmp = (torch.empty_like(hi), torch.empty_like(lo))
        src = (hi, lo)
        for i, p in enumerate(passes):
            # ping-pong so that the last pass lands in `out`
            dst = out if (len(passes) - 1 - i) % 2 == 0 else tmp
            _build.check(lib.kt_radix_pass(
                src[0].data_ptr(), src[1].data_ptr(), n, 8 * p,
                hist.data_ptr(), totals.data_ptr(), dst[0].data_ptr(),
                dst[1].data_ptr(), stream), "radix_sort_u64")
            src = dst
    return out
