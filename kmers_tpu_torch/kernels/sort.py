"""Sort kernel K11: ascending sort of 64-bit keys held as uint32 planes.

Counterpart of ``kmers_tpu/kernels/sort.py``'s ``bitonic_sort_u64``: the
keys are two flat int32 planes holding uint32 bit patterns, ordered as
unsigned ``(uint32)hi << 32 | (uint32)lo``; no payload.  The result is
byte-identical to the bitonic kernel and to ``lax.sort((hi, lo),
num_keys=2)`` for any n (the TPU kernel needs a power of two >= 512).  On
the card it is a onesweep LSD radix sort (``csrc/sort.cu``).
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

    On the card, n < 2^30: one census of all eight digits, then an 8-bit
    onesweep LSD pass for each digit on which the keys differ, planned on
    the device (no host sync)."""
    n = hi.shape[0] if hi.dim() == 1 else -1
    check_tensor(hi, "hi", torch.int32, (n,))
    check_tensor(lo, "lo", torch.int32, (n,))
    if not on_cuda(hi, lo):
        return radix_sort_u64_plain(hi, lo)
    if n >= 1 << 30:
        raise ValueError(f"radix_sort_u64 takes n < 2^30 keys, got {n}")
    out = (torch.empty_like(hi), torch.empty_like(lo))
    if n == 0:
        return out
    with torch.cuda.device(hi.device):
        lib = _build.lib()
        tmp = (torch.empty_like(hi), torch.empty_like(lo))
        scratch = torch.empty(lib.kt_radix_scratch_bytes(n), dtype=torch.uint8,
                              device=hi.device)
        _build.check(lib.kt_radix_sort(
            hi.data_ptr(), lo.data_ptr(), n, out[0].data_ptr(),
            out[1].data_ptr(), tmp[0].data_ptr(), tmp[1].data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "radix_sort_u64")
    count_launch("radix_sort_u64")
    return out
