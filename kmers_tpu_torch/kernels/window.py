"""Window kernels K1 and K2: reads -> folded canonical keys (k <= 31).

Counterparts of ``kmers_tpu/kernels/window.py``'s
``pack_canonical_keys_packed`` (K1) and ``pack_canonical_keys`` (K2,
stage "canon").  Output: (key_hi, key_lo) int32 planes [B, L] holding
uint32 bit patterns; lane p is the window that starts at base p; invalid
lanes are exactly (0x80000000, 0).  (The TPU's K1 emits a permuted
"q-order"; the counting consumer treats lanes as a multiset, and the port
emits plain p-order.)  CUDA source: ``csrc/window.cu``.
"""

from __future__ import annotations

import torch

from ..core import u64
from ..core.spec import check_k
from ..ops import kmer
from . import _build, check_tensor, count_launch, on_cuda


def pack_canonical_keys_packed_plain(words: torch.Tensor,
                                     validbits: torch.Tensor, k: int):
    """Plain version of K1: the packed windows of ops.kmer, folded."""
    win = kmer.kmer_windows_packed(words, validbits, k)
    return u64.fold_invalid(kmer.canonical_word(win.fw, win.rc), win.valid)


def pack_canonical_keys_plain(reads: torch.Tensor, k: int):
    """Plain version of K2: the ASCII windows of ops.kmer, folded."""
    win = kmer.kmer_windows(reads, k)
    return u64.fold_invalid(kmer.canonical_word(win.fw, win.rc), win.valid)


def pack_canonical_keys_packed(words: torch.Tensor, validbits: torch.Tensor,
                               k: int):
    """K1: [B, L/16] int32 code words + [B, L/32] int32 validity bitmaps
    (io.fastx.read_packed_batches layout, L % 32 == 0) -> folded
    (key_hi, key_lo) [B, L] int32."""
    check_k(k)
    if words.dim() != 2:
        raise ValueError(f"words must be [B, L/16], got {tuple(words.shape)}")
    B, nw = words.shape
    L = nw * 16
    if L % 32:
        raise ValueError(f"packed ingest needs L % 32 == 0, got L={L}")
    check_tensor(words, "words", torch.int32, (B, nw))
    check_tensor(validbits, "validbits", torch.int32, (B, L // 32))
    if not on_cuda(words, validbits):
        return pack_canonical_keys_packed_plain(words, validbits, k)
    hi = torch.empty((B, L), dtype=torch.int32, device=words.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(words.device):
        code = _build.lib().kt_pack_keys_packed(
            words.data_ptr(), validbits.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), B, L, k, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pack_canonical_keys_packed")
    count_launch("pack_canonical_keys_packed")
    return hi, lo


def pack_canonical_keys(reads: torch.Tensor, k: int):
    """K2: [B, L] uint8 ASCII reads -> folded (key_hi, key_lo) [B, L]
    int32."""
    check_k(k)
    if reads.dim() != 2:
        raise ValueError(f"reads must be [B, L], got {tuple(reads.shape)}")
    B, L = reads.shape
    if L < k:
        raise ValueError(f"row length {L} is shorter than k={k}")
    check_tensor(reads, "reads", torch.uint8, (B, L))
    if not on_cuda(reads):
        return pack_canonical_keys_plain(reads, k)
    hi = torch.empty((B, L), dtype=torch.int32, device=reads.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(reads.device):
        code = _build.lib().kt_pack_keys_ascii(
            reads.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, L, k,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pack_canonical_keys")
    count_launch("pack_canonical_keys")
    return hi, lo
