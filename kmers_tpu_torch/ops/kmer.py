"""Batched k-mer windows (counterpart of ``kmers_tpu/ops/kmer.py``).

Every window of a read batch at once, as ``int64`` words (base i of the
window at bits 2i, the reference's LSB-first layout):

  codes [.., L] --> log-doubling 16-base words w16[p] = bases p..p+15
        --> window p = w16[p] | (w16[p+16] masked) << 32
        --> reverse complement / canonical, all elementwise.

A window is valid iff its k bases are all valid and it starts at
p <= L - k; invalid windows carry garbage words that the mask filters.
These are the plain versions the window kernels (kernels/window.py) are
held against.  Words are int64, so k <= 31 (bit 63 stays clear).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import u64
from ..core.spec import check_k
from . import encoding


def _shift_left(a: torch.Tensor, s: int) -> torch.Tensor:
    """a'[.., p] = a[.., p+s], zero-padded at the tail (last axis)."""
    if s == 0:
        return a
    if s >= a.shape[-1]:
        return torch.zeros_like(a)
    tail = torch.zeros(*a.shape[:-1], s, dtype=a.dtype, device=a.device)
    return torch.cat([a[..., s:], tail], dim=-1)


def pack_u32_words(codes: torch.Tensor) -> torch.Tensor:
    """w16[.., p] = bases p..p+15 packed LSB-first (32 bits in an int64),
    zero-padded past the end of the row."""
    w = codes.to(torch.int64) & 3
    for s in (1, 2, 4, 8):
        w = w | (_shift_left(w, s) << (2 * s))
    return w


def window_words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """All k-mer windows of a code array as int64 words; entry p is the
    k-mer starting at base p (garbage for p > L - k: mask it)."""
    check_k(k)
    w16 = pack_u32_words(codes)
    if k <= 16:
        return w16 & u64.mask(2 * k)
    hi = _shift_left(w16, 16) & u64.mask(2 * (k - 16))
    return (hi << 32) | w16


def window_valid(valid: torch.Tensor, k: int) -> torch.Tensor:
    """window_valid[p] = AND of valid[p..p+k-1], by log-doubling AND."""
    v = valid
    got = 1
    while got < k:
        step = got if got * 2 <= k else k - got
        v = v & _shift_left(v, step)
        got += step
    return v


class KmerWindows(NamedTuple):
    """All k-mer windows of a read batch."""

    fw: torch.Tensor      # int64 forward words, garbage where ~valid
    rc: torch.Tensor      # int64 reverse-complement words
    valid: torch.Tensor   # bool: the window holds no invalid base
    n_windows: int        # L - k + 1


def canonical_word(fw: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """min(fw, rc), the canonical strand.  Both are below 2^62 for
    k <= 31, so the signed minimum is the unsigned one."""
    return torch.minimum(fw, rc)


def _windows(codes: torch.Tensor, vmask: torch.Tensor, k: int) -> KmerWindows:
    L = codes.shape[-1]
    if L < k:
        raise ValueError(f"row length {L} is shorter than k={k}")
    fw = window_words(codes, k)
    rc = u64.reverse_complement(fw, k)
    n_win = L - k + 1
    idx = torch.arange(L, device=codes.device)
    wv = window_valid(vmask, k) & (idx < n_win)
    return KmerWindows(fw=fw, rc=rc, valid=wv, n_windows=n_win)


def kmer_windows(ascii_u8: torch.Tensor, k: int) -> KmerWindows:
    """Pack + window + reverse complement over [.., L] uint8 reads (pad
    ragged reads with any non-ACGT byte)."""
    return _windows(encoding.ascii_to_codes(ascii_u8),
                    encoding.valid_mask(ascii_u8), k)


def unpack_codes(words: torch.Tensor, n_bases: int) -> torch.Tensor:
    """[.., L/16] code words (int32 bit patterns) -> [.., L] int64 codes."""
    shifts = torch.arange(16, device=words.device, dtype=torch.int64) * 2
    codes = (u64.as_uint32(words)[..., None] >> shifts) & 3
    return codes.reshape(*words.shape[:-1], n_bases)


def unpack_validbits(validbits: torch.Tensor, n_bases: int) -> torch.Tensor:
    """[.., L/32] validity bitmaps (1 bit per base, LSB first) -> bool
    [.., L]."""
    shifts = torch.arange(32, device=validbits.device, dtype=torch.int64)
    bits = (u64.as_uint32(validbits)[..., None] >> shifts) & 1
    return bits.reshape(*validbits.shape[:-1], n_bases).bool()


def kmer_windows_packed(words: torch.Tensor, validbits: torch.Tensor,
                        k: int) -> KmerWindows:
    """kmer_windows over packed ingest: [B, L/16] code words plus
    [B, L/32] validity bitmaps (the io.fastx.read_packed_batches layout)."""
    L = words.shape[-1] * 16
    if validbits.shape[-1] * 32 != L:
        raise ValueError(f"words {tuple(words.shape)} and validbits "
                         f"{tuple(validbits.shape)} disagree on L")
    return _windows(unpack_codes(words, L), unpack_validbits(validbits, L), k)


_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def canonical_from_string(s: str) -> int:
    """Canonical word of one k-mer string (any case) as a Python int.
    Raises ValueError on a non-ACGT character or a length outside 1..31."""
    k = len(s)
    check_k(k)
    fw = 0
    for i, ch in enumerate(s.upper()):
        if ch not in _CODE:
            raise ValueError(f"non-ACGT character {ch!r} in {s!r}")
        fw |= _CODE[ch] << (2 * i)
    rc = 0
    for i in range(k):
        rc |= (3 - ((fw >> (2 * i)) & 3)) << (2 * (k - 1 - i))
    return min(fw, rc)
