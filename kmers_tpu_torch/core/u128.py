"""128-bit k-mer words as pairs of ``int64`` tensors (hi, lo).

Counterpart of ``kmers_tpu/core/u128.py`` for 33 <= k <= 64: the value is
``hi * 2**64 + lo`` (both taken as unsigned), base i at bits 2i, so lo
holds bases 0..31 and hi bases 32..k-1.  Tables and kernels keep four
``int32`` planes (hh, hl, lh, ll), most significant first, as the JAX
package's ``UnitTableWide``/``CountTableWide`` do.

``lo`` uses all 64 bits, so every order on it (compare, sort, search)
goes through ``u64.to_unsigned_order``.  ``hi`` holds at most 2k - 64
bits, plus the folded invalid flag at bit 63 in a unit table.
"""

from __future__ import annotations

import torch

from . import u64
from .spec import check_k_range


def join_planes(hh, hl, lh, ll):
    """Four int32 planes (most significant first) -> (hi, lo) int64."""
    return u64.join_planes(hh, hl), u64.join_planes(lh, ll)


def split_planes(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """(hi, lo) int64 -> four contiguous int32 planes (hh, hl, lh, ll)."""
    return u64.split_word(hi) + u64.split_word(lo)


def fold_invalid(hi: torch.Tensor, lo: torch.Tensor,
                 valid: torch.Tensor) -> tuple:
    """33 <= k <= 63 words + validity -> folded (hh, hl, lh, ll) int32
    planes: the invalid flag in bit 31 of hh, invalid lanes exactly
    (0x80000000, 0, 0, 0)."""
    return split_planes(torch.where(valid, hi, u64.SIGN_BIT),
                        torch.where(valid, lo, 0))


def from_ints(values, device=None):
    """Python ints (unsigned 128-bit) -> (hi, lo) int64 tensors."""
    signed = lambda v: v - (1 << 64) if v >> 63 else v
    hi = [signed((v >> 64) & u64.MASK64) for v in values]
    lo = [signed(v & u64.MASK64) for v in values]
    return (torch.tensor(hi, dtype=torch.int64, device=device),
            torch.tensor(lo, dtype=torch.int64, device=device))


def to_ints(hi: torch.Tensor, lo: torch.Tensor) -> list:
    """(hi, lo) int64 tensors -> flat list of unsigned Python ints."""
    return [((h & u64.MASK64) << 64) | (l & u64.MASK64)
            for h, l in zip(hi.reshape(-1).tolist(), lo.reshape(-1).tolist())]


def sort_keys(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """Each word mapped so that the signed lexicographic order of the pair
    is the unsigned 128-bit order (an involution)."""
    return u64.to_unsigned_order(hi), u64.to_unsigned_order(lo)


def lt(a_hi, a_lo, b_hi, b_lo) -> torch.Tensor:
    """a < b as unsigned 128-bit values."""
    ah, al = sort_keys(a_hi, a_lo)
    bh, bl = sort_keys(b_hi, b_lo)
    return (ah < bh) | ((ah == bh) & (al < bl))


def eq(a_hi, a_lo, b_hi, b_lo) -> torch.Tensor:
    return (a_hi == b_hi) & (a_lo == b_lo)


def argsort(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of 1-D 128-bit words, unsigned: a stable
    sort by lo, then a stable sort by hi (equal words keep their order)."""
    sh, sl = sort_keys(hi, lo)
    by_lo = torch.sort(sl, stable=True).indices
    return by_lo[torch.sort(sh[by_lo], stable=True).indices]


def shr(hi: torch.Tensor, lo: torch.Tensor, n: int) -> tuple:
    """Logical right shift by a static 0 <= n <= 128."""
    if n == 0:
        return hi, lo
    if n >= 64:
        return torch.zeros_like(hi), u64.shr(hi, n - 64)
    return u64.shr(hi, n), u64.shr(lo, n) | u64.shl(hi, 64 - n)


def reverse_bases(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """Reverse all 64 base slots: per-word ladders plus the word swap."""
    return u64.reverse_bases(lo), u64.reverse_bases(hi)


def reverse_complement(hi: torch.Tensor, lo: torch.Tensor, k: int) -> tuple:
    """128-bit naive_impl revcomp (1 <= k <= 64): complement, reverse,
    shift down to k bases (kmers_tpu/core/u128.py:156-159)."""
    check_k_range(k, 1, 64, "u128.reverse_complement")
    r_hi, r_lo = reverse_bases(~hi, ~lo)
    return shr(r_hi, r_lo, 2 * (64 - k))


def lex_hash(hi: torch.Tensor, lo: torch.Tensor, k: int) -> tuple:
    """The order-preserving base reversal (LexHasher extended to
    1 <= k <= 64, kmers_tpu/core/u128.py:162-165)."""
    check_k_range(k, 1, 64, "u128.lex_hash")
    return shr(*reverse_bases(hi, lo), 2 * (64 - k))


def mix_hash(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0):
    """128-bit word -> 64-bit int64 bucketing hash, bit-identical to
    kmers_tpu.core.u128.mix_hash."""
    inner = u64.mix_hash(hi, seed ^ 0xA5A5A5A5)
    return u64.mix_hash(lo ^ inner, seed)
