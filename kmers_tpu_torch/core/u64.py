"""64-bit k-mer words as ``int64`` tensors, and the uint32 plane layout.

The JAX package carries a word as a pair of uint32 planes because the
TPU's vector unit is 32-bit.  PyTorch has ``int64`` but few working
``uint32``/``uint64`` operators, so the port's plain path carries one
``int64`` per k-mer (``hi << 32 | lo``, base i at bits 2i) and its
kernels and tables use ``int32`` planes that hold the uint32 bit patterns.

Two traps of the signed word, handled here once:

* ``>>`` on ``int64`` is arithmetic, so every shift is followed by a mask.
* a folded invalid flag (bit 31 of hi) is bit 63 of the word, the sign
  bit.  ``to_unsigned_order`` flips it so that a signed compare or
  ``torch.sort`` orders words as unsigned 64-bit values (flagged lanes
  last); applying it twice is the identity.
"""

from __future__ import annotations

import torch

from .spec import check_k_range

SIGN_BIT = -(1 << 63)          # int64 with only bit 63 set
LOW32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1

_SWAP_LADDER = (
    (2, 0x3333333333333333),
    (4, 0x0F0F0F0F0F0F0F0F),
    (8, 0x00FF00FF00FF00FF),
    (16, 0x0000FFFF0000FFFF),
)


def mask(bits: int) -> int:
    """Low-`bits` mask as an int64 value: all ones (-1) for 64 bits."""
    return (1 << bits) - 1 if bits < 64 else -1


def shr(w: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words by a static 0 <= n <= 64."""
    if n == 0:
        return w
    if n >= 64:
        return torch.zeros_like(w)
    return (w >> n) & mask(64 - n)


def shl(w: torch.Tensor, n: int) -> torch.Tensor:
    """Left shift of int64 words by a static 0 <= n <= 64 (bits past 63
    drop out)."""
    return w << n if n < 64 else torch.zeros_like(w)


def join_planes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 planes (uint32 bit patterns) -> int64 words, bit-exact: a
    reinterpretation of the little-endian (lo, hi) pair, no arithmetic."""
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError(f"planes must be int32, got {hi.dtype}, {lo.dtype}")
    return torch.stack([lo, hi], dim=-1).view(torch.int64).squeeze(-1)


def split_word(w: torch.Tensor):
    """int64 words -> contiguous (hi, lo) int32 planes, bit-exact."""
    if w.dtype != torch.int64:
        raise TypeError(f"words must be int64, got {w.dtype}")
    pair = w.contiguous().view(torch.int32).view(*w.shape, 2)
    return pair[..., 1].contiguous(), pair[..., 0].contiguous()


def fold_invalid(words: torch.Tensor, valid: torch.Tensor):
    """k <= 31 words + validity -> folded (hi, lo) int32 planes: the
    invalid flag in bit 31 of hi, invalid lanes exactly (0x80000000, 0)."""
    return split_word(torch.where(valid, words, SIGN_BIT))


def from_ints(values, device=None) -> torch.Tensor:
    """Python ints (unsigned 64-bit) -> int64 tensor of the same bits."""
    return torch.tensor([v - (1 << 64) if v >> 63 else v for v in values],
                        dtype=torch.int64, device=device)


def to_ints(w: torch.Tensor) -> list:
    """int64 tensor -> flat list of unsigned Python ints."""
    return [v & MASK64 for v in w.reshape(-1).tolist()]


def to_unsigned_order(w: torch.Tensor) -> torch.Tensor:
    """Flip bit 63 so signed order equals unsigned order (an involution)."""
    return w ^ SIGN_BIT


def low32_as_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as an int32 bit pattern (exact,
    without relying on how an out-of-range cast rounds)."""
    return (((x & LOW32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return x.to(torch.int64) & LOW32


def reverse_bases(w: torch.Tensor) -> torch.Tensor:
    """Full 32-base reversal of a 64-bit word: the reference's 5-step swap
    ladder (strides 2, 4, 8, 16 and the 32-bit half swap)."""
    x = w
    for s, m in _SWAP_LADDER:
        x = ((x >> s) & m) | ((x & m) << s)
    return ((x >> 32) & LOW32) | (x << 32)


def reverse_complement(w: torch.Tensor, k: int) -> torch.Tensor:
    """Complement all, reverse, shift down to k bases (naive_impl
    revcomp), 1 <= k <= 32.  Result is masked to 2k bits."""
    check_k_range(k, 1, 32, "u64.reverse_complement")
    return shr(reverse_bases(~w), 64 - 2 * k)


def unsigned_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of int64 words as unsigned 64-bit values."""
    return to_unsigned_order(torch.minimum(to_unsigned_order(a),
                                           to_unsigned_order(b)))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values x held in int64, in two 16-bit
    halves of c so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & LOW32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit avalanche ('lowbias32') of kmers_tpu.core.u64._mix32 on
    uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix_hash(w: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Seedable 64-bit mixer of int64 words, bit-identical to
    kmers_tpu.core.u64.mix_hash (two mix32 rounds on each half)."""
    hi, lo = shr(w, 32), w & LOW32
    s_lo, s_hi = seed & LOW32, (seed >> 32) & LOW32
    out_lo = mix32(lo ^ mix32(hi ^ s_lo))
    out_hi = mix32(hi ^ mix32(lo ^ s_hi ^ 0x9E3779B9))
    return (out_hi << 32) | out_lo


def lex_hash(w: torch.Tensor, k: int) -> torch.Tensor:
    """LexHasher of k-base words, 1 <= k <= 32: the base reversal without
    the complement, shifted down to k bases (kmers_tpu.core.u64.lex_hash)."""
    check_k_range(k, 1, 32, "u64.lex_hash")
    return shr(reverse_bases(w), 64 - 2 * k)


def mix32_order(w: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The 32-bit minimizer selection order: the low half of mix_hash,
    high half zero (kmers_tpu.core.u64.mix32_order)."""
    return mix32((w & LOW32) ^ mix32(shr(w, 32) ^ (seed & LOW32)))


def _feistel_key(seed: int, r: int) -> int:
    return (seed + 0x9E3779B9 * (r + 1)) & LOW32


def feistel_mix(w: torch.Tensor, seed: int = 0, rounds: int = 3) -> torch.Tensor:
    """The bijective 64-bit routing mix of kmers_tpu.core.u64.feistel_mix
    (three Feistel rounds over mix32), on int64 words.  The halves are
    uint32 values in int64, so every sum wraps by a mask."""
    hi, lo = shr(w, 32), w & LOW32
    for r in range(rounds):
        hi, lo = lo, hi ^ mix32((lo + _feistel_key(seed, r)) & LOW32)
    return (hi << 32) | lo


def feistel_unmix(w: torch.Tensor, seed: int = 0,
                  rounds: int = 3) -> torch.Tensor:
    """Inverse of feistel_mix (exact, elementwise)."""
    hi, lo = shr(w, 32), w & LOW32
    for r in reversed(range(rounds)):
        hi, lo = lo ^ mix32((hi + _feistel_key(seed, r)) & LOW32), hi
    return (hi << 32) | lo
