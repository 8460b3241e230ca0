"""Little-endian bit vectors of any width as tuples of 32-bit lanes
(counterpart of ``kmers_tpu/core/wideint.py``).

The generic k-mer layer (``Kmer<P, K, B>``, src/kmer.rs:12-14) stores a
[P; B] word array with LSB-first 2-bit bases, which is one bitstring of
B * P bits: ``n_lanes`` lanes, lane j holding bits [32j, 32j + 32).  Each
lane is an ``int64`` tensor holding the uint32 value (0 <= x < 2^32), so
shifts and compares need no sign handling; every operation that could
set a bit past 31 masks it off.  Shift amounts are static.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .u64 import LOW32

Lanes = Tuple[torch.Tensor, ...]   # little-endian uint32 values in int64


def n_lanes(total_bits: int) -> int:
    return max(1, (total_bits + 31) // 32)


def zeros_like(a: Lanes) -> Lanes:
    return tuple(torch.zeros_like(x) for x in a)


def from_scalar(value: int, nl: int, shape=(), device="cuda") -> Lanes:
    return tuple(torch.full(shape, (value >> (32 * j)) & LOW32,
                            dtype=torch.int64, device=device)
                 for j in range(nl))


def to_python_ints(a: Lanes) -> List[int]:
    """Lanes -> flat list of Python ints (lane 0 least significant)."""
    flats = [x.reshape(-1).tolist() for x in a]
    return [sum((f[i] & LOW32) << (32 * j) for j, f in enumerate(flats))
            for i in range(len(flats[0]))]


def from_python_ints(vals: Sequence[int], nl: int, device="cuda") -> Lanes:
    return tuple(torch.tensor([(v >> (32 * j)) & LOW32 for v in vals],
                              dtype=torch.int64, device=device)
                 for j in range(nl))


# -- bitwise -----------------------------------------------------------------

def and_(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x & y for x, y in zip(a, b))


def or_(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x | y for x, y in zip(a, b))


def xor(a: Lanes, b: Lanes) -> Lanes:
    return tuple(x ^ y for x, y in zip(a, b))


def not_(a: Lanes) -> Lanes:
    return tuple(x ^ LOW32 for x in a)


def and_const(a: Lanes, c: int) -> Lanes:
    return tuple(x & ((c >> (32 * j)) & LOW32) for j, x in enumerate(a))


def xor_const(a: Lanes, c: int) -> Lanes:
    return tuple(x ^ ((c >> (32 * j)) & LOW32) for j, x in enumerate(a))


# -- shifts (static) ----------------------------------------------------------

def _lane(a: Lanes, j: int) -> torch.Tensor:
    return a[j] if 0 <= j < len(a) else torch.zeros_like(a[0])


def shl(a: Lanes, n: int) -> Lanes:
    lane_shift, bit = divmod(n, 32)
    out = []
    for j in range(len(a)):
        x = _lane(a, j - lane_shift)
        if bit:
            x = ((x << bit) & LOW32) | (_lane(a, j - lane_shift - 1)
                                        >> (32 - bit))
        out.append(x)
    return tuple(out)


def shr(a: Lanes, n: int) -> Lanes:
    lane_shift, bit = divmod(n, 32)
    out = []
    for j in range(len(a)):
        x = _lane(a, j + lane_shift)
        if bit:
            x = (x >> bit) | ((_lane(a, j + lane_shift + 1) << (32 - bit))
                              & LOW32)
        out.append(x)
    return tuple(out)


# -- compares -----------------------------------------------------------------

def eq(a: Lanes, b: Lanes) -> torch.Tensor:
    r = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        r = r & (x == y)
    return r


def lt(a: Lanes, b: Lanes) -> torch.Tensor:
    """a < b, deciding from the most significant lane down."""
    result = a[-1] < b[-1]
    equal_so_far = a[-1] == b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        result = result | (equal_so_far & (x < y))
        equal_so_far = equal_so_far & (x == y)
    return result


def min_(a: Lanes, b: Lanes) -> Lanes:
    take_a = lt(a, b)
    return tuple(torch.where(take_a, x, y) for x, y in zip(a, b))


# -- base (2-bit group) ops ----------------------------------------------------

def _ladder32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 base slots of one lane."""
    for s, m in ((2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> s) & m) | ((x & m) << s)
    return (x >> 16) | ((x << 16) & LOW32)


def reverse_bases(a: Lanes) -> Lanes:
    """Reverse all 16 * n_lanes base slots: the lane order reversed and
    each lane's slots reversed."""
    return tuple(_ladder32(x) for x in reversed(a))


def reverse_bases_k(a: Lanes, k: int) -> Lanes:
    """Reverse the low k bases, the result in the low 2k bits."""
    return shr(reverse_bases(a), 32 * len(a) - 2 * k)


def map2bit(a: Lanes, table: Sequence[int]) -> Lanes:
    """Map every 2-bit base slot through table (table[c] is the image of
    code c), all slots at once: out = t0 ^ b0 (t0^t1) ^ b1 (t0^t2)
    ^ b0 b1 (t0^t1^t2^t3), each gate widened from a slot's low bit to both
    of its bits and ANDed with the constant repeated over all slots.  Any
    of the 24 permutation complements is such a table
    (encoding/naive.rs:98-109)."""
    t0, t1, t2, t3 = (int(t) & 3 for t in table)
    lo = 0x55555555                      # the low bit of every slot

    def rep(c: int) -> int:
        return (lo if c & 1 else 0) | ((lo << 1) if c & 2 else 0)

    def per_lane(x):
        b0 = x & lo
        b1 = (x >> 1) & lo

        def gate(bits, c):
            return (bits | (bits << 1)) & rep(c)

        out = gate(b0, t0 ^ t1) ^ gate(b1, t0 ^ t2) \
            ^ gate(b0 & b1, t0 ^ t1 ^ t2 ^ t3)
        return out ^ rep(t0)

    return tuple(per_lane(x) for x in a)
