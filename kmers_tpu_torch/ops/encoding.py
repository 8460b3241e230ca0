"""ASCII <-> 2-bit base codes (counterpart of ``kmers_tpu/ops/encoding.py``).

Lane arithmetic instead of a lookup table, as in the JAX package:

  internal = (c >> 1) & 3               # A=0, C=1, T=2, G=3 (any case)
  acgt     = internal ^ (internal >> 1) # A=0, C=1, G=2, T=3

and validity as four compares on the lowercased byte.  Codes are int64
tensors; ASCII outputs are uint8.  The generic layer's encodings are the
24 Naive permutations, each named by its discriminant byte (the code of
A in bits 6..8, C in 4..6, T in 2..4, G in 0..2; encoding/naive.rs:49-74).
"""

from __future__ import annotations

import torch


def select4(c: torch.Tensor, table) -> torch.Tensor:
    """table[c] for codes c in 0..3, branch-free on the two code bits (no
    lookup tensor, so nothing is copied to the device)."""
    t0, t1, t2, t3 = (int(t) for t in table)
    b0 = c & 1
    b1 = (c >> 1) & 1
    return t0 + b0 * (t1 - t0) + b1 * ((t2 - t0) + b0 * (t3 - t2 - t1 + t0))


def ascii_to_internal(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> internal codes A=0, C=1, T=2, G=3 (int64).  Garbage
    for non-ACGT bytes; pair with `valid_mask`."""
    return (ascii_u8.to(torch.int64) >> 1) & 3


def internal_to_acgt(internal: torch.Tensor) -> torch.Tensor:
    """Internal order -> naive_impl order (swap codes 2 and 3)."""
    return internal ^ (internal >> 1)


def acgt_to_internal(codes: torch.Tensor) -> torch.Tensor:
    """naive_impl order -> internal order (the same involution)."""
    return codes ^ (codes >> 1)


def ascii_to_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> naive_impl codes (A=0, C=1, G=2, T=3) as int64.
    Garbage for invalid bytes; pair with `valid_mask`."""
    return internal_to_acgt(ascii_to_internal(ascii_u8))


def valid_mask(ascii_u8: torch.Tensor) -> torch.Tensor:
    """True where the byte is one of ACGTacgt."""
    lower = ascii_u8.to(torch.int64) | 0x20
    return ((lower == ord("a")) | (lower == ord("c"))
            | (lower == ord("g")) | (lower == ord("t")))


def codes_to_ascii(codes: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """naive_impl codes -> ASCII uint8: lowercase as Kmer's string
    (naive_impl/kmer.rs:24), uppercase as SeqVector's (seq_vector.rs:174)."""
    table = b"acgt" if lower else b"ACGT"
    return select4(codes.to(torch.int64) & 3, table).to(torch.uint8)


def _code_of(disc: int) -> list:
    """code_of[internal] under the permutation with discriminant `disc`."""
    return [(disc >> (6 - 2 * i)) & 3 for i in range(4)]


def perm_encode(ascii_u8: torch.Tensor, disc: int) -> torch.Tensor:
    """ASCII -> 2-bit codes under a Naive permutation with discriminant
    byte `disc` (encoding/naive.rs:78-85)."""
    return select4(ascii_to_internal(ascii_u8), _code_of(disc))


def rev_encoding(disc: int) -> int:
    """The inverse permutation's byte (encoding/naive.rs:29-39)."""
    rev = 0
    rev ^= 0b00 << (6 - ((disc >> 6) & 3) * 2)
    rev ^= 0b01 << (6 - ((disc >> 4) & 3) * 2)
    rev ^= 0b10 << (6 - ((disc >> 2) & 3) * 2)
    rev ^= 0b11 << (6 - (disc & 3) * 2)
    return rev


def perm_decode(codes: torch.Tensor, disc: int) -> torch.Tensor:
    """2-bit codes -> ASCII uint8 under a Naive permutation
    (encoding/naive.rs:88-95; INTERNAL2NUC = b"ACTG")."""
    internal = select4(codes.to(torch.int64) & 3, _code_of(rev_encoding(disc)))
    return select4(internal, b"ACTG").to(torch.uint8)


def perm_complement(codes: torch.Tensor, disc: int) -> torch.Tensor:
    """Complement in a Naive permutation: the internal complement is ^0b10
    (encoding/naive.rs:98-109)."""
    code_of = _code_of(disc)
    internal = select4(codes.to(torch.int64) & 3, _code_of(rev_encoding(disc)))
    return select4(internal ^ 0b10, code_of)
