"""ASCII -> 2-bit base codes (counterpart of ``kmers_tpu/ops/encoding.py``).

Lane arithmetic instead of a lookup table, as in the JAX package:

  internal = (c >> 1) & 3               # A=0, C=1, T=2, G=3 (any case)
  acgt     = internal ^ (internal >> 1) # A=0, C=1, G=2, T=3

and validity as four compares on the lowercased byte.
"""

from __future__ import annotations

import torch


def ascii_to_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> naive_impl codes (A=0, C=1, G=2, T=3) as int64.
    Garbage for invalid bytes; pair with `valid_mask`."""
    c = ascii_u8.to(torch.int64)
    internal = (c >> 1) & 3
    return internal ^ (internal >> 1)


def valid_mask(ascii_u8: torch.Tensor) -> torch.Tensor:
    """True where the byte is one of ACGTacgt."""
    lower = ascii_u8.to(torch.int64) | 0x20
    return ((lower == ord("a")) | (lower == ord("c"))
            | (lower == ord("g")) | (lower == ord("t")))
