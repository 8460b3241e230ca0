"""Batched k-mer hashing (counterpart of ``kmers_tpu/ops/hash.py``).

The framework's stable seedable mixer for bucketing and routing, the
reference's LexHasher, and the 32- and 16-bit minimizer selection
orders, on the port's int64 words; bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import u64, u128


def lex_hash(words: torch.Tensor, k: int) -> torch.Tensor:
    """LexHasher (kmers_tpu.ops.hash.lex_hash), 1 <= k <= 32."""
    return u64.lex_hash(words, k)


def lex_hash_fn(k: int) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda w: u64.lex_hash(w, k)


def mix_hash(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """int64 words -> int64 64-bit hashes (kmers_tpu.ops.hash.mix_hash)."""
    return u64.mix_hash(words, seed)


def mix_hash_fn(seed: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda w: u64.mix_hash(w, seed)


def mix32_hash_fn(seed: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The 32-bit minimizer selection order (u64.mix32_order)."""
    return lambda w: u64.mix32_order(w, seed)


def mix16_hash_fn(seed: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The 16-bit minimizer selection order: the top half of mix32_order
    (kmers_tpu.ops.hash.mix16_hash_fn).  Orders may tie; the leftmost
    candidate wins."""
    return lambda w: u64.shr(u64.mix32_order(w, seed), 16)


def mix_hash_wide(hi: torch.Tensor, lo: torch.Tensor,
                  seed: int = 0) -> torch.Tensor:
    """128-bit (hi, lo) words -> int64 64-bit hashes
    (kmers_tpu.core.u128.mix_hash)."""
    return u128.mix_hash(hi, lo, seed)
