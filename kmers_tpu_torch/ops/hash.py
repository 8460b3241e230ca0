"""Batched k-mer hashing (counterpart of ``kmers_tpu/ops/hash.py``).

The framework's stable seedable mixer for bucketing and routing, on the
port's int64 words; bit-identical to the JAX package's.  The lex hash
and the minimizer orders come with the minimizer path.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import u64, u128


def mix_hash(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """int64 words -> int64 64-bit hashes (kmers_tpu.ops.hash.mix_hash)."""
    return u64.mix_hash(words, seed)


def mix_hash_fn(seed: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda w: u64.mix_hash(w, seed)


def mix_hash_wide(hi: torch.Tensor, lo: torch.Tensor,
                  seed: int = 0) -> torch.Tensor:
    """128-bit (hi, lo) words -> int64 64-bit hashes
    (kmers_tpu.core.u128.mix_hash)."""
    return u128.mix_hash(hi, lo, seed)
