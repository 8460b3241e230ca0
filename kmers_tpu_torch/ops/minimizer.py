"""Sliding-window minimizers (counterpart of ``kmers_tpu/ops/minimizer.py``).

For every k-mer i of a read, the leftmost w-mer with the minimal order
among positions [i, i + k - w]: an unrolled scan of the k-w+1 shifted
order arrays with strict-< updates, so the leftmost tie wins, as the
reference's deque does (minimizers.rs:72-79).  Orders are 64-bit values
in int64 words and compare as unsigned (bit 63 flipped around every
compare).  This is the plain version the minimizer kernel K9
(kernels/minimizer.py) is held against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..core import u64
from . import encoding
from .kmer import _shift_left, window_valid, window_words


class MappedMinimizer(NamedTuple):
    """Scalar (word, pos) minimizer record (minimizers.rs:20-36)."""

    word: int
    pos: int


class MappedMinimizers(NamedTuple):
    """Per-k-mer minimizers of a read batch."""

    word: torch.Tensor   # int64 minimizer w-mer word per k-mer position
    pos: torch.Tensor    # int32 absolute position of that w-mer
    valid: torch.Tensor  # bool: the k-mer window holds only bases
    n_kmers: int         # L - k + 1


def sliding_argmin(hashes: torch.Tensor,
                   window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each position i, (min hash, leftmost offset) over
    hashes[i .. i+window-1] as unsigned 64-bit values, zero past the end
    of the row (as the JAX package pads)."""
    best = hashes
    best_key = u64.to_unsigned_order(hashes)
    best_off = torch.zeros(hashes.shape, dtype=torch.int32,
                           device=hashes.device)
    for off in range(1, window):
        h = _shift_left(hashes, off)
        key = u64.to_unsigned_order(h)
        take = key < best_key
        best = torch.where(take, h, best)
        best_key = torch.where(take, key, best_key)
        best_off = torch.where(take, off, best_off)
    return best, best_off


def _gather_winner(wmers: torch.Tensor, best_off: torch.Tensor):
    """(word[i] = wmers[i + best_off[i]], pos = i + best_off[i])."""
    L = wmers.shape[-1]
    idx = torch.arange(L, dtype=torch.int32, device=wmers.device)
    pos = idx + best_off
    src = torch.clamp(pos, max=L - 1).to(torch.int64)
    return torch.take_along_dim(wmers, src, dim=-1), pos


def minimizer_stream(ascii_u8: torch.Tensor, k: int, w: int,
                     hash_fn: Callable[[torch.Tensor], torch.Tensor]
                     ) -> MappedMinimizers:
    """All per-k-mer minimizers of a read batch [.., L]: k-mer i yields the
    word and position of the leftmost minimal-order w-mer in
    [i, i + k - w] (SeqVector::iter_minimizers, minimizers.rs:97-142)."""
    L = ascii_u8.shape[-1]
    if not L >= k >= w >= 1:
        raise ValueError(f"minimizers need L >= k >= w >= 1, got L={L}, "
                         f"k={k}, w={w}")
    codes = encoding.ascii_to_codes(ascii_u8)
    wmers = window_words(codes, w)
    _, best_off = sliding_argmin(hash_fn(wmers), k - w + 1)
    word, pos = _gather_winner(wmers, best_off)
    n_kmers = L - k + 1
    idx = torch.arange(L, device=ascii_u8.device)
    valid = window_valid(encoding.valid_mask(ascii_u8), k) & (idx < n_kmers)
    return MappedMinimizers(word=word, pos=pos, valid=valid, n_kmers=n_kmers)


def minimizer_stream_from_words(wmers: torch.Tensor, n_positions: int, k: int,
                                w: int,
                                hash_fn: Callable[[torch.Tensor], torch.Tensor]):
    """minimizer_stream from precomputed w-mer words at every position.
    Returns (word, pos) over the position axis; entries past
    n_positions - k + w - 1 are garbage."""
    _, best_off = sliding_argmin(hash_fn(wmers), k - w + 1)
    return _gather_winner(wmers, best_off)
