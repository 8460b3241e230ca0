"""Search kernel K12: the count of each query word in a compact count table.

No TPU kernel of the JAX package does this: ``kmers_tpu/parallel/count.py``'s
``lookup`` is a jnp binary search.  The table's keys are its (hi, lo) int32
planes, ascending as unsigned words over the first ``n_unique`` slots; a
query is an int64 word in the same bit layout.  On the card one kernel
searches the planes as they are (``csrc/lookup.cu``); the plain version
joins the live keys into int64 words and runs ``torch.searchsorted``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import u64
from . import _build, check_tensor, count_launch, on_cuda

def _check(keys_hi, keys_lo, counts, n_unique, queries, valid) -> None:
    cap = counts.shape[0] if counts.dim() == 1 else -1
    for name, t in (("keys_hi", keys_hi), ("keys_lo", keys_lo),
                    ("counts", counts)):
        check_tensor(t, name, torch.int32, (cap,))
    if not 0 <= n_unique <= cap:
        raise ValueError(f"n_unique {n_unique} outside 0..{cap}")
    check_tensor(queries, "queries", torch.int64, tuple(queries.shape))
    if valid is not None:
        check_tensor(valid, "valid", torch.bool, tuple(queries.shape))


def search_counts_plain(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                        counts: torch.Tensor, n_unique: int,
                        queries: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K12: torch.searchsorted of the queries over the
    live keys joined into int64 words, in unsigned order (bit 63 flipped
    on both sides), then -1 where `valid` is false."""
    if n_unique == 0:
        got = torch.zeros(queries.shape, dtype=torch.int32,
                          device=queries.device)
    else:
        keys = u64.to_unsigned_order(
            u64.join_planes(keys_hi[:n_unique], keys_lo[:n_unique]))
        q = u64.to_unsigned_order(queries)
        at = torch.searchsorted(keys, q)
        at_c = at.clamp(max=n_unique - 1)
        hit = (at < n_unique) & (keys[at_c] == q)
        got = torch.where(hit, counts[at_c], 0)
    return got if valid is None else torch.where(valid, got, -1)


def search_counts(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                  counts: torch.Tensor, n_unique: int, queries: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12: int32 counts in the queries' shape: the count of each int64
    query word among the first n_unique slots of the table's planes
    (keys_hi, keys_lo, counts: int32 [capacity], keys ascending as
    unsigned (hi, lo)), 0 if absent, -1 where `valid` (bool, the queries'
    shape) is false.  Every tensor contiguous and on one device.

    On the card, n_unique < 2^31: one thread a lane, a lower-bound binary
    search on the planes, the lo plane read only where the hi values tie;
    invalid lanes do no search.  No host sync and no allocation but the
    answers, so it can be captured in a CUDA graph."""
    _check(keys_hi, keys_lo, counts, n_unique, queries, valid)
    tensors = (keys_hi, keys_lo, counts, queries) + (
        () if valid is None else (valid,))
    if not on_cuda(*tensors):
        return search_counts_plain(keys_hi, keys_lo, counts, n_unique,
                                   queries, valid)
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(queries.device):
        code = _build.lib().kt_search_counts(
            keys_hi.data_ptr(), keys_lo.data_ptr(), counts.data_ptr(),
            n_unique, queries.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            out.numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "search_counts")
    count_launch("search_counts")
    return out
