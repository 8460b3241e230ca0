"""Count tables to and from numpy, in the checkpoint's layout.

The state a run carries is the count table.  ``kmers_tpu``'s checkpoint
stores it as ``keys_hi``/``keys_lo`` (little-endian uint32), ``counts``
(little-endian int32) and ``n_unique``; these two functions map that
layout to the port's CountTable on any device and back, so a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.count import CountTable


def _plane(a, dtype: str, device) -> torch.Tensor:
    arr = np.array(a, dtype=dtype, copy=True).view(np.int32)
    return torch.from_numpy(arr).to(device)


def table_from_numpy(keys_hi, keys_lo, counts, n_unique, device) -> CountTable:
    """uint32 key planes + int32 counts -> CountTable on `device`."""
    cap = len(counts)
    if len(keys_hi) != cap or len(keys_lo) != cap:
        raise ValueError("keys_hi, keys_lo and counts differ in length")
    n_unique = int(n_unique)
    if not 0 <= n_unique <= cap:
        raise ValueError(f"n_unique={n_unique} outside [0, {cap}]")
    return CountTable(_plane(keys_hi, "<u4", device),
                      _plane(keys_lo, "<u4", device),
                      _plane(counts, "<i4", device), n_unique)


def table_to_numpy(table: CountTable) -> dict:
    """CountTable -> {keys_hi <u4, keys_lo <u4, counts <i4, n_unique i8}."""
    host = lambda t: t.detach().cpu().numpy()
    return dict(
        keys_hi=host(table.keys_hi).view(np.uint32).astype("<u4"),
        keys_lo=host(table.keys_lo).view(np.uint32).astype("<u4"),
        counts=host(table.counts).astype("<i4"),
        n_unique=np.int64(table.n_unique),
    )
