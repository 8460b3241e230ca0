"""Count tables to and from numpy, in the checkpoint's layout.

The state a run carries is the count table.  ``kmers_tpu``'s checkpoint
stores it as little-endian uint32 key planes -- ``keys_hi``/``keys_lo``
for k <= 32, ``keys_hi_hi``/``keys_hi_lo``/``keys_lo_hi``/``keys_lo_lo``
for 33 <= k <= 64 -- with ``counts`` (little-endian int32) and
``n_unique``; these functions map that layout to the port's CountTable /
CountTableWide on any device and back, so a checkpoint written by either
package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.count import CountTable, CountTableWide, make_table

KEY_NAMES = ("keys_hi", "keys_lo")
WIDE_KEY_NAMES = ("keys_hi_hi", "keys_hi_lo", "keys_lo_hi", "keys_lo_lo")


def _plane(a, dtype: str, device) -> torch.Tensor:
    arr = np.array(a, dtype=dtype, copy=True).view(np.int32)
    return torch.from_numpy(arr).to(device)


def _table(keys, counts, n_unique, device):
    cap = len(counts)
    if any(len(k) != cap for k in keys):
        raise ValueError("key planes and counts differ in length")
    n_unique = int(n_unique)
    if not 0 <= n_unique <= cap:
        raise ValueError(f"n_unique={n_unique} outside [0, {cap}]")
    return make_table(tuple(_plane(k, "<u4", device) for k in keys),
                      _plane(counts, "<i4", device), n_unique)


def table_from_numpy(keys_hi, keys_lo, counts, n_unique, device) -> CountTable:
    """uint32 key planes + int32 counts -> CountTable on `device`."""
    return _table((keys_hi, keys_lo), counts, n_unique, device)


def wide_table_from_numpy(keys, counts, n_unique, device) -> CountTableWide:
    """Four uint32 key planes (most significant first) + int32 counts ->
    CountTableWide on `device`."""
    if len(keys) != 4:
        raise ValueError(f"a wide table has 4 key planes, got {len(keys)}")
    return _table(keys, counts, n_unique, device)


def table_from_npz(z, device):
    """The table of an open checkpoint npz, either key layout."""
    names = WIDE_KEY_NAMES if WIDE_KEY_NAMES[0] in z.files else KEY_NAMES
    return _table([z[n] for n in names], z["counts"], z["n_unique"], device)


def table_to_numpy(table) -> dict:
    """CountTable or CountTableWide -> {<key plane names> <u4, counts <i4,
    n_unique i8}, the checkpoint's arrays."""
    host = lambda t: t.detach().cpu().numpy()
    names = WIDE_KEY_NAMES if isinstance(table, CountTableWide) else KEY_NAMES
    out = {name: host(p).view(np.uint32).astype("<u4")
           for name, p in zip(names, table.keys)}
    out["counts"] = host(table.counts).astype("<i4")
    out["n_unique"] = np.int64(table.n_unique)
    return out
