"""State to and from numpy, in the JAX package's layouts: count tables,
SeqVector words and the 32-bit lanes of the generic and wideint layers.

The state a run carries is the count table.  ``kmers_tpu``'s checkpoint
stores it as little-endian uint32 key planes -- ``keys_hi``/``keys_lo``
for k <= 32, ``keys_hi_hi``/``keys_hi_lo``/``keys_lo_hi``/``keys_lo_lo``
for 33 <= k <= 64 -- with ``counts`` (little-endian int32) and
``n_unique``; these functions map that layout to the port's CountTable /
CountTableWide on any device and back, so a checkpoint written by either
package resumes in the other.

A SeqVector is its uint32 words (the npz's ``words``) and its base count;
generic and wideint lanes are tuples of uint32 arrays, lane 0 least
significant.  The port holds both as ``int64`` tensors of the uint32
values.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.seqvector import SeqVector
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


def _u32_values(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected uint32 values, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def seqvector_from_numpy(words_u32, n_bases: int, device) -> SeqVector:
    """The JAX package's SeqVector state (uint32 words, base count) -> a
    SeqVector on `device`, the same words."""
    return SeqVector(_u32_values(words_u32, device), int(n_bases))


def seqvector_to_numpy(sv: SeqVector) -> tuple:
    """SeqVector -> (uint32 words, base count), the JAX package's state."""
    return sv.words.cpu().numpy().astype(np.uint32), sv.n_bases


def lanes_from_numpy(lanes, device) -> tuple:
    """uint32 lane arrays (generic / wideint) -> int64 lane tensors on
    `device`."""
    return tuple(_u32_values(x, device) for x in lanes)


def lanes_to_numpy(lanes) -> tuple:
    """int64 lane tensors -> uint32 lane arrays, the JAX package's lanes."""
    return tuple(x.cpu().numpy().astype(np.uint32) for x in lanes)
