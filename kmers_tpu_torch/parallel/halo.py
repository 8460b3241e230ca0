"""Sequence parallelism: one long sequence split into contiguous blocks,
one per shard, with a halo exchange (counterpart of
``kmers_tpu/parallel/halo.py``).

A k-mer window that spans a cut needs the first k-1 bases of the right
neighbour's block.  Each shard's block is extended by that prefix
(``mesh.shift_left``, where the JAX package sends it with a
``ppermute``; on a multi-process mesh the first block of process p + 1
extends the last of process p); the last shard's halo is zero bytes,
which are invalid ASCII, so the ordinary N masking drops the windows past
the global end.

A block shorter than k-1 bases ships all of itself, as in the JAX
package: the halo then holds fewer than k-1 bases, and a window that
spans more than one cut is never formed.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import kmer
from . import mesh as mesh_ops


def halo_exchange(blocks: Sequence[torch.Tensor], halo: int, mesh) -> list:
    """Each local shard's [L] ASCII block extended by the next global
    shard's first `halo` bytes (all L of them when L < halo):
    [L + min(halo, L)] per shard, zero bytes on the mesh's last one."""
    nbr = mesh_ops.shift_left([b[..., :halo] for b in blocks], mesh)
    return [torch.cat([b, n], -1) for b, n in zip(blocks, nbr)]


def _sharded(blocks, k: int, mesh, windows, wrap) -> list:
    """The windows of every extended block; window p is valid only for
    p < L (a window starting in the halo belongs to the next shard)."""
    out = []
    for ext, b in zip(halo_exchange(blocks, k - 1, mesh), blocks):
        win = windows(ext[None, :], k)
        n = b.shape[-1]
        idx = torch.arange(ext.shape[-1], device=ext.device)
        out.append(wrap(win.fw, win.rc, win.valid & (idx < n)[None, :], n))
    return out


def sharded_windows(blocks: Sequence[torch.Tensor], k: int, mesh) -> list:
    """All k-mer windows (k <= 32) of a sequence split into one [L] uint8
    block per local shard: one KmerWindows per local shard over its
    extended block, shape [1, L + halo]; window p < L is the k-mer starting
    at global position shard * L + p (shard the global index)."""
    return _sharded(blocks, k, mesh, kmer.kmer_windows, kmer.KmerWindows)


def sharded_windows_wide(blocks: Sequence[torch.Tensor], k: int,
                         mesh) -> list:
    """sharded_windows for 33 <= k <= 64: one KmerWindowsWide per shard."""
    return _sharded(blocks, k, mesh, kmer.kmer_windows_wide,
                    kmer.KmerWindowsWide)
