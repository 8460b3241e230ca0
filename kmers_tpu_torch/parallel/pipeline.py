"""Per-batch counting (counterpart of ``kmers_tpu/parallel/pipeline.py``).

Single device, "unit" aggregation only: a batch becomes the window
kernel's raw folded canonical keys, one occurrence per valid lane, with
no per-batch sort (the deferred consolidation sorts every pending lane
anyway).  k <= 31 and 33 <= k <= 63; the "compact" and "runlength" forms
(k = 32, 64), and the sharded pipelines, are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..core.spec import MAX_K, check_k_range
from ..kernels import window as kwin
from ..kernels import window_wide as kww
from ..ops import kmer
from .count import UnitTable, UnitTableWide, unit_table_wide


class CountResult(NamedTuple):
    table: UnitTable | UnitTableWide
    metrics: Dict[str, torch.Tensor]


def _count_metrics(n_reads: int, n_win: int,
                   emitted: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch counters; tensors stay on the device (no sync)."""
    return {
        "reads": n_reads,
        "kmers_emitted": emitted,
        "windows_skipped": n_reads * n_win - emitted,
    }


def count_reads(reads: torch.Tensor, k: int) -> CountResult:
    """[B, L] uint8 ASCII reads -> UnitTable of folded canonical keys
    (window kernel K2)."""
    kh, kl = kwin.pack_canonical_keys(reads, k)
    emitted = (kh >= 0).sum()
    return CountResult(UnitTable(kh, kl), _count_metrics(
        reads.shape[0], reads.shape[-1] - k + 1, emitted))


def count_reads_packed(words: torch.Tensor, validbits: torch.Tensor,
                       k: int) -> CountResult:
    """count_reads over packed ingest ([B, L/16] code words + [B, L/32]
    validity bitmaps, int32) with window kernel K1."""
    kh, kl = kwin.pack_canonical_keys_packed(words, validbits, k)
    emitted = (kh >= 0).sum()
    return CountResult(UnitTable(kh, kl), _count_metrics(
        words.shape[0], words.shape[-1] * 16 - k + 1, emitted))


def count_reads_wide(reads: torch.Tensor, k: int) -> CountResult:
    """[B, L] uint8 ASCII reads, 33 <= k <= 63 -> UnitTableWide of folded
    canonical keys (wide window kernel K7; kmers_tpu/parallel/
    pipeline.py:363)."""
    keys = kww.pack_canonical_keys_wide(reads, k)
    emitted = (keys[0] >= 0).sum()
    return CountResult(UnitTableWide(keys), _count_metrics(
        reads.shape[0], reads.shape[-1] - k + 1, emitted))


def count_reads_packed_wide(words: torch.Tensor, validbits: torch.Tensor,
                            k: int) -> CountResult:
    """count_reads_wide over packed ingest.  The packed wide windows have
    no kernel in the JAX package either: they are ops.kmer's torch code on
    every device (kmers_tpu/parallel/pipeline.py:398)."""
    check_k_range(k, 33, MAX_K, "count_reads_packed_wide")
    win = kmer.kmer_windows_packed_wide(words, validbits, k)
    table = unit_table_wide(kmer.canonical_word_wide(win.fw, win.rc),
                            win.valid)
    return CountResult(table, _count_metrics(
        words.shape[0], win.n_windows, win.valid.sum()))
