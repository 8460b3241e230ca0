"""Wide window kernels K7 and K8: ASCII reads -> canonical 128-bit keys.

Counterparts of ``kmers_tpu/kernels/window_wide.py``:

* ``pack_canonical_keys_wide`` (K7, 33 <= k <= 63), the counting
  consumer's emission: folded (k3, k2, k1, k0) int32 planes [B, L], most
  significant first, the invalid flag in bit 31 of k3; invalid lanes are
  exactly (0x80000000, 0, 0, 0) -- ``count.UnitTableWide``'s layout.
* ``pack_canonical_hash_wide`` (K8, 33 <= k <= 64), the hash emitter:
  (c0, c1, c2, c3) little-endian words of the canonical word, the 128-bit
  mixer hash (hash_hi, hash_lo) and a valid byte.  Invalid lanes are not
  zeroed (nor on the TPU): compare valid lanes with other code.

Lane p is the window that starts at base p.  CUDA source:
``csrc/window_wide.cu``.
"""

from __future__ import annotations

import torch

from ..core import u64, u128
from ..core.spec import MAX_K, check_k_range
from ..ops import kmer
from . import _build, count_launch, on_cuda
from .window import check_reads


def _canonical_windows(reads: torch.Tensor, k: int):
    win = kmer.kmer_windows_wide(reads, k)
    return kmer.canonical_word_wide(win.fw, win.rc), win.valid


def pack_canonical_keys_wide_plain(reads: torch.Tensor, k: int):
    """Plain version of K7: the ASCII wide windows of ops.kmer, folded."""
    (hi, lo), valid = _canonical_windows(reads, k)
    return u128.fold_invalid(hi, lo, valid)


def pack_canonical_hash_wide_plain(reads: torch.Tensor, k: int,
                                   seed: int = 0):
    """Plain version of K8: the ASCII wide windows, their canonical words
    (c0..c3, least significant first) and u128.mix_hash."""
    (hi, lo), valid = _canonical_windows(reads, k)
    hh, hl, lh, ll = u128.split_planes(hi, lo)
    return ((ll, lh, hl, hh) + u64.split_word(u128.mix_hash(hi, lo, seed))
            + (valid.to(torch.uint8),))


def _launch(name: str, entry: str, reads: torch.Tensor, k: int,
            dtypes: tuple, scalars: tuple = ()) -> tuple:
    """Launch `entry`(reads, one [B, L] output per dtype, B, L, k,
    *scalars, stream) and count it."""
    B, L = reads.shape
    out = [torch.empty((B, L), dtype=dt, device=reads.device)
           for dt in dtypes]
    with torch.cuda.device(reads.device):
        code = getattr(_build.lib(), entry)(
            reads.data_ptr(), *(o.data_ptr() for o in out), B, L, k,
            *scalars, torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    count_launch(name)
    return tuple(out)


def pack_canonical_keys_wide(reads: torch.Tensor, k: int):
    """K7: [B, L] uint8 ASCII reads, 33 <= k <= 63 -> folded
    (k3, k2, k1, k0) [B, L] int32 (kmers_tpu/kernels/window_wide.py:147).
    On the card each thread builds the first window of a run of 8
    consecutive lanes of the flattened batch and rolls the other 7 in a
    base at a time; any L >= k."""
    check_k_range(k, 33, MAX_K, "pack_canonical_keys_wide")
    check_reads(reads, k)
    if not on_cuda(reads):
        return pack_canonical_keys_wide_plain(reads, k)
    return _launch("pack_canonical_keys_wide", "kt_pack_keys_wide", reads,
                   k, (torch.int32,) * 4)


def pack_canonical_hash_wide(reads: torch.Tensor, k: int, seed: int = 0):
    """K8: [B, L] uint8 ASCII reads, 33 <= k <= 64 -> (c0, c1, c2, c3,
    hash_hi, hash_lo) [B, L] int32 and valid [B, L] uint8
    (kmers_tpu/kernels/window_wide.py:178).  On the card it rolls runs of
    8 lanes as K7 does, and masks the bases of a window that pass its
    row's end to code 0, so that invalid lanes too hold the plain
    version's words."""
    check_k_range(k, 33, 64, "pack_canonical_hash_wide")
    check_reads(reads, k)
    if not on_cuda(reads):
        return pack_canonical_hash_wide_plain(reads, k, seed)
    return _launch("pack_canonical_hash_wide", "kt_pack_hash_wide", reads,
                   k, (torch.int32,) * 6 + (torch.uint8,),
                   (seed & u64.MASK64,))
