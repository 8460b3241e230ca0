"""Window kernels K1, K2 and K5: reads -> canonical keys (k <= 32).

Counterparts of ``kmers_tpu/kernels/window.py``'s
``pack_canonical_keys_packed`` (K1) and ``pack_canonical_keys`` (K2),
k <= 31: (key_hi, key_lo) int32 planes [B, L] holding uint32 bit
patterns; lane p is the window that starts at base p; invalid lanes are
exactly (0x80000000, 0).  Both take JAX's ``stage``: "canon" (the
default, the canonical word) or "pack" (the forward word, the roofline
ablation's compute-light arm).  (The TPU's K1 emits a permuted "q-order";
the counting consumer treats lanes as a multiset, and the port emits
plain p-order.)  And of ``pack_canonical_hash`` (K5, the hash emitter),
k <= 32: canonical word, its mixer hash and a valid byte.  CUDA source:
``csrc/window.cu``.
"""

from __future__ import annotations

import torch

from ..core import u64
from ..core.spec import NARROW_MAX_K, check_k_range
from ..ops import hash as hash_ops
from ..ops import kmer
from . import (_build, check_stage, check_tensor, count_launch, on_cuda,
               variant)

STAGES = ("canon", "pack")     # K1's and K2's stages; "pack" emits fw


def _stage_words(win, stage: str):
    """The folded words of a stage: canonical, or forward at "pack"."""
    words = kmer.canonical_word(win.fw, win.rc) if stage == "canon" else win.fw
    return u64.fold_invalid(words, win.valid)


def pack_canonical_keys_packed_plain(words: torch.Tensor,
                                     validbits: torch.Tensor, k: int,
                                     stage: str = "canon"):
    """Plain version of K1: the packed windows of ops.kmer, folded; the
    forward words at stage "pack"."""
    check_stage(stage, STAGES, "pack_canonical_keys_packed")
    return _stage_words(kmer.kmer_windows_packed(words, validbits, k), stage)


def pack_canonical_keys_plain(reads: torch.Tensor, k: int,
                              stage: str = "canon"):
    """Plain version of K2: the ASCII windows of ops.kmer, folded; the
    forward words at stage "pack"."""
    check_stage(stage, STAGES, "pack_canonical_keys")
    return _stage_words(kmer.kmer_windows(reads, k), stage)


def pack_canonical_keys_packed(words: torch.Tensor, validbits: torch.Tensor,
                               k: int, stage: str = "canon"):
    """K1: [B, L/16] int32 code words + [B, L/32] int32 validity bitmaps
    (io.fastx.read_packed_batches layout, L % 32 == 0) -> folded
    (key_hi, key_lo) [B, L] int32 (kmers_tpu/kernels/window.py:338); the
    forward words at stage "pack"."""
    check_k_range(k, 1, NARROW_MAX_K, "pack_canonical_keys_packed")
    check_stage(stage, STAGES, "pack_canonical_keys_packed")
    if words.dim() != 2:
        raise ValueError(f"words must be [B, L/16], got {tuple(words.shape)}")
    B, nw = words.shape
    L = nw * 16
    if L % 32:
        raise ValueError(f"packed ingest needs L % 32 == 0, got L={L}")
    check_tensor(words, "words", torch.int32, (B, nw))
    check_tensor(validbits, "validbits", torch.int32, (B, L // 32))
    if not on_cuda(words, validbits):
        return pack_canonical_keys_packed_plain(words, validbits, k, stage)
    hi = torch.empty((B, L), dtype=torch.int32, device=words.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(words.device):
        code = _build.lib().kt_pack_keys_packed(
            words.data_ptr(), validbits.data_ptr(), hi.data_ptr(),
            lo.data_ptr(), B, L, k, STAGES.index(stage),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pack_canonical_keys_packed")
    count_launch(variant("pack_canonical_keys_packed", stage, "canon"))
    return hi, lo


def check_reads(reads: torch.Tensor, k: int) -> tuple:
    """(B, L) of a contiguous [B, L] uint8 batch with L >= k, else raise."""
    if reads.dim() != 2:
        raise ValueError(f"reads must be [B, L], got {tuple(reads.shape)}")
    B, L = reads.shape
    if L < k:
        raise ValueError(f"row length {L} is shorter than k={k}")
    check_tensor(reads, "reads", torch.uint8, (B, L))
    return B, L


def pack_canonical_keys(reads: torch.Tensor, k: int, stage: str = "canon"):
    """K2: [B, L] uint8 ASCII reads -> folded (key_hi, key_lo) [B, L]
    int32 (kmers_tpu/kernels/window.py:391).  On the card each thread
    builds the first window of a run of 8 consecutive lanes of the
    flattened batch and rolls the other 7 in a base at a time; any
    L >= k."""
    check_k_range(k, 1, NARROW_MAX_K, "pack_canonical_keys")
    check_stage(stage, STAGES, "pack_canonical_keys")
    B, L = check_reads(reads, k)
    if not on_cuda(reads):
        return pack_canonical_keys_plain(reads, k, stage)
    hi = torch.empty((B, L), dtype=torch.int32, device=reads.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(reads.device):
        code = _build.lib().kt_pack_keys_ascii(
            reads.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, L, k,
            STAGES.index(stage), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pack_canonical_keys")
    count_launch(variant("pack_canonical_keys", stage, "canon"))
    return hi, lo


def pack_canonical_hash_plain(reads: torch.Tensor, k: int, seed: int = 0):
    """Plain version of K5: the ASCII windows of ops.kmer, their canonical
    words and ops.hash.mix_hash, invalid lanes zeroed."""
    win = kmer.kmer_windows(reads, k)
    canon = kmer.canonical_word(win.fw, win.rc)
    h = hash_ops.mix_hash(canon, seed)
    zero = lambda w: torch.where(win.valid, w, 0)
    return (u64.split_word(zero(canon)) + u64.split_word(zero(h))
            + (win.valid.to(torch.uint8),))


def pack_canonical_hash(reads: torch.Tensor, k: int, seed: int = 0):
    """K5: [B, L] uint8 ASCII reads, 1 <= k <= 32 -> (canon_hi, canon_lo,
    hash_hi, hash_lo) [B, L] int32 and valid [B, L] uint8; the four words
    are zero on invalid lanes (kmers_tpu/kernels/window.py:205).  On the
    card it runs K2's rolled runs and warp tiles, then hashes each lane;
    any L >= k."""
    check_k_range(k, 1, 32, "pack_canonical_hash")
    B, L = check_reads(reads, k)
    if not on_cuda(reads):
        return pack_canonical_hash_plain(reads, k, seed)
    out = [torch.empty((B, L), dtype=torch.int32, device=reads.device)
           for _ in range(4)]
    valid = torch.empty((B, L), dtype=torch.uint8, device=reads.device)
    with torch.cuda.device(reads.device):
        code = _build.lib().kt_pack_hash_ascii(
            reads.data_ptr(), *(o.data_ptr() for o in out), valid.data_ptr(),
            B, L, k, seed & u64.MASK64, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pack_canonical_hash")
    count_launch("pack_canonical_hash")
    return tuple(out) + (valid,)
