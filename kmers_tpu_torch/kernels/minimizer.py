"""Minimizer kernel K9: reads -> the minimizer of every k-mer window.

Counterpart of ``kmers_tpu/kernels/minimizer.py``'s ``minimizer_kernel``:
at stage "full" (the default), for lane p of a [B, L] ASCII batch, the
word (hi, lo int32 planes) and absolute position (int32) of the leftmost
w-mer with the minimal order in [p, p + k - w], and a valid byte.  Stage
"hash" (the roofline ablation's arm, no window scan) emits instead the
forward w-mer word that starts at p, int32(lo) ^ int32(hi) of its order
in the position plane (mix16 unpacked: mix32 >> 16) and the k-window's
validity.  Orders: "mix64", "mix32", "mix16" and "lex" (the JAX kernel's
``use_lex=True``).  Invalid lanes are zero in every output, in the kernel
and in its plain version alike.  CUDA source: ``csrc/minimizer.cu``.
"""

from __future__ import annotations

import torch

from ..core import u64
from ..core.spec import check_k_range
from ..ops import encoding, kmer
from ..ops import hash as hash_ops
from ..ops import minimizer as mini
from . import _build, check_stage, count_launch, on_cuda, variant
from .window import check_reads

ORDERS = ("mix64", "mix32", "mix16", "lex")   # the kernel's order ids
STAGES = ("full", "hash")                     # "hash": no window scan


def order_fn(order: str, w: int, seed: int = 0):
    """The ops.hash function of a kernel order."""
    if order == "mix64":
        return hash_ops.mix_hash_fn(seed)
    if order == "mix32":
        return hash_ops.mix32_hash_fn(seed)
    if order == "mix16":
        return hash_ops.mix16_hash_fn(seed)
    if order == "lex":
        return hash_ops.lex_hash_fn(w)
    raise ValueError(f"order must be one of {ORDERS}, got {order!r}")


def _hash_stage_plain(reads: torch.Tensor, k: int, w: int, seed: int,
                      order: str):
    """Stage "hash": the forward w-mer word at p, int32(lo) ^ int32(hi) of
    its order, the k-window's validity, invalid lanes zeroed."""
    L = reads.shape[-1]
    wmers = kmer.window_words(encoding.ascii_to_codes(reads), w)
    o_hi, o_lo = u64.split_word(order_fn(order, w, seed)(wmers))
    idx = torch.arange(L, device=reads.device)
    valid = (kmer.window_valid(encoding.valid_mask(reads), k)
             & (idx < L - k + 1))
    hi, lo = u64.split_word(torch.where(valid, wmers, 0))
    return (hi, lo, torch.where(valid, o_lo ^ o_hi, 0),
            valid.to(torch.uint8))


def minimizer_kernel_plain(reads: torch.Tensor, k: int, w: int,
                           seed: int = 0, order: str = "mix64",
                           stage: str = "full"):
    """Plain version of K9: ops.minimizer.minimizer_stream under the
    order's hash function (stage "hash": the w-mer words and their
    orders), invalid lanes zeroed."""
    check_stage(stage, STAGES, "minimizer_kernel")
    if stage == "hash":
        return _hash_stage_plain(reads, k, w, seed, order)
    mm = mini.minimizer_stream(reads, k, w, order_fn(order, w, seed))
    hi, lo = u64.split_word(torch.where(mm.valid, mm.word, 0))
    return hi, lo, torch.where(mm.valid, mm.pos, 0), mm.valid.to(torch.uint8)


def minimizer_kernel(reads: torch.Tensor, k: int, w: int, seed: int = 0,
                     order: str = "mix64", stage: str = "full"):
    """K9: [B, L] uint8 ASCII reads, 1 <= w <= min(k, 32), k <= 64 ->
    (word_hi, word_lo) int32 [B, L], pos int32 [B, L], valid uint8 [B, L]
    (kmers_tpu/kernels/minimizer.py:278)."""
    check_k_range(k, 1, 64, "minimizer_kernel")
    check_k_range(w, 1, min(k, 32), "minimizer_kernel (w)")
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    check_stage(stage, STAGES, "minimizer_kernel")
    B, L = check_reads(reads, k)
    if not on_cuda(reads):
        return minimizer_kernel_plain(reads, k, w, seed, order, stage)
    out = [torch.empty((B, L), dtype=torch.int32, device=reads.device)
           for _ in range(3)]
    valid = torch.empty((B, L), dtype=torch.uint8, device=reads.device)
    with torch.cuda.device(reads.device):
        code = _build.lib().kt_minimizer(
            reads.data_ptr(), *(o.data_ptr() for o in out), valid.data_ptr(),
            B, L, k, w, seed & u64.MASK64, ORDERS.index(order),
            STAGES.index(stage), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "minimizer_kernel")
    count_launch(variant("minimizer_kernel", stage, "full"))
    return tuple(out) + (valid,)
