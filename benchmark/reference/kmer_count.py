"""The plain reference of the benchmark: canonical k-mer counts and lookups
computed straight from ASCII reads with plain PyTorch (on the card, where
the harness runs it; on the CPU in the harness's tests).

It imports nothing of the program.  The semantics are the ones the
program's users are promised (COMBINE-lab/kmers' encoding):

  * bases A, C, G, T (either case) are the 2-bit codes 0, 1, 2, 3; any
    other byte makes every window that holds it invalid;
  * the forward word of the k bases c_0 .. c_{k-1} is sum c_i << 2i (base 0
    in the lowest bits), the reverse complement sum (3 - c_i) << 2(k-1-i),
    and the canonical word the smaller of the two as unsigned integers;
  * k <= 32 gives one 64-bit word; 33 <= k <= 64 a 128-bit word, split
    here as (hi, lo): lo holds bases 0..31, hi bases 32..k-1.

Every key is carried as two int64 tensors (hi, lo), each compared as an
unsigned word by flipping its sign bit (``_biased``; hi fills its 64 bits
at k = 64).  A table is the
sorted distinct canonical words with their counts.
"""

from __future__ import annotations

import numpy as np
import torch

#: byte -> 2-bit code, 4 for anything that is not a base
_LUT = np.full(256, 4, dtype=np.int64)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b | 0x20] = _i

_SIGN = -(1 << 63)
#: rows of reads a block while forming windows (keeps the temporaries at
#: a few hundred MB at 150 bp)
BLOCK_ROWS = 1 << 17


def read_fastq(path: str) -> np.ndarray:
    """The sequence lines of a FASTQ file of equal-length reads, as a
    [N, L] uint8 array."""
    buf = np.fromfile(path, dtype=np.uint8)
    ends = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    if len(ends) % 4 or (len(ends) and buf[starts[0]] != ord("@")):
        raise ValueError(f"{path}: not a FASTQ file of 4-line records")
    seq_start, seq_end = starts[1::4], ends[1::4]
    lengths = seq_end - seq_start
    if len(lengths) == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    if (lengths != lengths[0]).any():
        raise ValueError(f"{path}: reads of unequal length")
    idx = seq_start[:, None] + np.arange(lengths[0])[None, :]
    return buf[idx]


def _biased(lo: torch.Tensor) -> torch.Tensor:
    """lo with its sign bit flipped: signed order == unsigned order."""
    return lo ^ _SIGN


def _windows(codes: torch.Tensor, k: int, canonical: bool):
    """(hi, lo, valid) of every window of a [n, L] code block, flattened."""
    n, length = codes.shape
    w = length - k + 1
    bad = (codes == 4).to(torch.int32)
    cs = torch.nn.functional.pad(bad.cumsum(1), (1, 0))
    valid = (cs[:, k:] - cs[:, :w]) == 0
    c = codes & 3
    n_lo = min(k, 32)

    def fold(order, complement):
        word = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
        for i in order:
            base = 3 - c[:, i:i + w] if complement else c[:, i:i + w]
            word = (word << 2) | base
        return word

    fw_lo = fold(range(n_lo - 1, -1, -1), False)
    fw_hi = fold(range(k - 1, n_lo - 1, -1), False)
    if canonical:
        rc_hi = fold(range(0, k - n_lo), True)
        rc_lo = fold(range(k - n_lo, k), True)
        rc_less = (_biased(rc_hi) < _biased(fw_hi)) | (
            (rc_hi == fw_hi) & (_biased(rc_lo) < _biased(fw_lo)))
        hi = torch.where(rc_less, rc_hi, fw_hi)
        lo = torch.where(rc_less, rc_lo, fw_lo)
    else:
        hi, lo = fw_hi, fw_lo
    return hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)


def window_keys(reads: np.ndarray, k: int, device, canonical: bool = True):
    """(hi, lo, valid) int64 / bool tensors on `device`, one lane for every
    window of every read, row-major.  canonical=False gives the forward
    words (the benchmark's control)."""
    if not 1 <= k <= 64:
        raise ValueError(f"k must lie in 1..64, got {k}")
    lut = torch.from_numpy(_LUT).to(device)
    his, los, valids = [], [], []
    for first in range(0, reads.shape[0], BLOCK_ROWS):
        block = torch.from_numpy(
            np.ascontiguousarray(reads[first:first + BLOCK_ROWS])).to(device)
        hi, lo, valid = _windows(lut[block.to(torch.int64)], k, canonical)
        his.append(hi)
        los.append(lo)
        valids.append(valid)
    return torch.cat(his), torch.cat(los), torch.cat(valids)


def _sort_words(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) sorted as unsigned 128-bit words."""
    order = torch.sort(_biased(lo), stable=True).indices
    hi, lo = hi[order], lo[order]
    order = torch.sort(_biased(hi), stable=True).indices
    return hi[order], lo[order]


def count_keys(hi: torch.Tensor, lo: torch.Tensor):
    """Distinct (hi, lo) words, ascending as unsigned, with their counts
    (int64)."""
    hi, lo = _sort_words(hi, lo)
    if hi.numel() == 0:
        return hi, lo, torch.zeros(0, dtype=torch.int64, device=hi.device)
    new = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = torch.nonzero(new).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([hi.numel()])])
    return hi[starts], lo[starts], ends - starts


def count_reads(reads: np.ndarray, k: int, device, canonical: bool = True):
    """The table of a [N, L] uint8 read array: (hi, lo, counts) tensors,
    keys ascending as unsigned words."""
    hi, lo, valid = window_keys(reads, k, device, canonical)
    return count_keys(hi[valid], lo[valid])


def lookup(table, q_hi: torch.Tensor, q_lo: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Counts (int64) of query words in a table of one-word keys (k <= 32)
    from count_reads: 0 where absent, -1 on invalid lanes; a binary
    search of the unsigned order."""
    t_hi, t_lo, t_counts = table
    if bool((t_hi != 0).any()) or bool((q_hi[valid] != 0).any()):
        raise ValueError("lookup takes one-word keys (k <= 32)")
    n = t_lo.numel()
    out = torch.full(q_lo.shape, -1, dtype=torch.int64, device=q_lo.device)
    if n == 0:
        return torch.where(valid, 0, out)
    pos = torch.searchsorted(_biased(t_lo), _biased(q_lo)).clamp(max=n - 1)
    got = torch.where(t_lo[pos] == q_lo, t_counts[pos], 0)
    return torch.where(valid, got, out)
