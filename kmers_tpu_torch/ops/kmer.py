"""Batched k-mer windows (counterpart of ``kmers_tpu/ops/kmer.py``).

Every window of a read batch at once, as ``int64`` words (base i of the
window at bits 2i, the reference's LSB-first layout):

  codes [.., L] --> log-doubling 16-base words w16[p] = bases p..p+15
        --> window p = w16[p] | (w16[p+16] masked) << 32
        --> reverse complement / canonical, all elementwise.

A window is valid iff its k bases are all valid and it starts at
p <= L - k; invalid windows carry garbage words that the mask filters.
These are the plain versions the window kernels (kernels/window.py,
kernels/window_wide.py) are held against.  A word is one int64 for
k <= 32 and a (hi, lo) pair of int64 for 33 <= k <= 64 (core/u128.py);
the packed wide windows have no kernel in the JAX package either, and
run as they are here on every device.

The word operations of the reference's Kmer / CanonicalKmer (rolling
appends and prepends, sub-k-mers, match type, the brute-force
minimizer) work elementwise on tensors of such words.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import u64, u128
from ..core.spec import WORD_K, check_k_range
from . import encoding


def _shift_left(a: torch.Tensor, s: int) -> torch.Tensor:
    """a'[.., p] = a[.., p+s], zero-padded at the tail (last axis)."""
    if s == 0:
        return a
    if s >= a.shape[-1]:
        return torch.zeros_like(a)
    tail = torch.zeros(*a.shape[:-1], s, dtype=a.dtype, device=a.device)
    return torch.cat([a[..., s:], tail], dim=-1)


def pack_u32_words(codes: torch.Tensor) -> torch.Tensor:
    """w16[.., p] = bases p..p+15 packed LSB-first (32 bits in an int64),
    zero-padded past the end of the row."""
    w = codes.to(torch.int64) & 3
    for s in (1, 2, 4, 8):
        w = w | (_shift_left(w, s) << (2 * s))
    return w


def window_words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """All k-mer windows of a code array as int64 words (1 <= k <= 32);
    entry p is the k-mer starting at base p (garbage for p > L - k: mask
    it)."""
    check_k_range(k, 1, 32, "window_words")
    w16 = pack_u32_words(codes)
    if k <= 16:
        return w16 & u64.mask(2 * k)
    hi = _shift_left(w16, 16) & u64.mask(2 * (k - 16))
    return (hi << 32) | w16


def window_valid(valid: torch.Tensor, k: int) -> torch.Tensor:
    """window_valid[p] = AND of valid[p..p+k-1], by log-doubling AND."""
    v = valid
    got = 1
    while got < k:
        step = got if got * 2 <= k else k - got
        v = v & _shift_left(v, step)
        got += step
    return v


class KmerWindows(NamedTuple):
    """All k-mer windows of a read batch."""

    fw: torch.Tensor      # int64 forward words, garbage where ~valid
    rc: torch.Tensor      # int64 reverse-complement words
    valid: torch.Tensor   # bool: the window holds no invalid base
    n_windows: int        # L - k + 1


def canonical_word(fw: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """min(fw, rc) as unsigned words, the canonical strand (at k = 32 a
    word may have bit 63 set)."""
    return u64.unsigned_min(fw, rc)


def reverse_complement(fw: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-base words, 1 <= k <= 32."""
    return u64.reverse_complement(fw, k)


def is_fw_canonical(fw: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """fw < rc as unsigned words (canonical_kmer.rs:66-69)."""
    return u64.to_unsigned_order(fw) < u64.to_unsigned_order(rc)


def is_canonical(fw: torch.Tensor, k: int) -> torch.Tensor:
    """Kmer::is_canonical: fw <= its reverse complement, so palindromes
    count (naive_impl/kmer.rs:55-58)."""
    return (u64.to_unsigned_order(fw)
            <= u64.to_unsigned_order(reverse_complement(fw, k)))


def _windows(codes: torch.Tensor, vmask: torch.Tensor, k: int) -> KmerWindows:
    L = codes.shape[-1]
    if L < k:
        raise ValueError(f"row length {L} is shorter than k={k}")
    fw = window_words(codes, k)
    rc = u64.reverse_complement(fw, k)
    n_win = L - k + 1
    idx = torch.arange(L, device=codes.device)
    wv = window_valid(vmask, k) & (idx < n_win)
    return KmerWindows(fw=fw, rc=rc, valid=wv, n_windows=n_win)


def kmer_windows(ascii_u8: torch.Tensor, k: int) -> KmerWindows:
    """Pack + window + reverse complement over [.., L] uint8 reads (pad
    ragged reads with any non-ACGT byte)."""
    return _windows(encoding.ascii_to_codes(ascii_u8),
                    encoding.valid_mask(ascii_u8), k)


def unpack_codes(words: torch.Tensor, n_bases: int) -> torch.Tensor:
    """[.., L/16] code words (int32 bit patterns) -> [.., L] int64 codes."""
    shifts = torch.arange(16, device=words.device, dtype=torch.int64) * 2
    codes = (u64.as_uint32(words)[..., None] >> shifts) & 3
    return codes.reshape(*words.shape[:-1], n_bases)


def unpack_validbits(validbits: torch.Tensor, n_bases: int) -> torch.Tensor:
    """[.., L/32] validity bitmaps (1 bit per base, LSB first) -> bool
    [.., L]."""
    shifts = torch.arange(32, device=validbits.device, dtype=torch.int64)
    bits = (u64.as_uint32(validbits)[..., None] >> shifts) & 1
    return bits.reshape(*validbits.shape[:-1], n_bases).bool()


def kmer_windows_packed(words: torch.Tensor, validbits: torch.Tensor,
                        k: int) -> KmerWindows:
    """kmer_windows over packed ingest: [B, L/16] code words plus
    [B, L/32] validity bitmaps (the io.fastx.read_packed_batches layout)."""
    L = words.shape[-1] * 16
    if validbits.shape[-1] * 32 != L:
        raise ValueError(f"words {tuple(words.shape)} and validbits "
                         f"{tuple(validbits.shape)} disagree on L")
    return _windows(unpack_codes(words, L), unpack_validbits(validbits, L), k)


# -- multi-word k-mers (33 <= k <= 64) -----------------------------------------

def window_words_wide(codes: torch.Tensor, k: int) -> tuple:
    """All k-mer windows for 33 <= k <= 64 as (hi, lo) int64 words: the
    same log-doubling pack, and a window at p is the four 16-base words
    at p, p+16, p+32, p+48 with the top one masked
    (kmers_tpu/ops/kmer.py:270)."""
    check_k_range(k, 33, 64, "window_words_wide")
    w16 = pack_u32_words(codes)
    lo = (_shift_left(w16, 16) << 32) | w16
    hi_lo = _shift_left(w16, 32)
    hi_hi = _shift_left(w16, 48)
    rem = k - 32                        # bases in the high word
    if rem <= 16:
        hi_lo = hi_lo & u64.mask(2 * rem)
        hi_hi = torch.zeros_like(hi_hi)
    else:
        hi_hi = hi_hi & u64.mask(2 * (rem - 16))
    return (hi_hi << 32) | hi_lo, lo


class KmerWindowsWide(NamedTuple):
    """All k-mer windows of a read batch, 128-bit words."""

    fw: tuple             # (hi, lo) int64 forward words, garbage where ~valid
    rc: tuple             # (hi, lo) int64 reverse-complement words
    valid: torch.Tensor
    n_windows: int


def canonical_word_wide(fw: tuple, rc: tuple) -> tuple:
    """Unsigned 128-bit min(fw, rc) (rc on ties, as u128.min_ takes)."""
    take_fw = u128.lt(*fw, *rc)
    return (torch.where(take_fw, fw[0], rc[0]),
            torch.where(take_fw, fw[1], rc[1]))


def _windows_wide(codes: torch.Tensor, vmask: torch.Tensor,
                  k: int) -> KmerWindowsWide:
    L = codes.shape[-1]
    if L < k:
        raise ValueError(f"row length {L} is shorter than k={k}")
    fw = window_words_wide(codes, k)
    rc = u128.reverse_complement(*fw, k)
    n_win = L - k + 1
    idx = torch.arange(L, device=codes.device)
    wv = window_valid(vmask, k) & (idx < n_win)
    return KmerWindowsWide(fw=fw, rc=rc, valid=wv, n_windows=n_win)


def kmer_windows_wide(ascii_u8: torch.Tensor, k: int) -> KmerWindowsWide:
    """kmer_windows for 33 <= k <= 64 (kmers_tpu/ops/kmer.py:301)."""
    return _windows_wide(encoding.ascii_to_codes(ascii_u8),
                         encoding.valid_mask(ascii_u8), k)


def kmer_windows_packed_wide(words: torch.Tensor, validbits: torch.Tensor,
                             k: int) -> KmerWindowsWide:
    """kmer_windows_wide over packed ingest (kmers_tpu/ops/kmer.py:316)."""
    L = words.shape[-1] * 16
    if validbits.shape[-1] * 32 != L:
        raise ValueError(f"words {tuple(words.shape)} and validbits "
                         f"{tuple(validbits.shape)} disagree on L")
    return _windows_wide(unpack_codes(words, L),
                         unpack_validbits(validbits, L), k)


# -- rolling updates (API parity with naive_impl) ------------------------------

def _base(b: torch.Tensor) -> torch.Tensor:
    """Base codes as the JAX package's uint32 lanes, in int64."""
    return b.to(torch.int64) & u64.LOW32


def append_base(data: torch.Tensor, b: torch.Tensor, k: int) -> tuple:
    """Kmer::append_base: shift right, insert b at base k-1; returns (new
    words, evicted low base) (naive_impl/kmer.rs:98-102)."""
    evicted = data & 3
    return u64.shr(data, 2) | u64.shl(_base(b), 2 * k - 2), evicted


def prepend_base(data: torch.Tensor, b: torch.Tensor, k: int) -> tuple:
    """Kmer::prepend_base: shift left, insert b at base 0, mask to k bases;
    returns (new words, evicted high base) (naive_impl/kmer.rs:91-95).

    The mask is MASK_TABLE[k], which is 0 at k = 32 (the reference's
    quirk), so a prepend at k = 32 zeroes the word, as in the JAX package."""
    evicted = u64.shr(data, 2 * k - 2) & 3
    keep = 0 if k == 32 else u64.mask(2 * k)
    return (u64.shl(data, 2) | (_base(b) & 3)) & keep, evicted


def ck_append_base(fw: torch.Tensor, rc: torch.Tensor, b: torch.Tensor,
                   k: int) -> tuple:
    """CanonicalKmer::append_base: append b to fw, prepend its complement
    to rc; returns (fw, rc, evicted) (canonical_kmer.rs:89-94)."""
    new_fw, evicted = append_base(fw, b, k)
    new_rc, _ = prepend_base(rc, 3 - (_base(b) & 3), k)
    return new_fw, new_rc, evicted


def ck_prepend_base(fw: torch.Tensor, rc: torch.Tensor, b: torch.Tensor,
                    k: int) -> tuple:
    """CanonicalKmer::prepend_base (canonical_kmer.rs:96-101)."""
    new_fw, evicted = prepend_base(fw, b, k)
    new_rc, _ = append_base(rc, 3 - (_base(b) & 3), k)
    return new_fw, new_rc, evicted


def sub_kmer_word(word: torch.Tensor, k: int, pos: int,
                  width: int) -> torch.Tensor:
    """(word >> 2 pos) masked to `width` bases (naive_impl/kmer.rs:156-162)."""
    if not (0 <= pos < k and pos + width <= k):
        raise ValueError(f"sub-k-mer [{pos}, {pos + width}) outside k={k}")
    return u64.shr(word, 2 * pos) & u64.mask(2 * width)


def match_type(fw: torch.Tensor, rc: torch.Tensor,
               other: torch.Tensor) -> torch.Tensor:
    """MatchType as int32: 0 NoMatch, 1 IdentityMatch, 2 TwinMatch
    (canonical_kmer.rs:141-161); identity is checked first."""
    return torch.where(fw == other, 1,
                       torch.where(rc == other, 2, 0)).to(torch.int32)


def minimizer(word: torch.Tensor, k: int, width: int,
              hash_fn: Callable[[torch.Tensor], torch.Tensor]) -> tuple:
    """Brute-force leftmost argmin of the hash over all k - width + 1
    sub-k-mers (naive_impl/kmer.rs:170-192): strict-< updates on unsigned
    hashes, so the leftmost tie wins.  Returns (words, int32 offsets)."""
    best_mmer = sub_kmer_word(word, k, 0, width)
    best_key = u64.to_unsigned_order(hash_fn(best_mmer))
    best_pos = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for pos in range(1, k - width + 1):
        mmer = sub_kmer_word(word, k, pos, width)
        key = u64.to_unsigned_order(hash_fn(mmer))
        take = key < best_key
        best_mmer = torch.where(take, mmer, best_mmer)
        best_key = torch.where(take, key, best_key)
        best_pos = torch.where(take, pos, best_pos)
    return best_mmer, best_pos


def append_base_wide(data: tuple, b: torch.Tensor, k: int) -> tuple:
    """append_base for 33 <= k <= 64 on (hi, lo) words: shift right, insert
    b at base k-1; returns ((hi, lo), evicted low base)."""
    check_k_range(k, 33, 64, "append_base_wide")
    hi, lo = u128.shr(*data, 2)
    return (hi | u64.shl(_base(b) & 3, 2 * k - 66), lo), data[1] & 3


def prepend_base_wide(data: tuple, b: torch.Tensor, k: int) -> tuple:
    """prepend_base for 33 <= k <= 64: shift left, insert b at base 0, mask
    to k bases (no k = 32-style quirk); returns ((hi, lo), evicted high
    base)."""
    check_k_range(k, 33, 64, "prepend_base_wide")
    hi, lo = data
    evicted = u64.shr(hi, 2 * k - 66) & 3
    new_hi = (u64.shl(hi, 2) | u64.shr(lo, 62)) & u64.mask(2 * k - 64)
    return (new_hi, u64.shl(lo, 2) | (_base(b) & 3)), evicted


_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def canonical_from_string(s: str) -> int:
    """Canonical word of one k-mer string (any case) as a Python int.
    Raises ValueError on a non-ACGT character or a length outside 1..32
    (at 32 the word may exceed 2^63: u64.from_ints makes the int64 query
    of it)."""
    check_k_range(len(s), 1, WORD_K, "canonical_from_string")
    return _canonical_int(s)


def canonical_from_string_wide(s: str) -> int:
    """canonical_from_string for 33 <= k <= 64: the unsigned 128-bit
    canonical word (u128.from_ints makes the (hi, lo) query of it)."""
    check_k_range(len(s), 33, 64, "canonical_from_string_wide")
    return _canonical_int(s)


def _canonical_int(s: str) -> int:
    k = len(s)
    fw = 0
    for i, ch in enumerate(s.upper()):
        if ch not in _CODE:
            raise ValueError(f"non-ACGT character {ch!r} in {s!r}")
        fw |= _CODE[ch] << (2 * i)
    rc = 0
    for i in range(k):
        rc |= (3 - ((fw >> (2 * i)) & 3)) << (2 * (k - 1 - i))
    return min(fw, rc)
