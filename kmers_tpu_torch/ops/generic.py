"""The batched generic k-mer layer (counterpart of
``kmers_tpu/ops/generic.py``): ``Kmer<P, const K, B>`` (src/kmer.rs:12-14)
over any word width P in {u8, u16, u32, u64, u128} and any of the 24 Naive
permutation encodings or Xor10 (src/encoding/).

A [P; B] word array with LSB-first 2-bit bases is one bitstring, so all
widths share one layout of 32-bit lanes (core.wideint: int64 tensors
holding uint32 values); P decides only the padding (``decode`` emits the
storage's padding bases, the reference's quirk, encoding/naive.rs:126-136)
and the host-side word format.

Xor10's ``rev_comp`` is the correct two-pointer reversal, as in the JAX
package: the reference's single-word Xor10 fast path is broken
(xor10.rs:84, its tests disabled) and is not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core import wideint as wi
from ..core.wideint import Lanes
from ..oracle.numpy_ref import NAIVE_PERMS, word_for_k
from . import encoding as enc
from .kmer import _shift_left, pack_u32_words

_XOR10_DISC = 0b00_01_10_11      # Xor10 codes are the internal order


@dataclasses.dataclass(frozen=True)
class GenericSpec:
    """Static configuration of a generic k-mer type.

    encoding: one of the 24 permutation strings (e.g. "ACGT") or "xor10".
    """

    width_bits: int
    k: int
    encoding: str = "ACTG"

    def __post_init__(self):
        if self.width_bits not in (8, 16, 32, 64, 128):
            raise ValueError(f"unsupported width {self.width_bits}")
        if self.encoding != "xor10" and self.encoding not in NAIVE_PERMS:
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")

    @property
    def n_words(self) -> int:
        return word_for_k(self.width_bits, self.k)

    @property
    def total_bits(self) -> int:
        return self.width_bits * self.n_words

    @property
    def total_bases(self) -> int:
        """Storage base slots, padding included (decode emits them all)."""
        return self.total_bits // 2

    @property
    def n_lanes(self) -> int:
        return wi.n_lanes(self.total_bits)

    @property
    def disc(self) -> int:
        return (_XOR10_DISC if self.encoding == "xor10"
                else NAIVE_PERMS[self.encoding])

    @property
    def comp_table(self) -> List[int]:
        """code -> complement code, the 2-bit table of this encoding."""
        if self.encoding == "xor10":
            return [c ^ 0b10 for c in range(4)]
        code_of = [(self.disc >> (6 - 2 * i)) & 3 for i in range(4)]
        internal_of = [0] * 4
        for i, c in enumerate(code_of):
            internal_of[c] = i
        return [code_of[internal_of[c] ^ 0b10] for c in range(4)]


def base_codes(spec: GenericSpec, ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII [.., k] -> per-base 2-bit codes (int64) under spec's encoding.
    Any byte encodes: the generic layer has no N (encoding/naive.rs:14-16)."""
    if spec.encoding == "xor10":
        return enc.ascii_to_internal(ascii_u8)
    return enc.perm_encode(ascii_u8, spec.disc)


def pack(spec: GenericSpec, codes: torch.Tensor) -> Lanes:
    """Per-base codes [.., k] -> lanes [..], LSB-first."""
    k = codes.shape[-1]
    if k != spec.k:
        raise ValueError(f"{k} codes for a k={spec.k} spec")
    nl = spec.n_lanes
    c = codes.to(torch.int64) & 3
    pad = nl * 16 - k
    if pad:
        c = torch.cat([c, c.new_zeros(*c.shape[:-1], pad)], dim=-1)
    c = c.reshape(*c.shape[:-1], nl, 16)
    shifts = torch.arange(16, dtype=torch.int64, device=c.device) * 2
    lanes = (c << shifts).sum(dim=-1)        # disjoint bits: the sum is an OR
    return tuple(lanes[..., j] for j in range(nl))


def encode(spec: GenericSpec, ascii_u8: torch.Tensor) -> Lanes:
    """Kmer::new(seq, &encoder), batched (src/kmer.rs:21-28)."""
    return pack(spec, base_codes(spec, ascii_u8))


def encode_windows(spec: GenericSpec, ascii_u8: torch.Tensor):
    """Kmer::new over every k-window of [.., L] reads at once: (lanes,
    valid), where lanes[j][.., p] is lane j of the k-mer starting at base
    p and valid[.., p] = (p <= L - k) (validity is structural only: the
    generic encoder takes any byte).

    Each base is encoded once and the windows come from the shared 16-base
    log-doubling pack (ops.kmer.pack_u32_words); bit for bit the per-window
    `encode` at valid positions.  Lanes at p > L - k are zero-padded
    garbage, the JAX package's garbage."""
    k = spec.k
    L = ascii_u8.shape[-1]
    if k > L:
        raise ValueError(f"row length {L} is shorter than k={k}")
    w16 = pack_u32_words(base_codes(spec, ascii_u8))
    lanes = []
    for j in range(spec.n_lanes):
        bits = 2 * k - 32 * j          # payload bits left for this lane
        if bits <= 0:
            lanes.append(torch.zeros_like(w16))
            continue
        lane = _shift_left(w16, 16 * j)
        if bits < 32:
            lane = lane & ((1 << bits) - 1)
        lanes.append(lane)
    idx = torch.arange(L, device=ascii_u8.device)
    valid = torch.broadcast_to(idx <= L - k, ascii_u8.shape)
    return tuple(lanes), valid


def unpack_codes(spec: GenericSpec, lanes: Lanes) -> torch.Tensor:
    """Lanes -> per-base codes [.., total_bases], padding slots included
    (the decode quirk)."""
    shifts = torch.arange(16, dtype=torch.int64, device=lanes[0].device) * 2
    codes = torch.cat([(x[..., None] >> shifts) & 3 for x in lanes], dim=-1)
    return codes[..., :spec.total_bases]


def decode(spec: GenericSpec, lanes: Lanes) -> torch.Tensor:
    """Lanes -> ASCII uint8 [.., total_bases]: every storage slot, the
    padding bases included (encoding/naive.rs:126-136)."""
    codes = unpack_codes(spec, lanes)
    if spec.encoding == "xor10":
        return enc.select4(codes, b"ACTG").to(torch.uint8)
    return enc.perm_decode(codes, spec.disc)


def rev_comp(spec: GenericSpec, lanes: Lanes) -> Lanes:
    """Reverse complement over the low k bases (the two-pointer semantics
    of encoding/naive.rs:138-154, and the corrected Xor10)."""
    return wi.reverse_bases_k(wi.map2bit(lanes, spec.comp_table), spec.k)


def get(spec: GenericSpec, lanes: Lanes, index: int) -> torch.Tensor:
    """Kmer::get(i): the 2-bit code of base i (src/kmer.rs:46-48)."""
    lane, off = divmod(2 * index, 32)
    return (lanes[lane] >> off) & 3


def get_prefix(spec: GenericSpec, lanes: Lanes, length: int) -> Lanes:
    """Kmer::get_prefix(len): bits 0..=2 len, i.e. 2 len + 1 bits, the
    reference's inclusive-range off-by-one kept (src/kmer.rs:50-52)."""
    return wi.and_const(lanes, (1 << (2 * length + 1)) - 1)


# -- host-side word formatting (parity / serialization) ------------------------

def lanes_to_words(spec: GenericSpec, lanes: Lanes) -> np.ndarray:
    """Lanes -> host [.., n_words] object array of P-width Python ints."""
    vals = wi.to_python_ints(lanes)
    P = spec.width_bits
    mask = (1 << P) - 1
    out = [[(v >> (P * w)) & mask for w in range(spec.n_words)]
           for v in vals]
    arr = np.array(out, dtype=object)
    return arr.reshape(tuple(lanes[0].shape) + (spec.n_words,))


def words_to_lanes(spec: GenericSpec, words, device="cuda") -> Lanes:
    """Host [.., n_words] P-width ints -> flat lanes [N] on `device`."""
    arr = np.array(words, dtype=object)
    if arr.shape[-1] != spec.n_words:
        raise ValueError(
            f"expected last dim {spec.n_words} words for k={spec.k} "
            f"P=u{spec.width_bits}, got {arr.shape[-1]}")
    P = spec.width_bits
    vals = [sum(int(w) << (P * i) for i, w in enumerate(row))
            for row in arr.reshape(-1, spec.n_words)]
    return wi.from_python_ints(vals, spec.n_lanes, device=device)


# -- trivial accessors (API parity with src/kmer.rs) ---------------------------

def k_of(spec: GenericSpec) -> int:
    """Kmer::k() (src/kmer.rs:36-38)."""
    return spec.k


def num_bytes(spec: GenericSpec) -> int:
    """Kmer::num_bytes(): bytes of the word array (src/kmer.rs:41-43)."""
    return spec.total_bits // 8


def default(spec: GenericSpec, shape=(), device="cuda") -> Lanes:
    """Kmer::default(): zeroed storage (src/kmer.rs:55-64)."""
    return wi.from_scalar(0, spec.n_lanes, shape, device=device)


def with_data(spec: GenericSpec, words, device="cuda") -> Lanes:
    """Kmer::with_data(array) (src/kmer.rs:31-33)."""
    return words_to_lanes(spec, words, device=device)
