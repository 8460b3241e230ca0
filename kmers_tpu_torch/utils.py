"""Const-fn utilities (parity with src/utils.rs) and the bitmer helper
(counterpart of ``kmers_tpu/utils.py``)."""

from __future__ import annotations


def kmer_space(k: int) -> int:
    """Number of k-mers: 4^k (utils.rs:27-29)."""
    return 4 ** k


def canonical_space(k: int) -> int:
    """Number of canonical k-mers as the reference defines it
    (utils.rs:32-38): 4^k / 2 for odd k, 4^k / 2 - 2k for even k.

    The true even-k count is (4^k + 4^(k/2)) / 2; the reference's formula
    is baked into its tests (utils.rs:61-73), so it is kept, not fixed."""
    if k % 2 == 1:
        return kmer_space(k) // 2
    return kmer_space(k) // 2 - 2 * k


def bitmer_to_bytes(mer: int, length: int) -> bytes:
    """LSB-first unpack with the uppercase map 0->A, 1->C, 2->G, 3->T
    (src/kmer.rs:71-91)."""
    out = bytearray()
    for _ in range(length):
        out.append(b"ACGT"[mer & 0b11])
        mer >>= 2
    return bytes(out)
