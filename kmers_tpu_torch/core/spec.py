"""Static k-mer configuration.

Counterpart of ``kmers_tpu/core/spec.py``: one frozen object carries k,
the minimizer width and the hash seed into the pipelines and the CLI.
The JAX package's TPU tuning knobs (segment lanes, the segment-count
kernel, the bitonic sort) have no meaning here and are not carried.
"""

from __future__ import annotations

import dataclasses

NARROW_MAX_K = 31      # one 64-bit key with a spare flag bit
MAX_K = 63             # two 64-bit keys with a spare flag bit
WORD_K = 32            # the most bases one 64-bit word holds
MAX_WIDE_K = 64        # the most bases a 128-bit word holds


def check_k(k: int) -> None:
    """Raise ValueError unless the port counts this k: 1 <= k <= 32 (one
    64-bit key) or 33 <= k <= 64 (a 128-bit key).  k = 32 and k = 64 fill
    every key bit, so no invalid flag folds in: they count through the
    run-length form (KmerSpec.aggregate)."""
    if not 1 <= k <= MAX_WIDE_K:
        raise ValueError(f"k={k} is outside the counted range 1..{MAX_WIDE_K}")


def check_k_range(k: int, lo: int, hi: int, what: str) -> None:
    """Raise ValueError unless lo <= k <= hi: the range a function's word
    layout holds (e.g. 1..32 for one 64-bit word, 33..63 for a folded
    128-bit key)."""
    if not lo <= k <= hi:
        raise ValueError(f"{what} takes {lo} <= k <= {hi}, got k={k}")


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """k-mer configuration.

    Attributes:
      k: k-mer length in bases (1..64).
      w: minimizer width (None if minimizers are unused).
      seed: seed of the mixer hash (routing / minimizer order).
    """

    k: int
    w: int | None = None
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.k <= 64):
            raise ValueError(f"k={self.k} out of supported range [1, 64]")
        if self.w is not None and not (1 <= self.w <= min(self.k, 32)):
            raise ValueError(f"w={self.w} invalid for k={self.k}")

    @property
    def wide(self) -> bool:
        """Whether keys are 128-bit (33 <= k <= 64)."""
        return self.k > 32

    @property
    def aggregate(self) -> str:
        """Per-batch table form: "unit" whenever the spare flag bit exists
        (k != 32, 64), else the run-length fallback."""
        return ("unit" if (self.k <= NARROW_MAX_K
                           or WORD_K < self.k <= MAX_K) else "runlength")
