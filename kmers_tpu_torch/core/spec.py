"""Static k-mer configuration.

Counterpart of ``kmers_tpu/core/spec.py``: one frozen object carries k,
the minimizer width and the hash seed into the pipelines and the CLI.
The JAX package's TPU tuning knobs (segment lanes, the segment-count
kernel, the bitonic sort) have no meaning here and are not carried.
"""

from __future__ import annotations

import dataclasses

MAX_K = 31


def check_k(k: int) -> None:
    """Raise ValueError unless the port counts this k (1 <= k <= 31):
    bit 31 of hi must be spare for the folded invalid flag, and int64
    words must keep their sign bit clear."""
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k} is not ported: this port counts 1 <= k <= {MAX_K} "
            "(k = 32 needs the run-length path, k > 32 the wide tier)")


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """k-mer configuration.

    Attributes:
      k: k-mer length in bases (1..64; this port counts k <= 31).
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
        return ("unit" if (self.k <= 31 or 33 <= self.k <= 63)
                else "runlength")
