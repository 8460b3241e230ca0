"""The small fixed count that ties the port to the JAX package.

``SMOKE_DIGEST`` (k = 31) and ``SMOKE_DIGEST_WIDE`` (k = 63, 128-bit
keys) are the ``npz_digest``s of the tables that ``python -m kmers_tpu
count`` writes for the seeded input below.  The tier-1 tests assert that
the JAX package on the CPU and the port on the CPU both produce them;
``chip_smoke.py`` asserts that the port produces them on the card, where
JAX is not installed.
"""

from __future__ import annotations

from .io import simulate

SMOKE_READS = dict(genome_len=20_000, n_reads=2_000, read_len=150,
                   sub_rate=1e-3, n_rate=1e-4, seed=20261016)

SMOKE_DIGEST = \
    "059b897089074da7e1b0f244ad4d2074bd3a1be6a8e73d5c7b0decfaf508c69a"

SMOKE_DIGEST_WIDE = \
    "8fff13fd4903f958af6c29b6e0cdc0a0655a2f6a258ac4c0cb48b04bae26896e"


def write_smoke_input(path: str) -> str:
    simulate.write_fastq(path, **SMOKE_READS)
    return path


def smoke_count_args(fastq: str, out: str, k: int = 31) -> list:
    """CLI arguments of the smoke count (either package's `count`)."""
    return ["count", fastq, "-k", str(k), "-o", out, "--capacity", "65536",
            "--batch", "256", "--length", "160"]
