"""The small fixed count that ties the port to the JAX package.

``SMOKE_DIGEST`` (k = 31), ``SMOKE_DIGEST_WIDE`` (k = 63, 128-bit keys),
``SMOKE_DIGEST_32`` and ``SMOKE_DIGEST_64`` (the run-length path: keys
that fill every bit) are the ``npz_digest``s of the tables that
``python -m kmers_tpu count`` writes for the seeded input below.  The tier-1 tests assert that
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

SMOKE_DIGEST_32 = \
    "ec4efec9e18e93fab90ff8a5d085b39e1acdb1f045b6dfeebb65b292849ee90f"

SMOKE_DIGEST_64 = \
    "e550a75f8387accd58dfbee383d7561311ec0a4d994d6117db0cad04fc341ccd"

# k -> the digest of its smoke count
SMOKE_DIGESTS = {31: SMOKE_DIGEST, 63: SMOKE_DIGEST_WIDE,
                 32: SMOKE_DIGEST_32, 64: SMOKE_DIGEST_64}


def write_smoke_input(path: str) -> str:
    simulate.write_fastq(path, **SMOKE_READS)
    return path


def smoke_count_args(fastq: str, out: str, k: int = 31) -> list:
    """CLI arguments of the smoke count (either package's `count`)."""
    return ["count", fastq, "-k", str(k), "-o", out, "--capacity", "65536",
            "--batch", "256", "--length", "160"]
