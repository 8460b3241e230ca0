"""Seeded synthetic reads: a random genome, uniformly placed fixed-length
reads on either strand, substitutions and N bases, written as FASTQ.

The benchmark's copy of the program's ``kmers_tpu_torch/io/simulate.py``
(the benchmark reads nothing of the program to make its inputs).  One
addition: ``genome_seed`` draws the genome from a stream of its own, so
fresh reads of one genome come from another seed (the lookup's queries).

Uses numpy's legacy ``RandomState``, whose streams numpy keeps stable
across versions, so a seed names the same reads on every machine (the
smoke digest depends on it).  Reads are made in chunks to bound memory.
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CHUNK = 1 << 16


def _genome_codes(rs: np.random.RandomState, genome_len: int) -> np.ndarray:
    return rs.randint(0, 4, size=genome_len).astype(np.uint8)


def genome(genome_len: int, seed: int) -> np.ndarray:
    """The [genome_len] uint8 ASCII genome that iter_reads and write_fastq
    sample their reads from for the same seed."""
    return _ACGT[_genome_codes(np.random.RandomState(seed), genome_len)]


def iter_reads(genome_len: int, n_reads: int, read_len: int,
               sub_rate: float, n_rate: float, seed: int,
               genome_seed=None):
    """Yield [n, read_len] uint8 ASCII read chunks (n_reads in total).
    Without genome_seed the genome and the reads share `seed`'s stream, as
    in the program's simulator; with it the genome is
    genome(genome_len, genome_seed)'s and `seed` draws only the reads."""
    rs = np.random.RandomState(seed)
    genome = _genome_codes(rs if genome_seed is None
                           else np.random.RandomState(genome_seed), genome_len)
    windows = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    for first in range(0, n_reads, _CHUNK):
        n = min(_CHUNK, n_reads - first)
        codes = windows[rs.randint(0, genome_len - read_len + 1, size=n)]
        rev = rs.randint(0, 2, size=n).astype(bool)
        codes[rev] = 3 - codes[rev, ::-1]
        sub = rs.random_sample((n, read_len)) < sub_rate
        codes[sub] = (codes[sub] + rs.randint(1, 4, size=int(sub.sum()))) % 4
        reads = _ACGT[codes]
        reads[rs.random_sample((n, read_len)) < n_rate] = ord("N")
        yield reads


def _record_block(reads: np.ndarray, first_id: int) -> bytes:
    """FASTQ records "@r<9 digits>\\n<seq>\\n+\\n<qual>\\n" for a chunk."""
    n, L = reads.shape
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    digits = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    rec = np.empty((n, 12 + L + 3 + L + 1), dtype=np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", dtype=np.uint8)
    rec[:, 2:11] = digits
    rec[:, 11] = ord("\n")
    rec[:, 12:12 + L] = reads
    rec[:, 12 + L:15 + L] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, 15 + L:15 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_fastq(path: str, genome_len: int, n_reads: int, read_len: int,
                sub_rate: float, n_rate: float, seed: int) -> int:
    """Write the simulated reads to `path`; returns the number of bases."""
    done = 0
    with open(path, "wb") as f:
        for reads in iter_reads(genome_len, n_reads, read_len, sub_rate,
                                n_rate, seed):
            f.write(_record_block(reads, done))
            done += reads.shape[0]
    return done * read_len
