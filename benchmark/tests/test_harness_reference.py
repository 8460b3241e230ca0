"""The plain reference against a brute-force Python count and lookup at
tiny sizes: N bases, lower case, both strands, palindromes, and every
key width (one word to k = 32, two past it)."""

import collections

import numpy as np
import pytest
import torch

from benchmark.harness import simulate
from benchmark.reference import kmer_count as ref

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
MASK = (1 << 64) - 1


def brute_canonical(s: str) -> int:
    k = len(s)
    fw = sum(CODE[ch] << (2 * i) for i, ch in enumerate(s.upper()))
    rc = sum((3 - CODE[ch]) << (2 * (k - 1 - i))
             for i, ch in enumerate(s.upper()))
    return min(fw, rc)


def brute_count(reads, k: int) -> dict:
    counts = collections.Counter()
    for read in reads:
        for j in range(len(read) - k + 1):
            window = read[j:j + k]
            if all(ch in "ACGTacgt" for ch in window):
                counts[brute_canonical(window)] += 1
    return counts


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))


def tiny_reads(seed: int, n: int = 40, length: int = 80):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), length)) for _ in range(n)]
    reads = [r if i % 3 else revcomp(reads[i - 1]) if i else r
             for i, r in enumerate(reads)]
    out = []
    for i, r in enumerate(reads):
        r = list(r)
        if i % 4 == 1:                      # N bases and other bytes
            for j in rng.choice(length, 3, replace=False):
                r[j] = "NNX"[j % 3]
        if i % 5 == 2:                      # lower case
            r = [ch.lower() for ch in r]
        out.append("".join(r))
    out.append(("ACGT" * length)[:length])  # palindromes at even k
    return out


def as_array(reads) -> np.ndarray:
    return np.array([np.frombuffer(r.encode(), np.uint8) for r in reads])


def table_dict(table) -> dict:
    """{unsigned word: count}; the word is hi << 64 | lo."""
    hi, lo, counts = (t.tolist() for t in table)
    return {((h & MASK) << 64) | (l & MASK): c
            for h, l, c in zip(hi, lo, counts)}


@pytest.mark.parametrize("k", [1, 4, 5, 16, 31, 32, 33, 40, 63, 64])
def test_count_matches_brute_force(k):
    reads = tiny_reads(k)
    want = brute_count(reads, k)
    got = table_dict(ref.count_reads(as_array(reads), k, "cpu"))
    assert got == dict(want)


@pytest.mark.parametrize("k", [15, 31, 63])
def test_keys_ascend_unsigned(k):
    hi, lo, counts = ref.count_reads(as_array(tiny_reads(k + 1)), k, "cpu")
    words = [((h & MASK) << 64) | (l & MASK)
             for h, l in zip(hi.tolist(), lo.tolist())]
    assert words == sorted(words) and len(set(words)) == len(words)
    assert int(counts.min()) >= 1


def test_forward_words_differ_from_canonical():
    reads = as_array(tiny_reads(3))
    canon = table_dict(ref.count_reads(reads, 21, "cpu"))
    forward = table_dict(ref.count_reads(reads, 21, "cpu", canonical=False))
    assert sum(canon.values()) == sum(forward.values())
    assert canon != forward


@pytest.mark.parametrize("k", [7, 31])
def test_lookup_matches_brute_force(k):
    reads = tiny_reads(k + 7)
    table = ref.count_reads(as_array(reads), k, "cpu")
    counts = brute_count(reads, k)
    rng = np.random.default_rng(k)
    present = list(counts)[:50]
    absent = [int(x) for x in rng.integers(0, 1 << (2 * k), 50)]
    words = present + absent + [0, 5]
    valid = [True] * 100 + [False, False]
    got = ref.lookup(table, torch.zeros(len(words), dtype=torch.int64),
                     torch.tensor(words, dtype=torch.int64),
                     torch.tensor(valid))
    want = [counts.get(w, 0) for w in words[:100]] + [-1, -1]
    assert got.tolist() == want


def test_lookup_of_window_keys_counts_every_window():
    reads = as_array(tiny_reads(9))
    table = ref.count_reads(reads, 31, "cpu")
    hi, lo, valid = ref.window_keys(reads, 31, "cpu")
    got = ref.lookup(table, hi, lo, valid)
    assert bool((got[valid] >= 1).all()) and bool((got[~valid] == -1).all())


def test_read_fastq_gives_the_simulated_reads(tmp_path):
    path = str(tmp_path / "r.fastq")
    simulate.write_fastq(path, 5_000, 300, 150, 1e-3, 1e-2, seed=2 ** 31 + 9)
    want = np.concatenate(list(simulate.iter_reads(5_000, 300, 150, 1e-3,
                                                   1e-2, seed=2 ** 31 + 9)))
    assert np.array_equal(ref.read_fastq(path), want)


def test_fresh_reads_share_the_genome():
    """genome_seed keeps the genome and draws other reads."""
    a = np.concatenate(list(simulate.iter_reads(3_000, 50, 100, 0, 0, 5)))
    b = np.concatenate(list(simulate.iter_reads(3_000, 50, 100, 0, 0, 6,
                                                genome_seed=5)))
    genome = simulate.genome(3_000, 5).tobytes()
    rc = lambda r: revcomp(r.tobytes().decode()).encode()
    assert not np.array_equal(a, b)
    assert all(r.tobytes() in genome or rc(r) in genome for r in b)
