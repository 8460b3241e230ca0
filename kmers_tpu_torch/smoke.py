"""The small fixed count that ties the port to the JAX package.

``SMOKE_DIGEST`` (k = 31), ``SMOKE_DIGEST_WIDE`` (k = 63, 128-bit keys),
``SMOKE_DIGEST_32`` and ``SMOKE_DIGEST_64`` (the run-length path: keys
that fill every bit) are the ``npz_digest``s of the tables that
``python -m kmers_tpu count`` writes for the seeded input below.  The tier-1 tests assert that
the JAX package on the CPU and the port on the CPU both produce them;
``chip_smoke.py`` asserts that the port produces them on the card, where
JAX is not installed.

``PARITY_DIGEST`` ties the parity surface outside counting the same way:
the sha256 (``digest_arrays``) of what SeqVector and the generic layer
give on a small fixed input (``parity_arrays``): the sequence's k-mers at
k = 31 and 32, its (k = 31, w = 11) minimizers under the mix and the lex
hash, its simple_sds bytes, and the generic lanes, decoded bytes and
reverse complements of every window of the reads at three specs.
"""

from __future__ import annotations

import hashlib

import numpy as np

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


# the parity input: a seeded genome as one sequence, and reads from it
PARITY_INPUT = dict(genome_len=3_000, n_reads=64, read_len=150,
                    sub_rate=1e-3, n_rate=1e-2, seed=20261017)
# the generic layer's specs: (width bits, k, encoding)
PARITY_SPECS = ((64, 31, "ACGT"), (128, 63, "GTCA"), (32, 15, "xor10"))
PARITY_MINIMIZER = (31, 11)

PARITY_DIGEST = \
    "5f1623f8c16666ace5558d516515b735f8f653b787f9c6e9c13f84ec39d0e386"


def parity_input() -> tuple:
    """(the sequence as bytes, [n_reads, read_len] uint8 reads)."""
    p = PARITY_INPUT
    seq = simulate.genome(p["genome_len"], p["seed"]).tobytes()
    reads = next(simulate.iter_reads(**p))
    return seq, reads


def digest_arrays(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}\0{a.shape}\0".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def parity_arrays(device) -> list:
    """The port's outputs on the parity input, as numpy arrays in
    ``PARITY_DIGEST``'s order (k-mer words uint64, positions int32, lanes
    uint32, bytes uint8)."""
    import torch

    from .ops import generic, hash as khash
    from .ops.seqvector import SeqVector

    seq, reads = parity_input()
    sv = SeqVector.from_bytes(seq, device=device)
    host = lambda t: t.cpu().numpy()
    out = [host(sv.all_kmers(k)[0]).view(np.uint64) for k in (31, 32)]
    k, w = PARITY_MINIMIZER
    for fn in (khash.mix_hash_fn(0), khash.lex_hash_fn(w)):
        word, pos = sv.minimizers(k, w, fn)
        out += [host(word).view(np.uint64), host(pos)]
    out.append(np.frombuffer(sv.to_simple_sds(), dtype=np.uint8))
    r = torch.from_numpy(reads).to(device)
    for width, k, encoding in PARITY_SPECS:
        spec = generic.GenericSpec(width, k, encoding)
        lanes, _ = generic.encode_windows(spec, r)
        out += [host(x).astype(np.uint32) for x in lanes]
        out.append(host(generic.decode(spec, lanes)))
        out += [host(x).astype(np.uint32)
                for x in generic.rev_comp(spec, lanes)]
    return out
