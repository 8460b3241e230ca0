"""FASTA/FASTQ ingest, shared with the JAX package.

``kmers_tpu/io/fastx.py`` imports only numpy and ctypes and drives
``native/libfastx.so``, so the port uses that very file, loaded by path:
batching stays byte-for-byte the same as the reference's.  It is not
imported as ``kmers_tpu.io.fastx`` because ``kmers_tpu/__init__.py``
imports JAX.
"""

from __future__ import annotations

import importlib.util
import os

_SRC = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "kmers_tpu", "io", "fastx.py"))


def _load():
    spec = importlib.util.spec_from_file_location(
        "kmers_tpu_torch.io._fastx_shared", _SRC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_fastx = _load()

read_packed_batches = _fastx.read_packed_batches
read_kmer_batches = _fastx.read_kmer_batches
prefetch = _fastx.prefetch
pack_batch_np = _fastx.pack_batch_np
