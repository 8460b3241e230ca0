"""FASTA/FASTQ ingest: the native batch parser ``native/libfastx.so`` with
a pure-Python fallback (counterpart of ``kmers_tpu/io/fastx.py``).

The port keeps its own copy: the record and batch readers, the 2-bit
packs, the prefetch thread and the loader of the native parser (built by
``make -C native`` when the library is missing).  The batch layout is the
reference's byte for byte:

  * ``read_records``: one record a row, [B, L] uint8 padded with 'N',
    with each record's true length (a longer record keeps its first L
    bases).
  * ``read_kmer_batches``: [B, L] uint8 rows padded with 'N'; a record
    longer than L is cut into rows with a (k-1)-base overlap, so every
    k-mer window of the record appears in exactly one row; the last batch
    is padded with all-'N' rows.
  * ``read_packed_batches``: the same rows as 2-bit code words [B, L/16]
    plus validity bitmaps [B, L/32] (uint32, LSB first).

Gzip input is decoded on both paths (zlib in the native parser, the
gzip module here).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import profiling

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SO_PATH = os.path.join(_NATIVE_DIR, "libfastx.so")

PAD = ord("N")

_lib = None


def _load_native() -> Optional[ctypes.CDLL]:
    """The native parser, bound once; None where it neither loads nor
    builds (the Python parser then runs)."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_next_batch.restype = ctypes.c_longlong
    lib.fastx_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_next_batch_chunked.restype = ctypes.c_longlong
    lib.fastx_next_batch_chunked.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_next_batch_chunked_packed.restype = ctypes.c_longlong
    lib.fastx_next_batch_chunked_packed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_close.restype = None
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.pack2bit.restype = None
    lib.pack2bit.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native parser loads (or builds)."""
    return _load_native() is not None


def _open_maybe_gz(path: str):
    """Binary handle; gzip files (1f 8b magic) are inflated."""
    import gzip

    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _py_records(path: str) -> Iterator[bytes]:
    """The Python parser: one sequence per record, as the native one."""
    with _open_maybe_gz(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == b">":
            seq = []
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if seq:
                        yield b"".join(seq)
                    seq = []
                else:
                    seq.append(line)
            if seq:
                yield b"".join(seq)
        elif first == b"@":
            while True:
                header = f.readline()
                if not header:
                    return
                parts = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    parts.append(line.rstrip(b"\r\n"))
                    line = f.readline()
                seq = b"".join(parts)
                qlen = 0
                while qlen < len(seq):
                    q = f.readline()
                    if not q:
                        break
                    qlen += len(q.rstrip(b"\r\n"))
                yield seq
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")


def _open_native(lib, path: str):
    handle = lib.fastx_open(path.encode())
    if not handle:
        raise ValueError(f"{path}: cannot open as FASTA/FASTQ")
    return handle


def _native_batches(lib, path: str, batch: int, length: int,
                    overlap: Optional[int] = None):
    """(rows [batch, length] uint8 padded with 'N', lengths, n) from the
    native parser: one record a row (the first `length` bases), or with
    `overlap`, records cut into rows that share `overlap` bases."""
    handle = _open_native(lib, path)
    try:
        while True:
            buf = np.full((batch, length), PAD, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int64)
            pbuf = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            plen = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
            if overlap is None:
                n = lib.fastx_next_batch(handle, pbuf, batch, length, plen)
            else:
                n = lib.fastx_next_batch_chunked(handle, pbuf, batch, length,
                                                 overlap, plen)
            if n < 0:
                raise ValueError(f"{path}: malformed FASTA/FASTQ")
            if n == 0:
                return
            yield buf, lens, int(n)
    finally:
        lib.fastx_close(handle)


def read_records(path: str, batch: int, length: int,
                 force_python: bool = False
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(rows [n, length] uint8 padded with 'N', lengths [n] int64) batches
    of at most `batch` records, one record a row.  lengths are the true
    record lengths: a longer record's row holds its first `length` bases
    only (read_kmer_batches keeps every k-mer)."""
    lib = None if force_python else _load_native()
    if lib is not None:
        for buf, lens, n in _native_batches(lib, path, batch, length):
            yield buf[:n], lens[:n]
        return
    buf = np.full((batch, length), PAD, dtype=np.uint8)
    lens = np.zeros(batch, dtype=np.int64)
    n = 0
    for rec in _py_records(path):
        arr = np.frombuffer(rec, dtype=np.uint8)
        ncopy = min(len(arr), length)
        buf[n, :ncopy] = arr[:ncopy]
        lens[n] = len(arr)
        n += 1
        if n == batch:
            yield buf, lens
            buf = np.full((batch, length), PAD, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int64)
            n = 0
    if n:
        yield buf[:n], lens[:n]


def read_kmer_batches(path: str, k: int, batch: int, length: int,
                      force_python: bool = False) -> Iterator[np.ndarray]:
    """Fixed-shape [batch, length] uint8 batches in which every k-mer of
    every record appears in exactly one row (records longer than `length`
    are cut with a (k-1)-base overlap); rows past the input are all 'N'."""
    if not length >= k >= 1:
        raise ValueError(f"need length >= k >= 1, got length={length}, k={k}")
    lib = None if force_python else _load_native()
    if lib is not None:
        for buf, _, _ in _native_batches(lib, path, batch, length, k - 1):
            yield buf                  # rows past the records are all 'N'
        return
    stride = length - (k - 1)
    out = np.full((batch, length), PAD, dtype=np.uint8)
    n = 0
    for rec in _py_records(path):
        arr = np.frombuffer(rec, dtype=np.uint8)
        pos = 0
        while True:
            piece = arr[pos:pos + length]
            out[n, :len(piece)] = piece
            n += 1
            if n == batch:
                yield out
                out = np.full((batch, length), PAD, dtype=np.uint8)
                n = 0
            if pos + length >= len(arr):
                break
            pos += stride
    if n:
        yield out


def pack_batch_np(rows: np.ndarray):
    """Numpy 2-bit pack of an ASCII [B, L] batch (L % 32 == 0): (words
    [B, L/16] uint32, validbits [B, L/32] uint32), the native packed
    reader's layout (A=0 C=1 G=2 T=3 any case, code 0 for other bytes)."""
    B, L = rows.shape
    if L % 32:
        raise ValueError(f"packed rows need L % 32 == 0, got L={L}")
    a = rows.astype(np.uint32)
    lower = a | 0x20
    ok = ((lower == ord("a")) | (lower == ord("c")) |
          (lower == ord("g")) | (lower == ord("t")))
    internal = (a >> 1) & 3
    codes = np.where(ok, internal ^ (internal >> 1), 0).astype(np.uint32)
    sh16 = np.arange(16, dtype=np.uint32) * 2
    words = np.bitwise_or.reduce(
        codes.reshape(B, L // 16, 16) << sh16, axis=2).astype(np.uint32)
    sh32 = np.arange(32, dtype=np.uint32)
    validbits = np.bitwise_or.reduce(
        ok.astype(np.uint32).reshape(B, L // 32, 32) << sh32,
        axis=2).astype(np.uint32)
    return words, validbits


def read_packed_batches(path: str, k: int, batch: int, length: int,
                        force_python: bool = False
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """read_kmer_batches' rows as (words [batch, length/16] uint32,
    validbits [batch, length/32] uint32): 0.375 B a base to upload
    instead of 1.  length must be a multiple of 32."""
    if length % 32:
        raise ValueError(f"packed ingest needs length % 32 == 0, got {length}")
    if not length >= k >= 1:
        raise ValueError(f"need length >= k >= 1, got length={length}, k={k}")
    lib = None if force_python else _load_native()
    if lib is None:
        for rows in read_kmer_batches(path, k, batch, length,
                                      force_python=True):
            yield pack_batch_np(rows)
        return
    handle = _open_native(lib, path)
    try:
        wpr, vpr = length // 16, length // 32
        while True:
            words = np.zeros((batch, wpr), dtype=np.uint32)
            valid = np.zeros((batch, vpr), dtype=np.uint32)
            lens = np.zeros(batch, dtype=np.int64)
            n = lib.fastx_next_batch_chunked_packed(
                handle, words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                batch, length, k - 1,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
            if n < 0:
                raise ValueError(f"{path}: malformed FASTA/FASTQ")
            if n == 0:
                return
            yield words, valid
    finally:
        lib.fastx_close(handle)


def prefetch(it: Iterator, depth: int = 512) -> Iterator:
    """Run `it` on a background thread, at most `depth` items ahead (0 =
    unbounded), so the host parses batch i+1 while batch i computes.  An
    exception of `it` re-raises here; closing this generator stops the
    thread (the queue is drained so a blocked put wakes)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end, err = object(), object()

    def worker():
        try:
            while True:
                with profiling.span("kmers.ingest.parse",
                                    wall_ns="kmers.ingest.parse_ns",
                                    cpu_ns="kmers.ingest.parse_cpu_ns"):
                    item = next(it, end)
                if item is end:
                    break
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            if not stop.is_set():
                q.put((err, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            ready = not q.empty()
            with profiling.span("kmers.ingest.wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            profiling.add("kmers.ingest.batches")
            profiling.add("kmers.ingest.ready", ready)
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def pack2bit_native(ascii_bytes: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Host 2-bit pack of one sequence: (uint32 code words, 16 bases a
    word, as SeqVector's; uint64 validity bitmap words, 1 bit a base, LSB
    first).  The native pack where the parser loads, else numpy."""
    n = len(ascii_bytes)
    arr = np.frombuffer(ascii_bytes, dtype=np.uint8)
    lib = _load_native()
    if lib is None:
        from ..ops.seqvector import pack_ascii_to_words

        lower = arr | 0x20
        ok = ((lower == ord("a")) | (lower == ord("c")) |
              (lower == ord("g")) | (lower == ord("t")))
        bitmap = np.zeros((n + 63) // 64, dtype=np.uint64)
        idx = np.nonzero(ok)[0]
        np.bitwise_or.at(bitmap, idx // 64,
                         np.uint64(1) << (idx % 64).astype(np.uint64))
        return pack_ascii_to_words(arr), bitmap
    words = np.zeros((n + 15) // 16, dtype=np.uint32)
    bitmap = np.zeros((n + 63) // 64, dtype=np.uint64)
    lib.pack2bit(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n,
                 words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                 bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return words, bitmap
