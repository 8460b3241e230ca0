"""Build and bind the port's CUDA kernels.

Each ``kernels/csrc/*.cu`` source compiles with its own nvcc, all at
once, for Hopper only, and the objects link into one shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
         -Xcompiler -fPIC -Xptxas -v -c -o build/kernels/<name>.o <name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/kernels/libkmers_tpu_torch_kernels.so build/kernels/*.o

The library lands in ``build/kernels/`` at the root of the checkout on
first use and is rebuilt when the sha256 of the sources changes.  It is
loaded with ctypes: every pointer and the stream are ``c_void_p`` (a
pointer passed as a plain int would be cut to 32 bits), and every entry
point returns ``cudaGetLastError()`` after its launch, which ``check``
turns into an exception.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.abspath(os.path.join(CSRC, "..", "..", "..", "build",
                                         "kernels"))
LIB_NAME = "libkmers_tpu_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
# name -> (argtypes, restype)
_SIGNATURES = {
    "kt_pack_keys_packed": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "kt_pack_keys_ascii": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "kt_pack_hash_ascii": ([_P] * 6 + [_I, _I, _I, _ULL, _P], _I),
    "kt_pack_keys_wide": ([_P] * 5 + [_I, _I, _I, _P], _I),
    "kt_pack_hash_wide": ([_P] * 8 + [_I, _I, _I, _ULL, _P], _I),
    "kt_minimizer": ([_P] * 5 + [_I] * 4 + [_ULL, _I, _I, _P], _I),
    "kt_merge_sorted": ([_P, _P, _P, _LL, _P, _P, _LL, _P, _P, _P, _P, _P],
                        _I),
    "kt_merge_sorted_idx": ([_P, _P, _P, _LL, _P, _P, _LL] + [_P] * 6, _I),
    "kt_merge_sorted_wide": ([_P] * 5 + [_LL] + [_P] * 4 + [_LL]
                             + [_P] * 7, _I),
    "kt_compress_flagged": ([_P] * 4 + [_LL] + [_P] * 5, _I),
    "kt_compress_scratch_lanes": ([_LL], _LL),
    "kt_merge_tile": ([], _I),
    "kt_merge_tile_wide": ([], _I),
    "kt_segment_count": ([_P] * 4 + [_LL, _LL, _LL, _I] + [_P] * 7, _I),
    "kt_radix_tile": ([], _I),
    "kt_radix_scratch_bytes": ([_LL], _LL),
    "kt_radix_sort": ([_P, _P, _LL] + [_P] * 6, _I),
    "kt_search_counts": ([_P, _P, _P, _LL, _P, _P, _P, _LL, _P], _I),
    "kt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> dict:
    """Compile the library unless an up-to-date one exists.  Returns
    {"path", "built", "seconds", "log"}; the log holds nvcc's and ptxas's
    output (registers, shared memory and spills of each kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    log_path = os.path.join(BUILD_DIR, "nvcc.log")
    want = source_hash()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == want:
                log = open(log_path).read() if os.path.exists(log_path) else ""
                return {"path": lib_path, "built": False, "seconds": 0.0,
                        "log": log}
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.time()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in (p for p in sources() if p.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3]
                           + f".{os.getpid()}.o")
        jobs.append((obj, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = []
    for obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(obj)
    if not failed:
        link = subprocess.run(
            [nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
            + [obj for obj, _ in jobs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(tmp)
    for obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.time() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(want)
    with open(log_path, "w") as f:
        f.write(log)
    return {"path": lib_path, "built": True, "seconds": seconds, "log": log}


def lib() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build()["path"])
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code:
        msg = lib().kt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
