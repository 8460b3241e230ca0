"""Build and bind the port's CUDA kernels.

All ``kernels/csrc/*.cu`` sources compile with nvcc, for Hopper only, into
one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/kernels/libkmers_tpu_torch_kernels.so ...

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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> (argtypes, restype)
_SIGNATURES = {
    "kt_pack_keys_packed": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "kt_pack_keys_ascii": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "kt_merge_sorted": ([_P, _P, _P, _LL, _P, _P, _LL, _P, _P, _P, _P, _P],
                        _I),
    "kt_compress_block_counts": ([_P, _LL, _P, _P], _I),
    "kt_compress_flagged": ([_P, _P, _P, _P, _P, _LL, _P, _P, _P, _P], _I),
    "kt_merge_tile": ([], _I),
    "kt_compress_block": ([], _I),
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
    cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", tmp]
           + [p for p in sources() if p.endswith(".cu")])
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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
