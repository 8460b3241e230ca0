"""The port runs where JAX is absent: every module imports, and a tiny
count at k = 15 (on one device, and sharded over two CPU shards by hash
and by minimizer) and at k = 63 (the wide tier) runs on the CPU, with
``sys.modules["jax"] = None`` (any import of jax then fails)."""

import os
import re
import subprocess
import sys

import kmers_tpu_torch

PKG = os.path.dirname(os.path.abspath(kmers_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
import kmers_tpu_torch
for m in pkgutil.walk_packages(kmers_tpu_torch.__path__, "kmers_tpu_torch."):
    importlib.import_module(m.name)
from kmers_tpu_torch.__main__ import main
from kmers_tpu_torch.io import simulate
fq = os.path.join(sys.argv[1], "r.fastq")
simulate.write_fastq(fq, 2000, 40, 100, 0.0, 0.0, 1)
out = os.path.join(sys.argv[1], "t.npz")
assert main(["count", fq, "-k", "15", "-o", out, "--batch", "16",
             "--length", "128", "--device", "cpu"]) == 0
assert main(["stats", out, "--device", "cpu"]) == 0
from kmers_tpu_torch.parallel.stream import npz_digest
for part in ("hash", "minimizer"):
    sh = os.path.join(sys.argv[1], part + ".npz")
    assert main(["count", fq, "-k", "15", "-o", sh, "--batch", "16",
                 "--length", "128", "--device", "cpu", "--devices", "2",
                 "--partition", part, "--minimizer-w", "7"]) == 0
    assert npz_digest(sh) == npz_digest(out), part
wide = os.path.join(sys.argv[1], "w.npz")
assert main(["count", fq, "-k", "63", "-o", wide, "--batch", "16",
             "--length", "128", "--device", "cpu"]) == 0
assert main(["stats", wide, "--device", "cpu"]) == 0
assert "kmers_tpu" not in sys.modules and "jax.numpy" not in sys.modules
print("NOJAX-OK")
"""


def test_port_imports_and_counts_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout
    assert "total kmers:    3440" in proc.stdout      # 40 reads x 86 windows
    assert "total kmers:    1520" in proc.stdout      # 40 reads x 38 windows


def test_port_sources_import_neither_jax_nor_kmers_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|kmers_tpu)\b(?!_torch)",
                         re.M)
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    if pattern.search(f.read()):
                        offenders.append(path)
    assert offenders == []
