"""The port runs where JAX and the JAX package are absent: from a tree
that holds only ``kmers_tpu_torch/`` and ``native/``, with
``sys.modules["jax"] = None`` (any import of jax then fails), every module
imports (compat, the generic layer, SeqVector, profiling and utils among
them), a SeqVector round-trips its simple_sds bytes, and a tiny count
runs on the CPU at k = 15 (on one device, and
sharded over two CPU shards by hash and by minimizer), k = 32, k = 63 and
k = 64 (k = 32 and 63 sharded over two CPU shards too); the sharded
lookup service answers over two CPU shards at both
of its arms; the multi-process mesh's functions import,
kmers_tpu_torch.dryrun runs every sharded pipeline over two CPU shards,
and a two-axis (2, 2) mesh counts over each of its axes.
The sources neither import nor name a path into ``kmers_tpu/``."""

import ast
import os
import re
import shutil
import subprocess
import sys

import kmers_tpu_torch

PKG = os.path.dirname(os.path.abspath(kmers_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

SCRIPT = r"""
import importlib, importlib.util, os, pkgutil, sys
sys.modules["jax"] = None
import kmers_tpu_torch
assert kmers_tpu_torch.__file__.startswith(sys.argv[2]), kmers_tpu_torch.__file__
assert importlib.util.find_spec("kmers_tpu") is None
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
import torch
from kmers_tpu_torch.core import u64
from kmers_tpu_torch.io import fastx
from kmers_tpu_torch.parallel import count, mesh, pipeline
rows = torch.from_numpy(next(iter(fastx.read_kmer_batches(
    fq, k=15, batch=16, length=128))))
m2 = mesh.make_mesh(devices=["cpu"] * 2)
shards = pipeline.make_sharded_counter(m2, 15, route_capacity=2048)(rows)
whole = pipeline.count_reads(rows, 15).table
q = torch.cat([u64.join_planes(whole.keys_hi[:64], whole.keys_lo[:64]),
               torch.arange(64)])
v = torch.arange(128) % 5 != 0
want = torch.where(v, count.lookup(whole, q), -1)
for merge in (False, True):
    got, ov = pipeline.make_sharded_lookup(
        m2, query_capacity=128, max_k=15, merge_lookup=merge)(
            shards.table, q, v)
    assert int(ov) == 0 and torch.equal(got, want), merge
wide = os.path.join(sys.argv[1], "w.npz")
assert main(["count", fq, "-k", "63", "-o", wide, "--batch", "16",
             "--length", "128", "--device", "cpu"]) == 0
assert main(["stats", wide, "--device", "cpu"]) == 0
for k in (32, 64):
    full = os.path.join(sys.argv[1], f"k{k}.npz")
    assert main(["count", fq, "-k", str(k), "-o", full, "--batch", "16",
                 "--length", "128", "--device", "cpu"]) == 0
    assert main(["stats", full, "--device", "cpu"]) == 0
for k, flat in ((63, wide), (32, os.path.join(sys.argv[1], "k32.npz"))):
    sh = os.path.join(sys.argv[1], f"sharded_k{k}.npz")
    assert main(["count", fq, "-k", str(k), "-o", sh, "--batch", "16",
                 "--length", "128", "--device", "cpu", "--devices", "2"]) == 0
    assert npz_digest(sh) == npz_digest(flat), k
from kmers_tpu_torch import dryrun
from kmers_tpu_torch.parallel.mesh import (
    Mesh, ShardedRows, as_mesh, gather, init_distributed, local_read_slice,
    make_global_array, process_count, process_index, psum)
assert (process_count(), process_index(), local_read_slice(5)) == (
    1, 0, slice(0, 5))
assert len(dryrun.run(m2)["checks"]) == 12
m22 = mesh.make_mesh(devices=["cpu"] * 4, seq_shards=2)
assert m22.shape == {"d": 2, "s": 2} and mesh.process_local_batch(5, m22) == 3
for axis in ("d", "s"):
    res = pipeline.make_sharded_counter(m22, 15, route_capacity=2048,
                                        axis=axis)(rows)
    assert pipeline.global_table(res, m22, axis).n_unique == whole.n_unique
from kmers_tpu_torch import compat, profiling, utils
from kmers_tpu_torch.ops import generic, seqvector
sv = seqvector.SeqVector.from_str("ACGT" * 20 + "TTG", device="cpu")
sv.push_chars(b"GATTACA")
blob = sv.to_simple_sds()
back = seqvector.SeqVector.from_simple_sds(blob, device="cpu")
assert back.to_simple_sds() == blob and back.to_string() == sv.to_string()
spec = generic.GenericSpec(64, 31, "ACGT")
lanes, _ = generic.encode_windows(spec, rows[:2])
assert len(lanes) == 2 and utils.kmer_space(3) == 64
assert compat.Kmer.from_str("ACGT").data == 0b11100100
assert profiling.MetricsAccumulator().summary() == {"steps": 0}
assert "kmers_tpu" not in sys.modules and "jax.numpy" not in sys.modules
print("NOJAX-OK")
"""


def test_port_imports_and_counts_without_jax(tmp_path):
    tree = tmp_path / "tree"
    skip = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in ("kmers_tpu_torch", "native"):
        shutil.copytree(os.path.join(ROOT, name), tree / name, ignore=skip)
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                           str(tree)], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout
    assert "total kmers:    3440" in proc.stdout      # 40 reads x 86 windows
    assert "total kmers:    2760" in proc.stdout      # 40 reads x 69 windows
    assert "total kmers:    1520" in proc.stdout      # 40 reads x 38 windows
    assert "total kmers:    1480" in proc.stdout      # 40 reads x 37 windows


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


def _code_strings(tree: ast.AST):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node


def test_port_sources_name_no_path_into_kmers_tpu():
    """No string in the port's code (docstrings aside, which cite the
    reference) names the JAX package: nothing can load a file of it."""
    pattern = re.compile(r"kmers_tpu(?!_torch)")
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                offenders += [f"{path}:{node.lineno}"
                              for node in _code_strings(tree)
                              if pattern.search(node.value)]
    assert offenders == []


def test_fastx_batches_match_kmers_tpu(tmp_path):
    """The port's own ingest gives the JAX package's batches, native and
    Python parsers alike, packed and ASCII, for a record longer than a
    row (halo chunking)."""
    from kmers_tpu.io import fastx as jfastx
    from kmers_tpu_torch.io import fastx, simulate

    fq = str(tmp_path / "r.fastq")
    simulate.write_fastq(fq, 5000, 30, 100, 0.01, 0.01, 2)
    fa = str(tmp_path / "long.fa")
    with open(fa, "w") as f:
        f.write(">a\n" + "ACGTNACGGT" * 70 + "\n>b\nACGT\n")
    for path in (fq, fa):
        for force in (False, True):
            kw = dict(k=21, batch=8, length=128, force_python=force)
            for a, b in zip(fastx.read_kmer_batches(path, **kw),
                            jfastx.read_kmer_batches(path, **kw)):
                assert (a == b).all()
            got = list(fastx.read_packed_batches(path, **kw))
            want = list(jfastx.read_packed_batches(path, **kw))
            assert len(got) == len(want) > 0
            for (w, v), (jw, jv) in zip(got, want):
                assert (w == jw).all() and (v == jv).all()
    assert list(fastx.prefetch(iter(range(5)), depth=2)) == list(range(5))
