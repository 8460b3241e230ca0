"""Without a card the harness exits non-zero and prints no result; it
never falls back to the CPU.  In a directory that holds only the
benchmark (no program) it fails as well."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import runner, spec

RUN = os.path.join(spec.BENCH_DIR, "run.py")
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def run_py(cwd, cell="ecoli-k31.count", env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"),
         "--workload", cell, "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(spec.ROOT, cell, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.parametrize("have", [0, 1, 3])
def test_too_few_cards_no_result(monkeypatch, capsys, have):
    """main() refuses a cell whose chips the machine lacks, before it
    touches the program."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: have > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
    called = []
    monkeypatch.setattr(runner, "run_cell", lambda *a, **k: called.append(1))
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        if w["chips"] > have:
            rc = runner.main(["--workload", w["name"], "--seed", "1",
                              "--seconds", "1", "--trace", "0"], t0=0.0)
            assert rc != 0
    assert not called
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """A checkout of BENCHMARK.json and benchmark/ only: no program."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "kmers_tpu_torch_like",
                        types.ModuleType("x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert runner.forbidden_modules() == ["jax"]
