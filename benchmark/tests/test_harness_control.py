"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, which must come out not correct.

The configurations promise exact counts of canonical k-mers.  The
control counts forward words (no reverse complement, no minimum): the
step that would tempt a later change, since the program has it as K1's
``stage="pack"`` ablation arm.  In the count cells every job's saved
table is the control's; in the lookup cell every call is answered from
the control's table.  On the card at each cell's own size (``-m cuda``,
three seeds; the readings go to PERF.md), and here at the small size."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import kmer_count as ref
from benchmark.tests import tiny
from kmers_tpu_torch import __main__ as cli
from kmers_tpu_torch.parallel import pipeline

COUNT_CELLS = ["ecoli-k31.count", "ecoli-k63.count"]
SEEDS = [2 ** 31 + 101, 2 ** 33 + 7, 977]


def _planes(words: np.ndarray) -> tuple:
    return ((words >> np.uint64(32)).astype("<u4"),
            (words & np.uint64(0xFFFFFFFF)).astype("<u4"))


def control_count(argv, device) -> int:
    """`count <fastq> -k K -o OUT ...` done by the reference, forward
    words, written in the program's npz layout."""
    path, k, out = argv[1], int(argv[argv.index("-k") + 1]), \
        argv[argv.index("-o") + 1]
    hi, lo, counts = (t.cpu().numpy() for t in ref.count_reads(
        ref.read_fastq(path), k, device, canonical=False))
    hi, lo = hi.view(np.uint64), lo.view(np.uint64)
    if k <= 32:
        keys = dict(zip(("keys_hi", "keys_lo"), _planes(lo)))
    else:
        keys = dict(zip(("keys_hi_hi", "keys_hi_lo", "keys_lo_hi",
                         "keys_lo_lo"), _planes(hi) + _planes(lo)))
    np.savez(out, k=np.int64(k), capacity=np.int64(len(counts)),
             batches=np.int64(0), kmers=np.int64(counts.sum()),
             dropped_unique=np.int64(0), dropped_kmers=np.int64(0),
             counts=counts.astype("<i4"), n_unique=np.int64(len(counts)),
             **keys)
    return 0


def control_lookup(monkeypatch, workdir, device):
    def factory(*args, **kwargs):
        table = ref.count_reads(ref.read_fastq(f"{workdir}/reads.fastq"), 31,
                                device, canonical=False)

        def call(tables, queries, valid):
            got = ref.lookup(table, torch.zeros_like(queries), queries, valid)
            return got.to(torch.int32), torch.zeros((), dtype=torch.int64)
        return call
    monkeypatch.setattr(pipeline, "make_sharded_lookup", factory)


def run_control(cell, tmp_path, monkeypatch, device, seed, small):
    if cell.endswith(".count"):
        monkeypatch.setattr(cli, "main",
                            lambda argv: control_count(argv, device))
    else:
        control_lookup(monkeypatch, tmp_path, device)
    result = tiny.run(cell, tmp_path, monkeypatch, seed=seed, device=device,
                      small=small, seconds=0.5 if small else 3.0)
    print(json.dumps({"cell": cell, "seed": seed, "correct":
                      result["correct"], "checks": result["checks"]}))
    return result


@pytest.mark.parametrize("cell", COUNT_CELLS + ["ecoli-k31.lookup"])
def test_control_fails_small(cell, tmp_path, monkeypatch):
    result = run_control(cell, tmp_path, monkeypatch, "cpu", SEEDS[0], True)
    assert not result["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", COUNT_CELLS + ["ecoli-k31.lookup"])
def test_control_fails_at_cell_size(cell, seed, tmp_path, monkeypatch):
    chips = spec.workload(spec.load_benchmark(), cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA card(s) (run on the GPU machine: "
                    "python -m pytest -m cuda benchmark/tests)")
    result = run_control(cell, tmp_path, monkeypatch, "cuda", seed, False)
    assert not result["correct"]
