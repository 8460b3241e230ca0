"""No module that the harness or the reference loads has the top-level
name jax, jaxlib, flax or kmers_tpu (whole names: kmers_tpu_torch, the
program under test, is not kmers_tpu), and the reference loads nothing
of the program."""

import json
import subprocess
import sys

from benchmark.harness import runner, spec

LOADED = r"""
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", LOADED.format(root=spec.ROOT, body=body)],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    names = top_level_modules(
        "import benchmark.reference.kmer_count as r\n"
        "r.count_reads(r.np.zeros((2, 40), r.np.uint8) + 65, 31, 'cpu')")
    assert not names & set(runner.FORBIDDEN)
    assert "kmers_tpu_torch" not in names


def test_harness_modules_load_no_program_at_import():
    names = top_level_modules(
        "from benchmark.harness import mixes, peaks, runner, simulate, "
        "spec, stats, tracing, work\n"
        "b = spec.load_benchmark()\n"
        "[spec.load_metric(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "[spec.load_driver(spec.load_traffic(w['traffic'])['driver']) "
        "for w in b['workloads']]")
    assert not names & set(runner.FORBIDDEN)
    assert "kmers_tpu_torch" not in names


def test_a_whole_run_loads_no_jax():
    """A small traced run of every cell on the CPU, then sys.modules."""
    body = (
        "import tempfile\n"
        "import pytest\n"
        "from benchmark.tests import tiny\n"
        "mp = pytest.MonkeyPatch()\n"
        "for cell in ('ecoli-k31.count', 'ecoli-k63.count', "
        "'ecoli-k31.lookup'):\n"
        "    r = tiny.run(cell, tempfile.mkdtemp(), mp, trace=True, "
        "seconds=0.2)\n"
        "    assert r['correct'], r\n")
    names = top_level_modules(body)
    assert "kmers_tpu_torch" in names
    assert not names & set(runner.FORBIDDEN)
