"""The CLI at k = 32 and k = 64 (keys that fill every bit, counted
through the run-length tables) against kmers_tpu's on the CPU: count
(packed and ASCII ingest; an evicting run exits 3), stats, and query of
the top k-mer, the bit-63 palindrome A^16 T^16 and a bad query (exit 2);
SMOKE_DIGEST_32 / _64 pinned to kmers_tpu's output.  Exact equality."""

import contextlib
import io

import numpy as np
import pytest

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu_torch import smoke
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.io import simulate
from kmers_tpu_torch.parallel.stream import npz_digest

from test_torch_fullword import PALINDROME_32


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    return smoke.write_smoke_input(
        str(tmp_path_factory.mktemp("fullword") / "smoke.fastq"))


@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    """400 reads of a 5 kbp genome: two 256-read batches, about 7,000
    distinct k-mers, so capacity 4096 evicts."""
    path = str(tmp_path_factory.mktemp("fullword") / "small.fastq")
    simulate.write_fastq(path, 5000, 400, 150, 1e-3, 1e-4, 9)
    return path


@pytest.mark.parametrize("k", [32, 64])
def test_smoke_digests_are_kmers_tpu_output(fastq, tmp_path, k):
    """SMOKE_DIGEST_32 / _64 (which chip_smoke.py checks on the card) are
    what both packages write on the CPU."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert run(jax_main, smoke.smoke_count_args(fastq, j_out, k))[0] == 0
    assert run(port_main, smoke.smoke_count_args(fastq, t_out, k)
               + ["--device", "cpu"])[0] == 0
    assert npz_digest(j_out) == npz_digest(t_out) == smoke.SMOKE_DIGESTS[k]


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("extra,want_rc", [
    (["--ascii-ingest"], 0),
    (["--capacity", "4096", "--merge-every", "2"], 3),    # evicts
])
def test_cli_full_width_matches_kmers_tpu(small_fastq, tmp_path, k, extra,
                                          want_rc):
    """count (ASCII ingest; an evicting run exits 3), stats, and query of
    the top k-mer, A^k, the palindrome and a bad query (exit 2)."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = lambda out: smoke.smoke_count_args(small_fastq, out, k) + extra
    j_rc, _, j_err = run(jax_main, args(j_out))
    t_rc, _, t_err = run(port_main, args(t_out) + ["--device", "cpu"])
    assert j_rc == t_rc == want_rc
    assert npz_digest(j_out) == npz_digest(t_out)
    warn = lambda err: [ln for ln in err.splitlines() if "WARNING" in ln]
    assert warn(j_err) == warn(t_err)
    assert run(jax_main, ["stats", j_out])[:2] == run(
        port_main, ["stats", t_out, "--device", "cpu"])[:2]
    with np.load(t_out) as z:
        i = int(np.argmax(z["counts"][:int(z["n_unique"])]))
        names = ["keys_hi_hi", "keys_hi_lo", "keys_lo_hi", "keys_lo_lo"] if (
            k == 64) else ["keys_hi", "keys_lo"]
        word = 0
        for name in names:
            word = (word << 32) | int(z[name][i])
    top = "".join("ACGT"[(word >> (2 * j)) & 3] for j in range(k))
    queries = [top, "A" * k, (PALINDROME_32 * 2)[:k], "acgt" * (k // 4),
               "ACGN" + "A" * (k - 4)]
    j_q = run(jax_main, ["query", j_out] + queries)
    t_q = run(port_main, ["query", t_out] + queries + ["--device", "cpu"])
    assert j_q[:2] == t_q[:2] and j_q[0] == 2
    assert int(t_q[1].splitlines()[0].split("\t")[1]) > 0
