"""The port's CLI (kmers_tpu_torch.__main__, --device cpu) against
kmers_tpu's on the same seeded FASTQ: same exit codes, same table content
(by npz_digest: np.savez stamps zip members with the time, so bytes
differ), same `stats` and `query` output."""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu_torch import dryrun, smoke
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.parallel.stream import npz_digest


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    return smoke.write_smoke_input(
        str(tmp_path_factory.mktemp("cli") / "smoke.fastq"))


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def top_kmer(path):
    with np.load(path) as z:
        nu = int(z["n_unique"])
        i = int(np.argmax(z["counts"][:nu]))
        word = (int(z["keys_hi"][i]) << 32) | int(z["keys_lo"][i])
        k = int(z["k"])
    return "".join("ACGT"[(word >> (2 * j)) & 3] for j in range(k))


def test_smoke_digest_is_kmers_tpu_output(fastq, tmp_path):
    """SMOKE_DIGEST (which chip_smoke.py checks on the card) is what both
    packages produce on the CPU."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert run(jax_main, smoke.smoke_count_args(fastq, j_out))[0] == 0
    assert run(port_main, smoke.smoke_count_args(fastq, t_out)
               + ["--device", "cpu"])[0] == 0
    assert npz_digest(j_out) == smoke.SMOKE_DIGEST
    assert npz_digest(t_out) == smoke.SMOKE_DIGEST


@pytest.mark.parametrize("extra,want_rc", [
    ([], 0),                                           # packed ingest
    (["--ascii-ingest"], 0),
    (["--capacity", "4096", "--merge-every", "2"], 3),  # evicts
])
def test_cli_matches_kmers_tpu(fastq, tmp_path, extra, want_rc):
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_rc, _, j_err = run(jax_main, smoke.smoke_count_args(fastq, j_out)
                         + extra)
    t_rc, _, t_err = run(port_main, smoke.smoke_count_args(fastq, t_out)
                         + extra + ["--device", "cpu"])
    assert j_rc == t_rc == want_rc
    assert npz_digest(j_out) == npz_digest(t_out)
    warn = lambda err: [ln for ln in err.splitlines() if "WARNING" in ln]
    assert warn(j_err) == warn(t_err)
    assert bool(warn(t_err)) == (want_rc == 3)

    j_stats = run(jax_main, ["stats", j_out])
    t_stats = run(port_main, ["stats", t_out, "--device", "cpu"])
    assert j_stats[:2] == t_stats[:2]
    queries = [top_kmer(t_out), "A" * 31, "acgt" * 7 + "acg", "ACGT"]
    j_q = run(jax_main, ["query", j_out] + queries)
    t_q = run(port_main, ["query", t_out] + queries + ["--device", "cpu"])
    assert j_q[:2] == t_q[:2]
    assert j_q[0] == 2                  # "ACGT" has the wrong length


@pytest.mark.parametrize("argv", [
    ["--devices", "2", "-k", "33", "--route-capacity", "16384"],  # sharded
    ["--devices", "2", "--partition", "minimizer", "-k", "63"],
    ["-k", "32"], ["-k", "64"],                         # counted
    ["--devices", "2", "-k", "32", "--route-capacity", "16384"],
    ["--devices", "2", "-k", "63", "--route-capacity", "16384"],
    ["--devices", "2", "-k", "64", "--route-capacity", "16384"],
])
def test_cli_rejects_unported_options(fastq, tmp_path, argv):
    """The hash-sharded count at k = 32, 33, 63 and 64 gives kmers_tpu's
    exit code and table; the minimizer partition past k = 31 exits 2
    (kmers_tpu raises a ValueError there, ROADMAP section C); k = 32 and
    k = 64 on one device count to kmers_tpu's table (SMOKE_DIGEST_32 /
    _64)."""
    out, j_out = str(tmp_path / "x.npz"), str(tmp_path / "j.npz")
    args = ["--capacity", "65536", "--batch", "256", "--length", "160", "-k",
            "21"] + argv
    rc, _, err = run(port_main, ["count", fastq, "-o", out, "--device",
                                 "cpu"] + args)
    if "minimizer" in argv:
        assert rc == 2 and "--partition minimizer needs k <= 31" in err
    elif "--devices" in argv:
        j_rc = run(jax_main, ["count", fastq, "-o", j_out] + args)[0]
        assert rc == j_rc == 0, err
        assert npz_digest(out) == npz_digest(j_out)
    else:
        assert rc == 0, err
        assert npz_digest(out) == smoke.SMOKE_DIGESTS[int(argv[-1])]


def test_cli_rejects_a_minimizer_width_past_k(fastq, tmp_path):
    rc, _, err = run(port_main, [
        "count", fastq, "-o", str(tmp_path / "x.npz"), "-k", "9",
        "--devices", "2", "--partition", "minimizer", "--device", "cpu"])
    assert rc == 2 and "--minimizer-w 11" in err


ROUTING_FLAGS = ["--seed", "7", "--route-capacity", "512", "--route-passes",
                 "2", "--minimizer-w", "9"]


@pytest.mark.parametrize("extra", [[], ROUTING_FLAGS])
def test_cli_one_device_ignores_the_partition(fastq, tmp_path, extra):
    """--devices 1 --partition minimizer counts on one device with packed
    ingest, as kmers_tpu's CLI does, and the routing flags parse: the
    table is kmers_tpu's."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    argv = ["--devices", "1", "--partition", "minimizer"] + extra
    assert run(jax_main, smoke.smoke_count_args(fastq, j_out) + argv)[0] == 0
    assert run(port_main, smoke.smoke_count_args(fastq, t_out) + argv
               + ["--device", "cpu"])[0] == 0
    assert npz_digest(t_out) == npz_digest(j_out) == smoke.SMOKE_DIGEST


def test_cli_cuda_device_needs_a_card(fastq, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run(port_main, ["count", fastq, "-k", "21", "-o",
                        str(tmp_path / "x.npz")])


def test_dryrun_cuda_device_needs_a_card():
    """The dry run defaults to cuda and, without a card, raises and names
    --device cpu instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main([])


def test_cli_checkpoint_and_resume(fastq, tmp_path):
    out = str(tmp_path / "t.npz")
    args = smoke.smoke_count_args(fastq, out) + ["--device", "cpu"]
    assert run(port_main, args + ["--checkpoint-every", "3"])[0] == 0
    whole = npz_digest(out)
    rc, _, err = run(port_main, args + ["--resume"])
    assert rc == 0 and "resuming" in err
    assert npz_digest(out) == whole
