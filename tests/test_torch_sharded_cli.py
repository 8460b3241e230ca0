"""The port's sharded CLI (``count --devices 4 --device cpu``: four
shards on the CPU) against kmers_tpu's on its four-device CPU mesh, on
the smoke input at k = 31, 32, 63 and 64: same exit codes, warnings and
table content, and checkpoints that resume across the packages."""

import pytest

from kmers_tpu.__main__ import main as jax_main
from kmers_tpu_torch import smoke
from kmers_tpu_torch.__main__ import main as port_main
from kmers_tpu_torch.parallel.stream import npz_digest

from test_torch_cli import run


@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    """The first 768 reads of the smoke input (3 batches of 256)."""
    path = str(tmp_path_factory.mktemp("cli") / "smoke.fastq")
    smoke.write_smoke_input(path)
    part = path[:-len(".fastq")] + "_768.fastq"
    with open(path) as f, open(part, "w") as g:
        g.writelines(f.readlines()[:768 * 4])
    return path, part


def check_sharded_count(fastq, tmp_path, partition, k, extra, want_rc):
    """--devices 4: the port's four CPU shards against kmers_tpu's four
    devices: exit code, table, WARNING lines and `stats`; without overflow
    the table is the single-device one, SMOKE_DIGESTS[k]."""
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    # super-k-mers need ~1/10 of the hash partition's lanes (the default)
    budget = ["--route-capacity", "512"] if partition == "minimizer" else []
    argv = ["--devices", "4", "--partition", partition, "--seed",
            "3"] + budget + extra
    j_rc, _, j_err = run(jax_main, smoke.smoke_count_args(fastq, j_out, k)
                         + argv)
    t_rc, _, t_err = run(port_main, smoke.smoke_count_args(fastq, t_out, k)
                         + argv + ["--device", "cpu"])
    assert j_rc == t_rc == want_rc
    assert npz_digest(t_out) == npz_digest(j_out)
    warn = lambda err: [ln for ln in err.splitlines() if "WARNING" in ln]
    assert warn(t_err) == warn(j_err)
    assert bool(warn(t_err)) == (want_rc == 3)
    t_stats = run(port_main, ["stats", t_out, "--device", "cpu"])
    assert t_stats[:2] == run(jax_main, ["stats", j_out])[:2]
    if want_rc == 0:
        assert npz_digest(t_out) == smoke.SMOKE_DIGESTS[k]


def check_resume(small_fastq, tmp_path, first, then, partition, k):
    """A checkpoint of 3 batches written by one package's sharded count
    resumes in the other's over the whole input: the smoke table."""
    fastq, part = small_fastq
    mains = {"jax": (jax_main, []), "port": (port_main, ["--device", "cpu"])}
    out = str(tmp_path / "t.npz")
    argv = ["--devices", "4", "--partition", partition]
    if partition == "minimizer":
        argv += ["--route-capacity", "512"]
    main, dev = mains[first]
    assert run(main, smoke.smoke_count_args(part, out, k) + argv + dev)[0] == 0
    main, dev = mains[then]
    rc, _, err = run(main, smoke.smoke_count_args(fastq, out, k) + argv + dev
                     + ["--resume"])
    assert rc == 0 and "resuming from" in err and "3 batches" in err
    assert npz_digest(out) == smoke.SMOKE_DIGESTS[k]


@pytest.mark.parametrize("partition,extra,want_rc", [
    ("hash", [], 0),
    ("minimizer", [], 0),
    ("hash", ["--route-capacity", "64"], 3),          # routing overflow
])
def test_cli_sharded_matches_kmers_tpu(small_fastq, tmp_path, partition,
                                       extra, want_rc):
    check_sharded_count(small_fastq[0], tmp_path, partition, 31, extra,
                        want_rc)


@pytest.mark.parametrize("k,extra,want_rc", [
    (32, [], 0), (63, [], 0), (64, [], 0),
    (63, ["--route-capacity", "64"], 3),              # routing overflow
])
def test_cli_sharded_wide_matches_kmers_tpu(small_fastq, tmp_path, k, extra,
                                            want_rc):
    """The hash partition at k = 32, 63 and 64 (128-bit keys past 32, full
    words at 32 and 64)."""
    check_sharded_count(small_fastq[0], tmp_path, "hash", k, extra, want_rc)


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_cli_sharded_resume_across_packages(small_fastq, tmp_path, first,
                                            then):
    check_resume(small_fastq, tmp_path, first, then, "minimizer", 31)


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_cli_sharded_wide_resume_across_packages(small_fastq, tmp_path,
                                                 first, then):
    check_resume(small_fastq, tmp_path, first, then, "hash", 63)
