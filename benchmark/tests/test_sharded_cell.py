"""The four-card cell ``ecoli-k31-d4.count`` past the look for its cards:
at the small size on four CPU shards its jobs are correct, traced or
not; an exchange that keeps each shard's own rows fails on ``keys_off``;
a route capacity under the buckets' loads fails every job (the CLI's
exit 3).  At the cell's own size on four cards (``-m cuda``) the
exchange left out fails too."""

import time

import pytest
import torch

from benchmark.harness import mixes, runner, spec
from benchmark.tests import tiny
from kmers_tpu_torch.parallel import mesh as tmesh

CELL = "ecoli-k31-d4.count"
#: the small batch of 512 rows gives each of the four shards 128 rows,
#: and a 150 bp read 120 windows at k = 31: at most 15,360 valid lanes a
#: sender, so no bucket of 16,384 lanes can overflow, whatever the hash
SMALL_ROUTE_CAPACITY = 16384


def run(tmp_path, *, route_capacity=SMALL_ROUTE_CAPACITY, trace=False,
        seed=2 ** 32 + 23, small=True, device="cpu", seconds=0.5):
    config = (tiny.small_config(CELL, route_capacity=route_capacity)
              if small else None)
    return runner.run_cell(CELL, seed, seconds, trace, t0=time.time(),
                           device=device, workdir=str(tmp_path),
                           config=config)


def numbers(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


def test_the_cell_asks_for_four_sharded_cards():
    bench = spec.load_benchmark()
    cell = spec.workload(bench, CELL)
    config = spec.load_config(bench, cell["config"])
    assert cell["chips"] == config["devices"] == 4
    assert config["partition"] == "hash"
    assert config["route_capacity"] == 65536
    plain = spec.load_config(bench, "ecoli-k31")
    shared = set(plain) - {"name", "source", "deployment", "guarantees",
                           "devices"}
    assert {key: config[key] for key in shared} == \
        {key: plain[key] for key in shared}


def test_the_driver_adds_the_sharding_flags(tmp_path):
    """count_jobs' arguments, then the configuration's three flags."""
    bench = spec.load_benchmark()
    config = spec.load_config(bench, "ecoli-k31-d4")
    ctx = runner.Context(config, spec.load_traffic("count-sharded"), 5,
                         "cpu", str(tmp_path), False)
    plain = spec.load_driver("count_jobs").Driver(ctx).count_argv("o.npz")
    argv = spec.load_driver("count_jobs_sharded").Driver(ctx).count_argv(
        "o.npz")
    assert argv == plain + ["--devices", "4", "--partition", "hash",
                            "--route-capacity", "65536"]


@pytest.mark.parametrize("trace", [False, True])
def test_unbroken_runs_are_correct(tmp_path, trace):
    result = run(tmp_path, trace=trace)
    assert result["correct"] and result["attempted"] >= 1
    assert set(numbers(result).values()) == {0}
    if trace:
        # on the CPU the host span reads; the device metrics read nothing
        assert set(result["metrics"]) == {"shard_emit_host_ms.d4"}
    else:
        # no card: no peak memory to read
        assert set(result["metrics"]) == {"setup_s"}


def own_rows_only(monkeypatch):
    """The exchange delivers each shard only the rows it sent itself:
    every k-mer that another shard owns is lost in transit, uncounted."""
    def kept(bufs, mesh):
        return [torch.stack([b[r] if s == r else torch.zeros_like(b[r])
                             for s in range(len(bufs))])
                for r, b in enumerate(bufs)]
    monkeypatch.setattr(tmesh, "all_to_all", kept)


def test_exchange_left_out_is_caught(tmp_path, monkeypatch):
    own_rows_only(monkeypatch)
    result = run(tmp_path)
    assert not result["correct"]
    assert numbers(result)["keys_off"] > 0
    assert result["failed"] == result["work"]["tables_checked"] >= 1


def test_overflowing_route_capacity_fails_every_job(tmp_path, monkeypatch):
    """A send budget of 1,024 lanes against buckets of about 3,800 in the
    window's jobs (the warm jobs keep the budget that fits, since their
    failure would stop the set-up): the CLI drops k-mers in routing and
    exits 3, and each job reads on jobs_failed."""
    rcs = []
    run_count = mixes.Mix.run_count

    def overflowing(self, out):
        if out.endswith("warm.npz"):
            return run_count(self, out)
        self.cfg["route_capacity"] = 1024
        rcs.append(run_count(self, out))
        return rcs[-1]
    monkeypatch.setattr(mixes.Mix, "run_count", overflowing)
    result = run(tmp_path)
    assert not result["correct"]
    assert rcs and set(rcs) == {3}
    assert numbers(result)["jobs_failed"] == result["attempted"] == len(rcs)


@pytest.mark.cuda
def test_exchange_left_out_is_caught_at_cell_size(tmp_path, monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards (run on the GPU machine: "
                    "python -m pytest -m cuda benchmark/tests)")
    own_rows_only(monkeypatch)
    result = run(tmp_path, small=False, device="cuda", seconds=3.0,
                 seed=2 ** 31 + 301)
    print({"cell": CELL, "correct": result["correct"],
           "checks": result["checks"]})
    assert not result["correct"]
    assert numbers(result)["keys_off"] > 0
