"""One step of every sharded pipeline over a mesh, each checked against an
independent count: the counterpart of kmers_tpu's multi-chip dry run
(``__graft_entry__.dryrun_multichip``) and of its two-process worker.

  count      make_sharded_counter, k = 21, on a [16, 64] read batch with
             Ns: compact shard tables, and aggregate="unit";
  minimizer  make_sharded_minimizer_counter (k = 21, w = 7) and
             make_superkmer_counter on the same batch;
  lookup     make_sharded_lookup over the count's tables, every window of
             the batch a query (Ns make some invalid);
  sequence   make_sequence_parallel_counter at k = 31 and 63 over one
             1024-base contig with Ns beside three cuts, the middle one
             (between the processes of a two-process mesh) among them,
             and at k = 17 over a 40-base contig, whose blocks at D = 4
             are shorter than the halo (kmers_tpu/parallel/halo.py:30);
  stream     ShardedStreamingCounter (hash) at k = 31, 32, 63 and 64 over
             three batches, packed at k = 31 and 63, the last batch one
             row (so that a process's slice of it is empty), merge_every 2.

Every process generates the whole input from the seed and feeds its own
rows (mesh.local_read_slice); the independent counts are torch.unique
over the plain windows (or minimizer words) of the whole input.  Run in
one process, or as one rank of a process group:

    python -m kmers_tpu_torch.dryrun [--device cuda|cpu] [--local-shards L]
        [--rank R --world P --init URL [--backend gloo|nccl]] [--out DIR]

--device defaults to cuda; without a card that is an error, as in the
CLI (pass --device cpu for the plain PyTorch path).

Each rank checks the global results and prints one JSON line (its checks,
digests and kernel launches).  With --out it writes its arrays to
DIR/dryrun.rank<R>.npz (every shard's tables stacked in global shard
order, metrics, lookup answers) and its streaming checkpoints to
DIR/stream_k<k>.rank<R>.npz.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from . import kernels
from .core import u64, u128
from .io.fastx import pack_batch_np
from .ops import hash as hash_ops
from .ops import kmer
from .ops import minimizer as mini_ops
from .parallel import mesh as mesh_ops
from .parallel import pipeline
from .parallel.stream import ShardedStreamingCounter, npz_digest

K, W = 21, 7
READS = (16, 64)
COUNT = dict(route_capacity=256)
MINIMIZER = dict(route_capacity=512, route_passes=2)
SUPERKMER = dict(route_capacity=128)
QUERY_CAPACITY = 256
CONTIG = 1024
SEQ_KS = (31, 63)
SHORT = dict(length=40, k=17)
STREAM = dict(rows=8, length=96, capacity=2048, route_capacity=256,
              merge_every=2)
STREAM_KS = (31, 32, 63, 64)
PACKED_KS = (31, 63)


def inputs(seed: int = 0) -> dict:
    """The seeded inputs: reads [16, 64] (2 % N), stream rows [8, 96]
    (ACGT), the contig [1024] with Ns beside its quarter cuts, and the
    short contig [40] (ACGT)."""
    rng = np.random.default_rng(424242 + seed)
    reads = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=READS,
                       p=[0.245] * 4 + [0.02])
    rows = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=(STREAM["rows"], STREAM["length"]))
    contig = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, CONTIG)]
    contig[[CONTIG // 4 - 1, CONTIG // 2 + 1, 3 * CONTIG // 4]] = ord("N")
    short = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                           SHORT["length"])]
    return dict(reads=reads, stream=rows, contig=contig, short=short)


def stream_batches(rows: np.ndarray) -> list:
    """The streaming scenario's batches: the rows twice, then one row."""
    return [rows, rows, rows[:1]]


# -- independent counts ---------------------------------------------------------

def _flipped(words) -> torch.Tensor:
    """int64 words, or (hi, lo) pairs as [n, 2] rows, with every word's
    sign bit flipped: their signed order is the keys' unsigned one."""
    if isinstance(words, tuple):
        return u64.to_unsigned_order(torch.stack(words, -1))
    return u64.to_unsigned_order(words)


def _unique(keys: torch.Tensor) -> tuple:
    return torch.unique(keys, dim=0 if keys.dim() == 2 else None,
                        return_counts=True)


def _window_keys(ascii_rows: torch.Tensor, k: int) -> torch.Tensor:
    """The valid canonical keys of the plain windows, flipped."""
    if k > 32:
        win = kmer.kmer_windows_wide(ascii_rows, k)
        hi, lo = kmer.canonical_word_wide(win.fw, win.rc)
        return _flipped((hi[win.valid], lo[win.valid]))
    win = kmer.kmer_windows(ascii_rows, k)
    return _flipped(kmer.canonical_word(win.fw, win.rc)[win.valid])


def _halo_window_keys(seq: torch.Tensor, n_shards: int, k: int):
    """The keys that sequence parallelism counts (k <= 32), flipped: those
    of the windows starting in each of the n_shards blocks and reaching no
    further than the next block's first min(k - 1, L) bases.  A block
    shorter than the halo ships all of itself, so a window across two cuts
    is not formed (kmers_tpu/parallel/halo.py:30)."""
    n = seq.shape[0] // n_shards
    halo = min(k - 1, n)
    keys = []
    for s in range(n_shards):
        ext = seq[s * n:(s + 1) * n + halo]
        ext = torch.cat([ext, ext.new_zeros(n + halo - ext.shape[0])])
        win = kmer.kmer_windows(ext[None, :], k)
        canon = kmer.canonical_word(win.fw, win.rc)[0, :n]
        keys.append(_flipped(canon[win.valid[0, :n]]))
    return torch.cat(keys)


def _table_keys(table) -> tuple:
    """A compact table's live (flipped keys, counts int64)."""
    nu = int(table.n_unique)
    live = [p[:nu] for p in table.keys]
    words = (u128.join_planes(*live) if len(live) == 4
             else u64.join_planes(*live))
    return _flipped(words), table.counts[:nu].to(torch.int64)


def _check(name: str, got: tuple, want: tuple) -> None:
    if not (torch.equal(got[0].cpu(), want[0].cpu())
            and torch.equal(got[1].cpu(), want[1].cpu())):
        raise AssertionError(f"{name}: {got[0].shape[0]} keys differ from "
                             f"the independent count's {want[0].shape[0]}")


# -- the arrays a rank writes ----------------------------------------------------

def shard_arrays(prefix: str, tables, mesh) -> dict:
    """Every shard's table stacked in global shard order (the whole mesh's,
    gathered across processes) and, for count tables, each n_unique."""
    g = pipeline.gather_tables(tables, mesh)
    out = {f"{prefix}_keys{i}": p.cpu().numpy() for i, p in enumerate(g.keys)}
    if hasattr(g, "counts"):
        out[f"{prefix}_counts"] = g.counts.cpu().numpy()
        out[f"{prefix}_n_unique"] = mesh_ops.gather(
            [torch.full((), int(t.n_unique), dtype=torch.int64,
                        device=t.counts.device) for t in tables],
            mesh).cpu().numpy()
    return out


def _metric_arrays(prefix: str, metrics: dict) -> dict:
    return {f"{prefix}_m_{name}": np.int64(int(v))
            for name, v in metrics.items()}


# -- the scenarios ----------------------------------------------------------------

def run(mesh, seed: int = 0, out: Optional[str] = None) -> dict:
    """Every scenario over `mesh`; raises AssertionError where a result
    differs from its independent count.  Returns {"arrays", "checks",
    "digests"}: the arrays of every shard (the whole mesh's), the names of
    the checks passed, and the streaming checkpoints' npz_digest (saved
    under `out` when given)."""
    mesh = mesh_ops.as_mesh(mesh)
    dev = mesh[0]
    data = inputs(seed)
    arrays, checks, digests = {}, [], {}
    reads_all = torch.from_numpy(data["reads"]).to(dev)
    rows = mesh_ops.make_global_array(
        data["reads"][mesh_ops.local_read_slice(READS[0])], mesh)

    # count: compact and unit shard tables, k = 21
    want = _unique(_window_keys(reads_all, K))
    res = pipeline.make_sharded_counter(mesh, K, **COUNT)(rows)
    _check("count", _table_keys(pipeline.global_table(res, mesh)), want)
    arrays.update(shard_arrays("count", res.table, mesh),
                  **_metric_arrays("count", res.metrics))
    unit = pipeline.make_sharded_counter(mesh, K, aggregate="unit",
                                         **COUNT)(rows)
    _check("count_unit", _table_keys(pipeline.global_table(unit, mesh)),
           want)
    arrays.update(shard_arrays("unit", unit.table, mesh),
                  **_metric_arrays("unit", unit.metrics))
    checks += ["count", "count_unit"]

    # minimizer bucketing and the super-k-mer counter, k = 21, w = 7
    mm = mini_ops.minimizer_stream(reads_all, K, W, hash_ops.mix_hash_fn(0))
    mini = pipeline.make_sharded_minimizer_counter(mesh, K, W,
                                                   **MINIMIZER)(rows)
    _check("minimizer", _table_keys(pipeline.global_table(mini, mesh)),
           _unique(_flipped(mm.word[mm.valid])))
    arrays.update(shard_arrays("mini", mini.table, mesh),
                  **_metric_arrays("mini", mini.metrics))
    sk = pipeline.make_superkmer_counter(mesh, K, W, **SUPERKMER)(rows)
    _check("superkmer", _table_keys(pipeline.global_table(sk, mesh)), want)
    arrays.update(shard_arrays("superkmer", sk.table, mesh),
                  **_metric_arrays("superkmer", sk.metrics))
    checks += ["minimizer", "superkmer"]

    # the lookup service over the count's tables: every window a query
    words, valid = pipeline.canonical_kmers(reads_all, K)
    sl = mesh_ops.local_read_slice(READS[0])
    answers, overflow = pipeline.make_sharded_lookup(
        mesh, query_capacity=QUERY_CAPACITY)(
            res.table, mesh_ops.make_global_array(words[sl], mesh),
            mesh_ops.make_global_array(valid[sl], mesh))
    keys, counts = want
    q = _flipped(words[sl])
    at = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    expect = torch.where(valid[sl], torch.where(keys[at] == q, counts[at], 0),
                         -1)
    if int(overflow) or not torch.equal(answers.to(torch.int64), expect):
        raise AssertionError(f"lookup: answers differ from the independent "
                             f"count (overflow {int(overflow)})")
    arrays["lookup_answers"] = mesh_ops.gather(
        list(answers.chunk(mesh.n_local)), mesh).reshape(READS).cpu().numpy()
    arrays["lookup_overflow"] = np.int64(int(overflow))
    checks.append("lookup")

    # sequence parallelism over the contig, a cut between the processes
    contig_all = torch.from_numpy(data["contig"]).to(dev)
    part = mesh_ops.make_global_array(
        data["contig"][mesh_ops.local_read_slice(CONTIG)], mesh)
    for k in SEQ_KS:
        sp = pipeline.make_sequence_parallel_counter(
            mesh, k, route_capacity=CONTIG // mesh.n_shards)(part)
        _check(f"sequence_k{k}", _table_keys(pipeline.global_table(sp, mesh)),
               _unique(_window_keys(contig_all[None, :], k)))
        arrays.update(shard_arrays(f"seq{k}", sp.table, mesh),
                      **_metric_arrays(f"seq{k}", sp.metrics))
        checks.append(f"sequence_k{k}")
    g, k = SHORT["length"], SHORT["k"]
    sp = pipeline.make_sequence_parallel_counter(
        mesh, k, route_capacity=g // mesh.n_shards)(
            mesh_ops.make_global_array(
                data["short"][mesh_ops.local_read_slice(g)], mesh))
    _check("sequence_short", _table_keys(pipeline.global_table(sp, mesh)),
           _unique(_halo_window_keys(torch.from_numpy(data["short"]).to(dev),
                                     mesh.n_shards, k)))
    arrays.update(shard_arrays("short", sp.table, mesh),
                  **_metric_arrays("short", sp.metrics))
    checks.append("sequence_short")

    # the streaming counter, three batches of process-local rows
    batches = stream_batches(data["stream"])
    stream_all = torch.from_numpy(np.concatenate(batches)).to(dev)
    for k in STREAM_KS:
        sc = ShardedStreamingCounter(
            k, STREAM["capacity"], merge_every=STREAM["merge_every"],
            mesh=mesh, route_capacity=STREAM["route_capacity"])
        for b in batches:
            local = b[mesh_ops.local_read_slice(b.shape[0])]
            if k in PACKED_KS:
                sc.update_packed(*pack_batch_np(local))
            else:
                sc.update(local)
        pairs = sc.to_pairs()
        got_keys = _flipped((u128.from_ints([w for w, _ in pairs], dev)
                             if k > 32 else u64.from_ints(
                                 [w for w, _ in pairs], dev)))
        got = (got_keys, torch.tensor([c for _, c in pairs],
                                      dtype=torch.int64))
        _check(f"stream_k{k}", got, _unique(_window_keys(stream_all, k)))
        if sc.route_overflow:
            raise AssertionError(f"stream_k{k}: route_overflow "
                                 f"{sc.route_overflow}")
        arrays.update({f"stream{k}_{name}": np.int64(getattr(sc, name))
                       for name in ("kmers", "batches", "route_overflow",
                                    "route_rerouted", "route_bytes")})
        if out is not None:
            path = os.path.join(out, f"stream_k{k}.rank{mesh.process_index}"
                                ".npz")
            sc.save(path)
            digests[k] = npz_digest(path)
        checks.append(f"stream_k{k}")
    if out is not None:
        np.savez(os.path.join(out, f"dryrun.rank{mesh.process_index}.npz"),
                 **arrays)
    return dict(arrays=arrays, checks=checks, digests=digests)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; rank r takes card r modulo the "
                         "cards) or cpu; cuda without a card is an error")
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init", default=None,
                    help="tcp://host:port or file://path (with --world > 1)")
    ap.add_argument("--backend", default=None, help="gloo or nccl")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the rendezvous and each collective")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = mesh_ops.cli_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    if args.world > 1:
        mesh_ops.init_distributed(args.init, args.world, args.rank,
                                  backend=args.backend, timeout=args.timeout)
    try:
        mesh = mesh_ops.make_mesh(devices=[device] * args.local_shards)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        kernels.reset_launch_counts()
        report = run(mesh, args.seed, args.out)
    finally:
        if args.world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps({
        "rank": mesh.process_index, "processes": mesh.process_count,
        "shards": mesh.n_shards, "device": str(device),
        "checks": report["checks"], "digests": report["digests"],
        "launches": {n: c for n, c in kernels.launch_counts().items() if c}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
