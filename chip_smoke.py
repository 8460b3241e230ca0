#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (kmers_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--workdir DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Imports no JAX.  Phases, one line of output each (any failure raises, so
the exit code is non-zero):

  1. device: the card's name and power limit; build the kernels.
  2. kernels: the hash emitters K5 and K8 driven once as bench.py's step,
     and the stage variants (K2 at stage "pack", K9 at stage "hash") once
     as bench_configs.py's ablation steps (their launch counts), then each CUDA kernel and variant against its plain PyTorch
     version on the card at main-path shapes, bit for bit (K1 at both
     stages also at [1001, 288], K2 and K7 at [1001, 150], K5 and K8 at [1001, 150] and
     [7, 257], K4 at 1,000,003 lanes on aligned planes and on views off 16
     bytes, keep bytes 1-255); median times of both.
  3. end to end, k=31: `count` on a seeded E. coli-scale read set
     (4,641,652 bp genome, 1,000,000 reads of 150 bp), capacity 2^24,
     packed ingest; the table must equal an independent torch.unique
     count of the plain windows, and the run must have launched the
     window (K1), merge (K3) and compress (K4) kernels.  A shorter
     --ascii-ingest run must launch K2 and give the packed run's table;
     the walls of both 100k-read runs.
 3b. the packed ingest's arm of the roofline ablation: one pass of K1 at
     stage "pack" over phase 3's reads as packed [4096, 256] batches (its
     launch count), and whole-pass walls of both K1 stages in turns.
  4. end to end, k=63 (128-bit keys): the same run on the same reads;
     the table must equal an independent torch.unique(dim=0) count of
     the plain wide windows, and the run must have launched the wide
     merge (K6) and K4.  The shorter --ascii-ingest run must launch K7
     and give the packed run's table; both walls.
  5. against the JAX package, at k=31 and k=63: the small fixed input's
     table digest must equal SMOKE_DIGEST / SMOKE_DIGEST_WIDE (pinned by
     the tests to kmers_tpu's CPU output); an evicting run exits 3 and
     matches the port's CPU run; query and stats agree between the card
     and the CPU.
  6. the minimizer kernel K9 against its plain version on every lane, for
     each order (mix64, mix32, mix16, lex) at six (k, w) pairs and at a
     row length off 32; K9 and plain timed at [2048, 1024], k=31, w=11,
     mix16 (bench_configs.py's config 4 shape), and at the [4096, 256] and
     [1024, 256] batches phase 7 gives it.
  7. sharded counting, k=31, on the 1M-read set: ShardedStreamingCounter
     by minimizer (super-k-mers, K9) and by hash partition, each with one
     shard and with four shards placed on the one card.  Each run must
     have zero routing overflow, save the table of phase 3's single-device
     count (npz_digest), and launch K3 and K4 (and K9 under the minimizer
     partition).
  8. K10 (narrow and wide, every segment size from 8 to 4096 in one
     thread block, and 8192, 16384 and 65536 through the merge rounds)
     and K11 against their plain versions on the count forms' keys, timed
     (K10 at segments of 64, 1024, 8192, 16384 and 65536; K11 beside
     torch.sort at the 2^18 keys of a phase-11 shard, 2^20, 2^24 and
     1,000,003 keys).
  9. the 1M-read set through the compact (K11) and run-length (K10)
     batch tables, and through count_words_segmented(_wide) at 8192-lane
     segments (K10's merge rounds), folded every 16 batches: each table
     equals phase 3's / phase 4's.
 10. `count` at k=32 and k=64 (run-length path) against torch.unique,
     and their smoke digests, eviction, stats and query.
 11. the compact sharded counter and minimizer bucketing on 4 shards.
 14. sharded counting past k = 31 and sequence parallelism, 4 shards on
     the one card: ShardedStreamingCounter (hash) over the 1M-read set at
     k=32, 63 and 64 must save the single-device table of phase 10 / 4
     with zero overflow and 9 B (k=32) or 17 B a received lane of
     route_bytes, the k=63 run launching K6 and K4;
     make_sequence_parallel_counter over the 4,641,652 bp genome itself
     (Ns at and beside the cuts) at k=31 and 63 must equal an
     independent torch.unique count of the whole sequence with no key on
     two shards, the k=31 run launching K11.  Walls, k-mers/s, peak
     memory and route_bytes.
 15. the multi-process mesh (after 14): two processes on the one card,
     joined by torch.distributed over gloo with CUDA tensors, two shards
     each (D = 4), each spawned as `chip_smoke.py --worker` and feeding
     its local_read_slice of every batch: ShardedStreamingCounter over the
     1M reads by hash at k=31 (phase 7's D = 4 route capacity), by
     minimizer (k=31, w=11) and by hash at k=63 (phase 14's) must save
     phase 3's / phase 4's table on both processes with zero overflow and
     the one-process run's route_bytes, launching K3 and K4 (K9 by
     minimizer, K6 at k=63); phase 14's sequence-parallel steps, each
     process half the genome, must give phase 14's shard tables lane for
     lane (K11 at k=31); two ranks of `python -m kmers_tpu_torch.dryrun`
     must pass every check and equal the one-process dry run.  Walls by
     process, k-mers/s, route_bytes and peak memory by process beside the
     one-process D = 4 walls.  A worker that fails or runs past its
     timeout fails the phase.
 16. the parity surface outside counting (after 15, before 13 and 12):
     the seeded genome of phase 3 into a SeqVector on the card by
     from_bytes and by push_chars in chunks of 150,000 bases (the same
     words); all_kmers at k=31 and 32 and minimizers at (31, 11) under the
     mix and the lex hash, each equal to the same call on the CPU; the
     canonical words of all_kmers(31) equal to kmer_windows' on the
     genome as one row; the simple_sds bytes and the npz (npz_digest) equal
     to the CPU's; a slice of the middle megabase reads the whole's
     k-mers; the first 100,000 reads of phase 3's set, in batches of 4096,
     through generic.encode_windows, decode and rev_comp at three specs
     (u64 k=31 ACGT, u128 k=63 GTCA, u32 k=15 Xor10), each batch equal to
     the CPU's; PARITY_DIGEST (pinned by the tests to kmers_tpu's CPU
     output) recomputed on the card.  The walls of from_bytes,
     all_kmers(31), minimizers(31, 11) and one encode_windows batch.
 17. the mesh's second axis (after 16, before 13 and 12): a (2, 2) mesh
     on the one card (make_mesh(devices=[cuda] * 4, seq_shards=2)); the
     hash counter at k=31 over "d" and over "s" on the first 250,000 of
     phase 3's reads, and over "s" the super-k-mer counter (k=31, w=11)
     on the first 65,536, the sequence-parallel counter at k=31 on phase
     14's genome and the lookup at both arms at phase 13's shape (b):
     every local shard's table equal, lane for lane, to the one-axis
     D = 2 run's at its index along the axis, the same metrics, no
     overflow, the lookup's answers equal; the 2-D calls launch K11, K9,
     K4 and K3 with idx.  Each wall beside the D = 2 call's.
 13. the distributed lookup service (runs before phase 12, whose profiler
     would slow it), both answer arms of make_sharded_lookup (merge: K3
     with its source-index plane and K4; binary search): bench_configs.py
     --lookup's table (2^19 keys, capacity 2^20) and 2^20 queries on one
     shard, and phase 3's table split by owner over four shards of 2^22
     slots on the one card with 2^20 queries (half present, a quarter
     random canonical words, a quarter invalid, one whose routing mix is
     the invalid sentinel); answers equal count.lookup /
     StreamingCounter.lookup, no overflow, lookup_sharded agrees; walls,
     median times and queries/s, peak memory.  K3 with idx bit for bit
     against its plain version at 2^24 + 2^24 and at a shard's lookup
     shape, timed.
 12. one K11 call on phase 8's 2^20 keys: whether the host waits for the
     card in it, the device operations it queues and the key bytes it
     moves; then the device time of each of its kernels at every phase-8
     size, and of one K1 (both stages), K2 (k=31) and K7 (k=63) at
     [4096, 256], K5
     (k=31) and K8 (k=63) at [2048, 1024], the stage variants, K10 (seg
     64), K4 (2^25: its memset and its one kernel) and K3 with idx
     (2^24 + 2^24) call at their timed shapes (torch.profiler, last so
     that it cannot skew the walls above).

The last three lines: `nvidia-smi` name and power limit, a JSON object
of the kernels' launches, errors and times, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types

sys.modules["jax"] = None          # the port must run where JAX is absent

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# main-path shapes: window batch [B, L], the hash emitters' batch
# (bench.py's and bench_configs.py's), merge sides, compress lanes, and
# the end-to-end read count (1M reads of 150 bp on a 4.6 Mbp genome)
SIZES = dict(window=(4096, 256), window_odd=(1001, 288),
             ascii_odd=(1001, 150), hash=(2048, 1024), hash_tiny=(7, 257),
             merge=1 << 24,
             compress=1 << 25, reads=1_000_000, short_reads=100_000,
             genome=4_641_652, sort_big=1 << 24, odd=1_000_003)
# K10's segments past one thread block's 4096 lanes (the merge rounds);
# phase 9 folds the 1M reads through the first of them
LARGE_SEGMENTS = (8192, 16384, 65536)
PROFILED_CALLS = 20                # calls phase 12 profiles a kernel over

KERNEL_INFO = {
    "pack_canonical_keys_packed": ("kmers_tpu_torch/kernels/csrc/window.cu",
                                   "kmers_tpu/kernels/window.py:338"),
    "pack_canonical_keys": ("kmers_tpu_torch/kernels/csrc/window.cu",
                            "kmers_tpu/kernels/window.py:391"),
    "merge_sorted": ("kmers_tpu_torch/kernels/csrc/merge.cu",
                     "kmers_tpu/kernels/merge.py:127"),
    "merge_sorted_idx": ("kmers_tpu_torch/kernels/csrc/merge.cu",
                         "kmers_tpu/kernels/merge.py:127 (with_idx)"),
    "compress_flagged": ("kmers_tpu_torch/kernels/csrc/merge.cu",
                         "kmers_tpu/kernels/merge.py:284"),
    "pack_canonical_hash": ("kmers_tpu_torch/kernels/csrc/window.cu",
                            "kmers_tpu/kernels/window.py:205"),
    "merge_sorted_wide": ("kmers_tpu_torch/kernels/csrc/merge.cu",
                          "kmers_tpu/kernels/merge.py:509"),
    "pack_canonical_keys_wide": ("kmers_tpu_torch/kernels/csrc/window_wide.cu",
                                 "kmers_tpu/kernels/window_wide.py:147"),
    "pack_canonical_hash_wide": ("kmers_tpu_torch/kernels/csrc/window_wide.cu",
                                 "kmers_tpu/kernels/window_wide.py:178"),
    "minimizer_kernel": ("kmers_tpu_torch/kernels/csrc/minimizer.cu",
                         "kmers_tpu/kernels/minimizer.py:278"),
    "segment_count_keys": ("kmers_tpu_torch/kernels/csrc/count_tile.cu",
                           "kmers_tpu/kernels/count_tile.py:234"),
    "segment_count_keys_wide": ("kmers_tpu_torch/kernels/csrc/count_tile.cu",
                                "kmers_tpu/kernels/count_tile.py:262"),
    "radix_sort_u64": ("kmers_tpu_torch/kernels/csrc/sort.cu",
                       "kmers_tpu/kernels/sort.py:184"),
    "pack_canonical_keys_packed[pack]": (
        "kmers_tpu_torch/kernels/csrc/window.cu",
        "kmers_tpu/kernels/window.py:338 (stage=\"pack\")"),
    "pack_canonical_keys[pack]": (
        "kmers_tpu_torch/kernels/csrc/window.cu",
        "kmers_tpu/kernels/window.py:391 (stage=\"pack\")"),
    "minimizer_kernel[hash]": (
        "kmers_tpu_torch/kernels/csrc/minimizer.cu",
        "kmers_tpu/kernels/minimizer.py:278 (stage=\"hash\")"),
    "search_counts": ("kmers_tpu_torch/kernels/csrc/lookup.cu",
                      "none (kmers_tpu/parallel/count.py:574, jnp)"),
}
# the sharded runs of phase 7: (partition, shards, route_capacity); the
# minimizer partition's budget counts super-k-mers, ~12 per 150 bp read
SHARDED_RUNS = (("minimizer", 1, 1 << 16), ("minimizer", 4, 1 << 13),
                ("hash", 1, 1 << 20), ("hash", 4, 1 << 16))
# phase 11's compact sharded counter: (shards, route_capacity)
SHARDED_COMPACT = (4, 1 << 16)
# phase 14: ShardedStreamingCounter (hash partition) past k = 31 on four
# shards of the one card.  A sender's 1024 rows of a batch hold ~119
# valid windows each (k = 32), ~30.5k lanes a destination (a standard
# deviation of ~150), so 2^15 lanes leave no overflow at any of these k
SHARDED_WIDE = dict(shards=4, route_capacity=1 << 15, ks=(32, 63, 64))
# ... and make_sequence_parallel_counter over the seeded genome itself,
# split over four shards, with Ns at these offsets from each cut; its
# route capacity is an even share of a shard's windows a destination,
# plus `margin`
SEQ_PARALLEL = dict(shards=4, ks=(31, 63), n_offsets=(-2, 0, 5),
                    margin=1.05)
# phase 15: the multi-process mesh, two processes on the one card over
# gloo with CUDA tensors, two shards each (D = 4): the 1M reads by hash at
# k = 31 (phase 7's D = 4 route capacity), by minimizer (k = 31, w = 11,
# phase 7's) and by hash at k = 63 (phase 14's); seconds a process group
# waits in a collective, and a phase 15 spawn may run
MULTIPROCESS = dict(processes=2, local_shards=2,
                    runs=(("hash", 31, 1 << 16), ("minimizer", 31, 1 << 13),
                          ("hash", 63, 1 << 15)),
                    group_timeout=300, spawn_timeout=600)
WORKER_CMD = [sys.executable, os.path.abspath(__file__)]
# phase 16: push_chars' chunk (bases), the k of all_kmers, the minimizer
# (k, w), the slice of the genome's middle (bases), and the reads of phase
# 3's set that go through the generic layer, in batches
PARITY = dict(chunk=150_000, ks=(31, 32), minimizer=(31, 11),
              slice_len=1_000_000, reads=100_000, batch=4096)
# phase 17: the two-axis mesh (d, s) on the one card; the first `reads` of
# phase 3's set for the hash counter at k = 31 (a sender's 125,000 rows
# hold ~15M windows, ~7.5M a destination, so 2^23 lanes leave no
# overflow), the first `superkmer_reads` for the super-k-mer counter
# (~12 super-k-mers a read, ~197k a destination), and a sender's share of
# phase 13's (b) queries as the lookup's query capacity
MESH2D = dict(shape=(2, 2), reads=250_000, route_capacity=1 << 23,
              superkmer_reads=65_536, superkmer_capacity=1 << 18,
              query_capacity=1 << 19)
# phase 13's lookups: bench_configs.py --lookup's table and queries on one
# shard (:576-596), and phase 3's table split over four shards of 2^22
# slots with 2^20 queries, 2^17 lanes a sender and destination
LOOKUP = dict(bench_keys=1 << 19, bench_capacity=1 << 20, queries=1 << 20,
              shards=4, shard_capacity=1 << 22, query_capacity=1 << 17)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() in ms, by CUDA events, after warm-up.

    A queued torch.cuda._sleep keeps the card busy while the host enqueues
    the start event and fn's launches, so the events bracket device work
    and not the host's launch overhead (which for K1 is several times its
    device time).  The events' own cost, a few us, is in every sample;
    phase 12 gives the profiler's device time beside it for the smallest
    kernels.  A plain version that syncs inside (nonzero) still pays its
    host gap: that is its real cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int) -> float:
    """Least device time for moving n_bytes through HBM, in ms: the bytes
    a kernel must move (each input read once, each output written once)
    at the card's peak HBM rate (profiling.device_hbm_gbps: 3.35 TB/s on
    the H100 SXM)."""
    from kmers_tpu_torch import profiling

    return n_bytes / (profiling.device_hbm_gbps() * 1e6)


def max_abs_err(got, want) -> int:
    """Largest |difference| over paired int planes (0 = bit for bit)."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def seeded_reads(rs, B: int, L: int):
    """[B, L] ASCII reads with lowercase bases and runs of N."""
    import numpy as np

    reads = np.frombuffer(b"ACGTacgt", dtype=np.uint8)[
        rs.randint(0, 8, size=(B, L))].copy()
    for _ in range(B // 2):
        b, p = rs.randint(0, B), rs.randint(0, L)
        reads[b, p:p + rs.randint(1, 40)] = ord("N")
    return reads


def phase_device(stats: dict) -> None:
    from kmers_tpu_torch.kernels import _build

    stats["smi"] = nvidia_smi()
    t0 = time.time()
    info = _build.build()
    _build.lib()
    say(f"phase 1 device: {stats['smi']}; kernels "
        f"{'built' if info['built'] else 'up to date'} in "
        f"{time.time() - t0:.1f}s (nvcc {info['seconds']:.1f}s)")
    # ptxas -v: "Compiling entry function '<name>'", its stack and spill
    # line, then its registers and shared memory
    name = spill = ""
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            say(f"  ptxas: {name}: {ln.split(':', 1)[1].strip()}; {spill}")


def phase_kernels(stats: dict, seed: int) -> None:
    import numpy as np
    import torch

    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.kernels import merge as kmerge
    from kmers_tpu_torch.kernels import window as kwin

    dev = torch.device(DEVICE)
    rs = np.random.RandomState(seed)
    res = stats["kernels"]

    # K1 / K2 at [4096, 256]
    reads_np = seeded_reads(rs, *SIZES["window"])
    words_np, vbits_np = fastx.pack_batch_np(reads_np)
    reads = torch.from_numpy(reads_np).to(dev)
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    vbits = torch.from_numpy(vbits_np.view(np.int32)).to(dev)
    e1 = e2 = 0
    for k in (1, 15, 16, 17, 31):
        e1 = max(e1, max_abs_err(
            kwin.pack_canonical_keys_packed(words, vbits, k),
            kwin.pack_canonical_keys_packed_plain(words, vbits, k)))
        e2 = max(e2, max_abs_err(kwin.pack_canonical_keys(reads, k),
                                 kwin.pack_canonical_keys_plain(reads, k)))
    # K1 also at a row length off its 256-lane chunk, rows off its 8-row
    # block (reads of their own seed: the later kernels' inputs stay put)
    odd_np = fastx.pack_batch_np(seeded_reads(
        np.random.RandomState(seed + 1), *SIZES["window_odd"]))
    odd_w, odd_v = (torch.from_numpy(a.view(np.int32)).to(dev) for a in odd_np)
    for k in (1, 15, 16, 17, 31):
        e1 = max(e1, max_abs_err(
            kwin.pack_canonical_keys_packed(odd_w, odd_v, k),
            kwin.pack_canonical_keys_packed_plain(odd_w, odd_v, k)))
    # K2 also at the reads' own length, off every run and tile size
    odd_r = torch.from_numpy(seeded_reads(np.random.RandomState(seed + 3),
                                          *SIZES["ascii_odd"])).to(dev)
    for k in (1, 15, 16, 17, 31):
        e2 = max(e2, max_abs_err(kwin.pack_canonical_keys(odd_r, k),
                                 kwin.pack_canonical_keys_plain(odd_r, k)))
    res["pack_canonical_keys_packed"] = dict(
        max_abs_err=e1,
        ms=time_ms(lambda: kwin.pack_canonical_keys_packed(words, vbits, 31)),
        plain_ms=time_ms(
            lambda: kwin.pack_canonical_keys_packed_plain(words, vbits, 31)),
        bound_ms=bound_ms(nbytes(words, vbits, *kwin.pack_canonical_keys_packed(
            words, vbits, 31))), library_ms=None)
    stats["profiled"]["pack_canonical_keys_packed [4096, 256]"] = (
        lambda: kwin.pack_canonical_keys_packed(words, vbits, 31))
    # K1 at stage "pack" (the packed ingest's compute-light arm of the
    # roofline ablation) on the same inputs, timed beside "canon"; its
    # launch count comes from phase 3's pass (phase_ablation_packed)
    k1_pack = lambda w, v, k: kwin.pack_canonical_keys_packed(w, v, k, "pack")
    res["pack_canonical_keys_packed[pack]"] = dict(
        max_abs_err=max(max_abs_err(
            k1_pack(w, v, k),
            kwin.pack_canonical_keys_packed_plain(w, v, k, "pack"))
            for w, v in ((words, vbits), (odd_w, odd_v))
            for k in (1, 15, 16, 17, 31)),
        ms=time_ms(lambda: k1_pack(words, vbits, 31)),
        plain_ms=time_ms(lambda: kwin.pack_canonical_keys_packed_plain(
            words, vbits, 31, "pack")),
        bound_ms=bound_ms(nbytes(words, vbits, *k1_pack(words, vbits, 31))),
        library_ms=None)
    stats["profiled"]["pack_canonical_keys_packed[pack] [4096, 256]"] = (
        lambda: k1_pack(words, vbits, 31))
    res["pack_canonical_keys"] = dict(
        max_abs_err=e2,
        ms=time_ms(lambda: kwin.pack_canonical_keys(reads, 31)),
        plain_ms=time_ms(lambda: kwin.pack_canonical_keys_plain(reads, 31)),
        bound_ms=bound_ms(nbytes(reads, *kwin.pack_canonical_keys(reads, 31))),
        library_ms=None)
    stats["profiled"]["pack_canonical_keys [4096, 256]"] = (
        lambda: kwin.pack_canonical_keys(reads, 31))

    g = torch.Generator(device=dev).manual_seed(seed)
    args3 = merge_inputs(g)
    res["merge_sorted"] = dict(
        max_abs_err=max_abs_err(kmerge.merge_sorted(*args3),
                                kmerge.merge_sorted_plain(*args3)),
        ms=time_ms(lambda: kmerge.merge_sorted(*args3)),
        plain_ms=time_ms(lambda: kmerge.merge_sorted_plain(*args3)),
        bound_ms=bound_ms(nbytes(*args3, *kmerge.merge_sorted(*args3))),
        library_ms=None)

    planes, keep = compress_inputs(g)
    kept = int(keep.sum())
    # also at a length off every tile size, on views that start off 16
    # bytes, with keep bytes other than 0 and 1 (a generator of its own:
    # the later kernels' inputs stay put)
    odd, odd_keep = compress_inputs(
        torch.Generator(device=dev).manual_seed(seed + 1), SIZES["odd"] + 1)
    odd_keep = odd_keep * torch.randint(1, 256, odd_keep.shape, device=dev,
                                        dtype=torch.uint8)
    err4 = max(compress_err(p, k) for p, k in (
        (planes, keep), (odd, odd_keep), ([x[1:] for x in odd], odd_keep[1:])))
    # the library route: boolean-mask indexing of the stacked planes
    stacked, mask = torch.stack(planes), keep.bool()
    res["compress_flagged"] = dict(
        max_abs_err=err4,
        ms=time_ms(lambda: kmerge.compress_flagged(*planes, keep)),
        plain_ms=time_ms(lambda: kmerge.compress_flagged_plain(*planes, keep)),
        bound_ms=bound_ms(nbytes(*planes, keep) + 12 * kept),
        library_ms=time_ms(lambda: stacked[:, mask]))

    kernels_hash(stats, rs, seed)
    kernels_wide(stats, rs, g, seed)
    kernels_stages(stats, reads, seed)

    for name, r in res.items():
        if r["max_abs_err"]:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max_abs_err {r['max_abs_err']})")
    say(f"phase 2 kernels: all {len(res)} bit-exact vs plain; " + "; ".join(
        f"{name} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms)"
        for name, r in res.items()))


def merge_inputs(g) -> tuple:
    """K3's inputs: a 2^24-lane table (3/4 live) with 2^24 sorted unit
    keys, half of them drawn from the table's keys, a tenth flagged
    dead."""
    import torch

    from kmers_tpu_torch.core import u64

    dev = torch.device(DEVICE)
    n = SIZES["merge"]
    rand_keys = lambda m: torch.randint(0, 1 << 62, (m,), device=dev,
                                        generator=g)
    live_keys = torch.unique(rand_keys(3 * n // 4))
    nl = live_keys.shape[0]
    a_key = torch.cat([live_keys, torch.full((n - nl,), -1, device=dev,
                                             dtype=torch.int64)])
    a_hi, a_lo = u64.split_word(a_key)
    a_w = torch.where(torch.arange(n, device=dev) < nl,
                      torch.randint(1, 1000, (n,), device=dev, generator=g,
                                    dtype=torch.int32), 0)
    pick = torch.randint(0, nl, (n // 2,), device=dev, generator=g)
    b_key = torch.cat([live_keys[pick], rand_keys(n - n // 2)])
    dead = torch.rand(n, device=dev, generator=g) < 0.1
    b_key = torch.where(dead, u64.SIGN_BIT, b_key)
    b_key = u64.to_unsigned_order(torch.sort(u64.to_unsigned_order(b_key))
                                  .values)
    return (a_hi, a_lo, a_w) + u64.split_word(b_key)


def compress_inputs(g, n4: int = 0) -> tuple:
    """K4's inputs: three random planes of n4 lanes (by default the main
    path's 2^25), about half kept."""
    import torch

    from kmers_tpu_torch.core import u64

    n4 = n4 or SIZES["compress"]
    planes = [u64.low32_as_int32(torch.randint(0, 1 << 32, (n4,),
                                               device=DEVICE, generator=g))
              for _ in range(3)]
    keep = (torch.rand(n4, device=DEVICE, generator=g) < 0.5).to(torch.uint8)
    return planes, keep


def compress_err(planes, keep) -> int:
    """max_abs_err of K4 against its plain version on the kept lanes."""
    from kmers_tpu_torch.kernels import merge as kmerge

    kept = int((keep != 0).sum())
    return max_abs_err(
        [x[:kept] for x in kmerge.compress_flagged(*planes, keep)],
        [x[:kept] for x in kmerge.compress_flagged_plain(*planes, keep)])


def kernels_hash(stats: dict, rs, seed: int) -> None:
    """K5 and K8 at bench.py's / bench_configs.py's [2048, 1024]: driven
    once as the benchmark step (the launch counts reset just before and
    read just after), then held against their plain versions (K5 at
    k in {1, 16, 17, 31, 32}, K8 at k in {33, 48, 63, 64}, two seeds, every
    lane; both also at [1001, 150] and [7, 257], K5 at the same k, K8 at
    k in {33, 63, 64}) and timed at k=31 / k=63."""
    import numpy as np
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.kernels import window as kwin
    from kmers_tpu_torch.kernels import window_wide as kww

    res = stats["kernels"]
    reads = torch.from_numpy(seeded_reads(rs, *SIZES["hash"])).to(DEVICE)
    sync()
    kernels.reset_launch_counts()
    step5 = kwin.pack_canonical_hash(reads, 31)
    step8 = kww.pack_canonical_hash_wide(reads, 63)
    sync()
    launched = kernels.launch_counts()
    stats["launches"].update(
        (name, launched[name])
        for name in ("pack_canonical_hash", "pack_canonical_hash_wide"))
    for name, out, n_hash in (("pack_canonical_hash", step5, 4),
                              ("pack_canonical_hash_wide", step8, 6)):
        valid = out[-1].bool()
        if launched[name] != 1 or not valid.any():
            raise AssertionError(f"{name}: {launched[name]} launches, "
                                 f"{int(valid.sum())} valid lanes")
        # a hash over ~2M distinct valid windows has no constant plane
        for h in out[n_hash - 2:n_hash]:
            if int(torch.unique(h[valid]).numel()) < 1000:
                raise AssertionError(f"{name}: degenerate hash plane")
    seeds = (0, (1 << 40) + 3)
    # K5 and K8 also at rows off every run and tile size (reads of their
    # own seed: the later kernels' inputs stay put)
    rs_odd = np.random.RandomState(seed + 4)
    odd = [torch.from_numpy(seeded_reads(rs_odd, *SIZES[name])).to(DEVICE)
           for name in ("ascii_odd", "hash_tiny")]
    res["pack_canonical_hash"] = dict(
        max_abs_err=max(max_abs_err(kwin.pack_canonical_hash(r, k, s),
                                    kwin.pack_canonical_hash_plain(r, k, s))
                        for r in [reads] + odd
                        for k in (1, 16, 17, 31, 32) for s in seeds),
        ms=time_ms(lambda: kwin.pack_canonical_hash(reads, 31)),
        plain_ms=time_ms(lambda: kwin.pack_canonical_hash_plain(reads, 31)),
        bound_ms=bound_ms(nbytes(reads, *step5)), library_ms=None)
    stats["profiled"]["pack_canonical_hash [2048, 1024] k=31"] = (
        lambda: kwin.pack_canonical_hash(reads, 31))
    cases = ([(reads, k) for k in (33, 48, 63, 64)]
             + [(r, k) for r in odd for k in (33, 63, 64)])
    res["pack_canonical_hash_wide"] = dict(
        max_abs_err=max(
            max_abs_err(kww.pack_canonical_hash_wide(r, k, s),
                        kww.pack_canonical_hash_wide_plain(r, k, s))
            for r, k in cases for s in seeds),
        ms=time_ms(lambda: kww.pack_canonical_hash_wide(reads, 63)),
        plain_ms=time_ms(
            lambda: kww.pack_canonical_hash_wide_plain(reads, 63)),
        bound_ms=bound_ms(nbytes(reads, *step8)), library_ms=None)
    stats["profiled"]["pack_canonical_hash_wide [2048, 1024] k=63"] = (
        lambda: kww.pack_canonical_hash_wide(reads, 63))


def kernels_stages(stats: dict, reads, seed: int) -> None:
    """The stage variants of bench_configs.py's roofline ablation, at its
    shape [2048, 1024], k=31 (reads of their own seed): K2 at stage "pack"
    and K9 at stage "hash", w=11, each driven once as an ablation step
    (the launch counts reset just before and read just after: K9 under its
    mix64 default), then held against its plain version on every lane (K2
    at k in {1, 16, 17, 31}, also on the count batch [4096, 256]; K9 for
    each order) and timed there (K9 for each order; its JSON entry under
    mix64)."""
    import numpy as np
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.kernels import minimizer as kmin
    from kmers_tpu_torch.kernels import window as kwin

    res = stats["kernels"]
    areads = torch.from_numpy(seeded_reads(np.random.RandomState(seed + 5),
                                           *SIZES["hash"])).to(DEVICE)
    k2_pack = lambda r, k: kwin.pack_canonical_keys(r, k, "pack")
    k9_hash = lambda order: kmin.minimizer_kernel(areads, 31, 11, 0, order,
                                                 "hash")
    sync()
    kernels.reset_launch_counts()
    steps = {"pack_canonical_keys[pack]": k2_pack(areads, 31),
             "minimizer_kernel[hash]": k9_hash("mix64")}
    sync()
    launched = kernels.launch_counts()
    for name in steps:
        stats["launches"][name] = launched[name]
        if launched[name] != 1:
            raise AssertionError(f"{name}: {launched[name]} launches")
    res["pack_canonical_keys[pack]"] = dict(
        max_abs_err=max(max_abs_err(
            k2_pack(r, k), kwin.pack_canonical_keys_plain(r, k, "pack"))
            for r in (areads, reads) for k in (1, 16, 17, 31)),
        ms=time_ms(lambda: k2_pack(areads, 31)),
        plain_ms=time_ms(
            lambda: kwin.pack_canonical_keys_plain(areads, 31, "pack")),
        bound_ms=bound_ms(nbytes(areads,
                                 *steps["pack_canonical_keys[pack]"])),
        library_ms=None)
    plain_hash = lambda order: kmin.minimizer_kernel_plain(
        areads, 31, 11, 0, order, "hash")
    times = {order: (time_ms(lambda: k9_hash(order)),
                     time_ms(lambda: plain_hash(order)))
             for order in kmin.ORDERS}
    res["minimizer_kernel[hash]"] = dict(
        max_abs_err=max(max_abs_err(k9_hash(order), plain_hash(order))
                        for order in kmin.ORDERS),
        ms=times["mix64"][0], plain_ms=times["mix64"][1],
        bound_ms=bound_ms(nbytes(areads, *steps["minimizer_kernel[hash]"])),
        library_ms=None)
    say(f"  stage variants: minimizer_kernel[hash] {list(areads.shape)} "
        f"k=31 w=11 "
        + "; ".join(f"{order} {t:.5f} ms (plain {p:.3f})"
                    for order, (t, p) in times.items())
        + f"; bound {res['minimizer_kernel[hash]']['bound_ms']:.5f}")
    for label, fn in (
            ("pack_canonical_keys[pack] [2048, 1024]",
             lambda: k2_pack(areads, 31)),
            ("minimizer_kernel[hash] [2048, 1024] mix64",
             lambda: k9_hash("mix64"))):
        stats["profiled"][label] = fn


def kernels_wide(stats: dict, rs, g, seed: int) -> None:
    """K7 at the count batch [4096, 256] and at [1001, 150] (the reads'
    own length, off every run and block size), k in {33, 47, 48, 63}; K6
    at 2^24 + 2^24 lanes of 128-bit keys."""
    import numpy as np
    import torch

    from kmers_tpu_torch.core import u64, u128
    from kmers_tpu_torch.kernels import merge as kmerge
    from kmers_tpu_torch.kernels import window_wide as kww

    res = stats["kernels"]
    dev = torch.device(DEVICE)
    reads = torch.from_numpy(seeded_reads(rs, *SIZES["window"])).to(dev)
    odd = torch.from_numpy(seeded_reads(np.random.RandomState(seed + 2),
                                        *SIZES["ascii_odd"])).to(dev)
    res["pack_canonical_keys_wide"] = dict(
        max_abs_err=max(max_abs_err(kww.pack_canonical_keys_wide(r, k),
                                    kww.pack_canonical_keys_wide_plain(r, k))
                        for k in (33, 47, 48, 63) for r in (reads, odd)),
        ms=time_ms(lambda: kww.pack_canonical_keys_wide(reads, 63)),
        plain_ms=time_ms(lambda: kww.pack_canonical_keys_wide_plain(reads, 63)),
        bound_ms=bound_ms(nbytes(reads, *kww.pack_canonical_keys_wide(reads,
                                                                      63))),
        library_ms=None)
    stats["profiled"]["pack_canonical_keys_wide [4096, 256] k=63"] = (
        lambda: kww.pack_canonical_keys_wide(reads, 63))

    # K6: a 2^24-lane table (3/4 live, k=63 keys: hi below 2^62) with
    # 2^24 sorted unit keys, half of them drawn from the table's keys, a
    # tenth flagged dead
    n = SIZES["merge"]
    rand = lambda m, top: torch.randint(0, top, (m,), device=dev, generator=g)
    rand_keys = lambda m: (rand(m, 1 << 62),
                           (rand(m, 1 << 62) << 2) | rand(m, 4))
    nl = 3 * n // 4
    hi, lo = rand_keys(nl)
    order = u128.argsort(hi, lo)
    live_hi, live_lo = hi[order], lo[order]
    pad = torch.full((n - nl,), -1, device=dev, dtype=torch.int64)
    a_keys = u128.split_planes(torch.cat([live_hi, pad]),
                               torch.cat([live_lo, pad]))
    a_w = torch.where(torch.arange(n, device=dev) < nl,
                      rand(n, 1000).to(torch.int32) + 1, 0)
    pick = rand(n // 2, nl)
    r_hi, r_lo = rand_keys(n - n // 2)
    b_hi = torch.cat([live_hi[pick], r_hi])
    b_lo = torch.cat([live_lo[pick], r_lo])
    dead = torch.rand(n, device=dev, generator=g) < 0.1
    b_hi = torch.where(dead, u64.SIGN_BIT, b_hi)
    b_lo = torch.where(dead, 0, b_lo)
    order = u128.argsort(b_hi, b_lo)
    b_keys = u128.split_planes(b_hi[order], b_lo[order])
    flat = lambda out: out[0] + (out[1],)
    res["merge_sorted_wide"] = dict(
        max_abs_err=max_abs_err(
            flat(kmerge.merge_sorted_wide(a_keys, a_w, b_keys)),
            flat(kmerge.merge_sorted_wide_plain(a_keys, a_w, b_keys))),
        ms=time_ms(lambda: kmerge.merge_sorted_wide(a_keys, a_w, b_keys)),
        plain_ms=time_ms(
            lambda: kmerge.merge_sorted_wide_plain(a_keys, a_w, b_keys)),
        bound_ms=bound_ms(nbytes(*a_keys, a_w, *b_keys, *flat(
            kmerge.merge_sorted_wide(a_keys, a_w, b_keys)))),
        library_ms=None)


def run_cli(argv) -> tuple:
    """(exit code, stdout, stderr) of the port's CLI, in this process."""
    from kmers_tpu_torch.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def independent_count(fastq: str, k: int, batch: int, length: int):
    """torch.unique over the plain windows' valid canonical keys: int64
    words for k <= 32, [n, 2] rows of (hi, lo) for k > 32; every word's
    sign bit flipped, so that the signed order is the keys' unsigned
    one (a k = 32 key may carry bit 63, a k = 64 key bit 127)."""
    import numpy as np
    import torch

    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.ops import kmer

    keys = []
    for words, vbits in fastx.read_packed_batches(fastq, k=k, batch=batch,
                                                  length=length):
        w = torch.from_numpy(words.view(np.int32)).to(DEVICE)
        v = torch.from_numpy(vbits.view(np.int32)).to(DEVICE)
        if k <= 32:
            keys.append(valid_keys(kmer.kmer_windows_packed(w, v, k)))
        else:
            keys.append(valid_keys(kmer.kmer_windows_packed_wide(w, v, k)))
    return unique_count(keys)


def valid_keys(win):
    """The valid canonical keys of plain windows, each word's sign bit
    flipped: int64 words, or [n, 2] rows of (hi, lo) for 128-bit keys."""
    import torch

    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.ops import kmer

    if isinstance(win.fw, tuple):
        hi, lo = kmer.canonical_word_wide(win.fw, win.rc)
        return u64.to_unsigned_order(
            torch.stack([hi[win.valid], lo[win.valid]], 1))
    return u64.to_unsigned_order(kmer.canonical_word(win.fw, win.rc)[
        win.valid])


def unique_count(keys: list):
    """torch.unique over valid_keys' chunks: (keys sorted as unsigned, in
    table_keys' form, counts)."""
    import torch

    from kmers_tpu_torch.core import u64

    cat = torch.cat(keys)
    words, counts = torch.unique(cat, dim=0 if cat.dim() == 2 else None,
                                 return_counts=True)
    return u64.to_unsigned_order(words), counts


def table_keys(table):
    """A loaded table's live keys in independent_count's form."""
    import torch

    from kmers_tpu_torch.core import u64, u128

    live = [p[:table.n_unique] for p in table.keys]
    if len(live) == 2:
        return u64.join_planes(*live)
    return torch.stack(u128.join_planes(*live), 1)


# k -> (kernels the packed count must launch, the --ascii-ingest run's
# window kernel): unit batches at k <= 31 and 33 <= k <= 63; k = 32 and
# k = 64 count through the run-length tables, torch sorts only
E2E_KERNELS = {31: (("pack_canonical_keys_packed", "merge_sorted",
                     "compress_flagged"), "pack_canonical_keys"),
               63: (("merge_sorted_wide", "compress_flagged"),
                    "pack_canonical_keys_wide"),
               32: ((), None), 64: ((), None)}


def phase_end_to_end(stats: dict, seed: int, workdir: str, k: int,
                     phase: int) -> None:
    """`count -k k` on the 1M-read set, and the 100k-read ASCII run."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.io import simulate
    from kmers_tpu_torch.parallel.stream import StreamingCounter, npz_digest

    sim = dict(genome_len=SIZES["genome"], read_len=150, sub_rate=1e-3,
               n_rate=1e-4, seed=seed)
    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    small = os.path.join(workdir, "ecoli_100k.fastq")
    if "bases" not in stats:
        t0 = time.time()
        stats["bases"] = simulate.write_fastq(fastq, n_reads=SIZES["reads"],
                                              **sim)
        stats["gen_s"] = time.time() - t0
        simulate.write_fastq(small, n_reads=SIZES["short_reads"], **sim)
    bases = stats["bases"]
    out = os.path.join(workdir, f"ecoli_1m_k{k}.npz")
    count_args = ["-k", str(k), "--capacity", "16777216", "--batch", "4096",
                  "--length", "256", "--device", DEVICE]
    needed, ascii_window = E2E_KERNELS[k]

    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    rc, _, err = run_cli(["count", fastq, "-o", out] + count_args)
    sync()
    wall = time.time() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"count -k {k} exited {rc}:\n{err}")
    for name in needed:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the k={k} "
                                 "main path")

    sc = StreamingCounter.load(out, device=DEVICE)
    nu = sc.table.n_unique
    got_keys = table_keys(sc.table)
    got_counts = sc.table.counts[:nu].to(torch.int64)
    want_keys, want_counts = independent_count(fastq, k, 4096, 256)
    if not (torch.equal(got_keys, want_keys)
            and torch.equal(got_counts, want_counts)):
        raise AssertionError(
            f"k={k} table differs from the independent count: {nu} vs "
            f"{want_keys.shape[0]} keys")
    if sc.kmers != int(want_counts.sum()):
        raise AssertionError(f"kmers {sc.kmers} != {int(want_counts.sum())}")

    # the shorter ASCII-ingest run launches the ASCII window kernel and
    # gives the packed run's table
    p_out = os.path.join(workdir, f"ecoli_100k_k{k}_packed.npz")
    a_out = os.path.join(workdir, f"ecoli_100k_k{k}_ascii.npz")
    t0 = time.time()
    rc_p, _, err_p = run_cli(["count", small, "-o", p_out] + count_args)
    sync()
    wall_p = time.time() - t0
    kernels.reset_launch_counts()
    t0 = time.time()
    rc_a, _, err_a = run_cli(["count", small, "-o", a_out, "--ascii-ingest"]
                             + count_args)
    sync()
    wall_a = time.time() - t0
    ascii_launches = kernels.launch_counts()
    if rc_p or rc_a:
        raise AssertionError(f"100k runs exited {rc_p}, {rc_a}:\n{err_p}{err_a}")
    if ascii_window and ascii_launches[ascii_window] == 0:
        raise AssertionError(f"{ascii_window} was not launched by "
                             "--ascii-ingest")
    if npz_digest(p_out) != npz_digest(a_out):
        raise AssertionError(f"k={k} --ascii-ingest table differs from packed")
    stats["launches"].update((n, launches[n]) for n in needed
                             if n not in stats["launches"])
    if ascii_window:
        stats["launches"][ascii_window] = ascii_launches[ascii_window]
    stats[f"e2e_k{k}"] = dict(wall_s=wall, kmers=sc.kmers, distinct=nu,
                              kmers_per_s=sc.kmers / wall, peak_bytes=peak,
                              reads=SIZES["reads"], bases=bases,
                              launches=launches, short_packed_wall_s=wall_p,
                              short_ascii_wall_s=wall_a)
    say(f"phase {phase} end to end k={k}: {bases} bases, "
        f"{sc.kmers} kmers, {nu} distinct in {wall:.3f}s = "
        f"{sc.kmers / wall:.4g} kmers/s, peak device memory "
        f"{peak / 2**20:.1f} MiB; table == torch.unique count; launches "
        f"{ {n: c for n, c in launches.items() if c} }; 100k reads: packed "
        f"{wall_p:.3f}s, --ascii-ingest {wall_a:.3f}s, table == packed"
        + (f" ({ascii_window} {ascii_launches[ascii_window]})"
           if ascii_window else ""))


def phase_ablation_packed(stats: dict, workdir: str) -> None:
    """Phase 3b: the packed ingest's arm of the roofline ablation (K1 at
    stage "pack", the forward words, beside stage "canon").  Phase 3's
    1M reads as packed [4096, 256] batches on the card; one pass of K1 at
    stage "pack" gives its launch count (the counts set to 0 just before
    and read just after), then the walls of whole passes at each stage,
    in turns (pack, canon, canon, pack)."""
    import numpy as np
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.kernels import window as kwin

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    batches = [tuple(torch.from_numpy(a.view(np.int32)).to(DEVICE)
                     for a in wv)
               for wv in fastx.read_packed_batches(fastq, k=31, batch=4096,
                                                   length=256)]
    lanes = sum(w.shape[0] * w.shape[1] * 16 for w, _ in batches)
    walls = {"pack": [], "canon": []}
    for i, stage in enumerate(("pack", "canon", "canon", "pack")):
        sync()
        if i == 0:
            kernels.reset_launch_counts()
        t0 = time.time()
        for w, v in batches:
            kwin.pack_canonical_keys_packed(w, v, 31, stage)
        sync()
        walls[stage].append(time.time() - t0)
        if i == 0:
            launched = kernels.launch_counts()
    name = "pack_canonical_keys_packed[pack]"
    if launched[name] != len(batches) or launched[
            "pack_canonical_keys_packed"]:
        raise AssertionError(f"the pack pass launched {launched}")
    stats["launches"][name] = launched[name]
    stats["ablation_packed"] = dict(batches=len(batches), lanes=lanes,
                                    walls_s=walls)
    say(f"phase 3b packed ablation arm: {len(batches)} batches of phase 3's "
        f"reads, {lanes} lanes, K1 k=31 whole-pass walls (pack, canon, "
        f"canon, pack): stage pack {walls['pack'][0]:.4f} / "
        f"{walls['pack'][1]:.4f} s, stage canon {walls['canon'][0]:.4f} / "
        f"{walls['canon'][1]:.4f} s; launches {name} {launched[name]}")


def phase_reference(stats: dict, workdir: str, ks=(31, 63),
                    phase: int = 5) -> None:
    """The smoke count's digest (pinned to kmers_tpu's table), an evicting
    run equal to the CPU's, stats and query on the card and the CPU."""
    from kmers_tpu_torch import smoke
    from kmers_tpu_torch.parallel.stream import npz_digest

    fastq = smoke.write_smoke_input(os.path.join(workdir, "smoke.fastq"))
    notes = []
    for k in ks:
        digest = smoke.SMOKE_DIGESTS[k]
        out = os.path.join(workdir, f"smoke_k{k}_gpu.npz")
        rc, _, err = run_cli(smoke.smoke_count_args(fastq, out, k)
                             + ["--device", DEVICE])
        if rc != 0 or npz_digest(out) != digest:
            raise AssertionError(f"k={k} smoke count rc {rc}, digest "
                                 f"{npz_digest(out)} != {digest}\n{err}")

        evict = {}
        for device in (DEVICE, "cpu"):
            path = os.path.join(workdir, f"smoke_k{k}_evict_{device}.npz")
            argv = smoke.smoke_count_args(fastq, path, k) + [
                "--capacity", "4096", "--merge-every", "2", "--device", device]
            rc, _, err = run_cli(argv)
            if rc != 3 or "dropped" not in err:
                raise AssertionError(f"k={k} evicting run on {device}: "
                                     f"rc {rc}\n{err}")
            evict[device] = (npz_digest(path), run_cli(
                ["stats", path, "--device", device])[1])
        if evict[DEVICE] != evict["cpu"]:
            raise AssertionError(f"k={k} evicting run differs between cuda "
                                 "and cpu")

        rc, stats_gpu, _ = run_cli(["stats", out, "--device", DEVICE])
        _, stats_cpu, _ = run_cli(["stats", out, "--device", "cpu"])
        queries = _top_and_absent_queries(out)
        rq, q_gpu, _ = run_cli(["query", out] + queries + ["--device", DEVICE])
        _, q_cpu, _ = run_cli(["query", out] + queries + ["--device", "cpu"])
        if rc or rq or stats_gpu != stats_cpu or q_gpu != q_cpu:
            raise AssertionError(f"k={k} stats/query differ:\n{stats_gpu}"
                                 f"{stats_cpu}{q_gpu}{q_cpu}")
        top_count = int(q_gpu.splitlines()[0].split("\t")[1])
        if top_count <= 0:
            raise AssertionError(f"k={k}: the top k-mer counts {top_count}")
        dropped = [ln for ln in evict[DEVICE][1].splitlines()
                   if ln.startswith("dropped")]
        notes.append(f"k={k}: smoke digest == {digest[:16]}...; evicting "
                     f"run exit 3 ({dropped[0]}) == cpu; stats and query "
                     f"agree (top k-mer count {top_count})")
    say(f"phase {phase} reference: " + "; ".join(notes))


def phase_minimizer(stats: dict, seed: int) -> None:
    """K9 against its plain version on every lane, then timed."""
    import numpy as np
    import torch

    from kmers_tpu_torch.kernels import minimizer as kmin

    rs = np.random.RandomState(seed + 9)
    reads = seeded_reads(rs, *SIZES["hash"])
    odd = seeded_reads(rs, 333, 999)
    err = 0
    for batch in (reads, odd):
        r = torch.from_numpy(batch).to(DEVICE)
        for order in kmin.ORDERS:
            for k, w in ((31, 11), (21, 7), (18, 4), (16, 5), (31, 31),
                         (5, 3)):
                err = max(err, max_abs_err(
                    kmin.minimizer_kernel(r, k, w, seed, order),
                    kmin.minimizer_kernel_plain(r, k, w, seed, order)))
    # the shapes phase 7's minimizer runs give K9: one shard's rows of a
    # [4096, 256] batch at D = 1 and D = 4, k=31 w=11 mix16, seed 0; timed
    # there too
    batch, length = SIZES["window"]
    main_shapes = [(batch // shards, length) for p, shards, _ in SHARDED_RUNS
                   if p == "minimizer"]
    shape_times = {}
    for shape in main_shapes:
        r = torch.from_numpy(seeded_reads(rs, *shape)).to(DEVICE)
        run = lambda: kmin.minimizer_kernel(r, 31, 11, 0, "mix16")
        plain = lambda: kmin.minimizer_kernel_plain(r, 31, 11, 0, "mix16")
        err = max(err, max_abs_err(run(), plain()))
        shape_times[shape] = (time_ms(run), time_ms(plain),
                              bound_ms(nbytes(r, *run())))
    if err:
        raise AssertionError(f"minimizer_kernel differs from its plain "
                             f"version (max_abs_err {err})")
    r = torch.from_numpy(reads).to(DEVICE)
    stats["kernels"]["minimizer_kernel"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: kmin.minimizer_kernel(r, 31, 11, order="mix16")),
        plain_ms=time_ms(
            lambda: kmin.minimizer_kernel_plain(r, 31, 11, order="mix16")),
        bound_ms=bound_ms(nbytes(r, *kmin.minimizer_kernel(r, 31, 11,
                                                           order="mix16"))),
        library_ms=None)
    res = stats["kernels"]["minimizer_kernel"]
    say(f"phase 6 minimizer kernel: bit-exact vs plain for 4 orders x 6 "
        f"(k, w) at [{reads.shape[0]}, {reads.shape[1]}] and [333, 999], "
        f"k=31 w=11 mix16 at the sharded runs' {main_shapes}; k=31 w=11 "
        f"mix16 {res['ms']:.4f} ms (plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f}); " + "; ".join(
            f"[{b}, {l}] {t[0]:.4f} ms (plain {t[1]:.3f}, bound {t[2]:.4f})"
            for (b, l), t in shape_times.items()))


def phase_sharded(stats: dict, workdir: str) -> None:
    """ShardedStreamingCounter on the 1M-read set, four configurations;
    each table must be phase 3's single-device table."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.parallel.mesh import make_mesh
    from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                                 auto_merge_every,
                                                 count_fastx, npz_digest,
                                                 pending_table_lanes)

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    want = npz_digest(os.path.join(workdir, "ecoli_1m_k31.npz"))
    capacity, batch, length = 1 << 24, 4096, 256
    k9 = 0
    for partition, shards, route_capacity in SHARDED_RUNS:
        merge_every = auto_merge_every(capacity, pending_table_lanes(
            batch, length, devices=shards, route_capacity=route_capacity,
            partition=partition, k=31, minimizer_w=11))
        out = os.path.join(workdir, f"ecoli_1m_{partition}_d{shards}.npz")
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        sc = ShardedStreamingCounter(
            31, capacity, merge_every=merge_every,
            mesh=make_mesh(devices=[DEVICE] * shards),
            route_capacity=route_capacity, partition=partition,
            minimizer_w=11)
        count_fastx(fastq, 31, capacity, device=DEVICE, batch=batch,
                    length=length, counter=sc)
        sc.save(out)
        sync()
        wall = time.time() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        name = f"sharded_{partition}_d{shards}"
        if sc.route_overflow:
            raise AssertionError(f"{name}: route_overflow {sc.route_overflow}")
        if npz_digest(out) != want:
            raise AssertionError(f"{name}: table differs from the "
                                 "single-device count")
        needed = ["merge_sorted", "compress_flagged"] + (
            ["minimizer_kernel"] if partition == "minimizer" else [])
        for kernel in needed:
            if launches[kernel] == 0:
                raise AssertionError(f"{name}: {kernel} was not launched")
        k9 += launches["minimizer_kernel"]
        stats[name] = dict(wall_s=wall, kmers=sc.kmers,
                           kmers_per_s=sc.kmers / wall,
                           superkmers=sc.route_superkmers,
                           route_bytes=sc.route_bytes,
                           route_capacity=route_capacity,
                           merge_every=merge_every, peak_bytes=peak,
                           launches=launches)
        say(f"phase 7 {name}: {sc.kmers} kmers in {wall:.3f}s = "
            f"{sc.kmers / wall:.4g} kmers/s, route_capacity "
            f"{route_capacity}, merge_every {merge_every}, superkmers "
            f"{sc.route_superkmers}, route_bytes {sc.route_bytes}, peak "
            f"device memory {peak / 2**20:.1f} MiB, overflow 0, table == "
            f"single-device; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
    stats["launches"]["minimizer_kernel"] = k9


def _shard_sort_keys(fastq: str) -> tuple:
    """The (hi, lo) planes phase 11 gives K11 for one shard: the first
    packed batch through make_sharded_counter, caught at the wrapper."""
    import numpy as np
    import torch

    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.kernels import sort as ksort
    from kmers_tpu_torch.parallel import pipeline
    from kmers_tpu_torch.parallel.mesh import make_mesh

    shards, route_capacity = SHARDED_COMPACT
    step = pipeline.make_sharded_counter(
        make_mesh(devices=[DEVICE] * shards), 31,
        route_capacity=route_capacity, packed=True)
    wv = next(iter(fastx.read_packed_batches(fastq, k=31, batch=4096,
                                             length=256)))
    with caught_args(ksort, "radix_sort_u64") as caught:
        step(*(torch.from_numpy(a.view(np.int32)).to(DEVICE) for a in wv))
    return caught[0]


def phase_sort_kernels(stats: dict, seed: int, workdir: str) -> dict:
    """Phase 8: K10 (narrow and wide) and K11 bit for bit against their
    plain versions, on the keys the count forms give them: a [4096, 256]
    batch's folded canonical keys at k=31 and k=63 (2^20 lanes, and the
    first 1,000,003 of them, off the block size; K10 at every segment size
    one thread block sorts, 8-4096 lanes, and at 8192, 16384 and 65536
    through the merge rounds, also at 2^20 - 1,000 lanes and at blocks of
    twice the segment; timed at 64 and 1024 lanes and at the three large
    sizes), the compact form's sort keys at k=31 (2^20), one phase-11
    shard's keys (2^18), and 2^24 and 1,000,003 seeded 64-bit keys with
    duplicates and flagged lanes; median times, and torch.sort's for K11.
    Returns K11's inputs by label."""
    import numpy as np
    import torch

    from kmers_tpu_torch.core import u64, u128
    from kmers_tpu_torch.kernels import count_tile as kct
    from kmers_tpu_torch.kernels import sort as ksort
    from kmers_tpu_torch.parallel import pipeline

    rs = np.random.RandomState(seed + 8)
    res = stats["kernels"]
    reads = torch.from_numpy(seeded_reads(rs, *SIZES["window"])).to(DEVICE)
    canon, valid = pipeline.canonical_kmers(reads, 31)
    canon, valid = canon.reshape(-1), valid.reshape(-1)
    (whi, wlo), wvalid = pipeline.canonical_kmers_wide(reads, 63)
    odd = SIZES["odd"]
    one_block = [1 << i for i in range(3, kct.SEG_LANES_MAX.bit_length())]
    notes = []
    for name, fn, planes in (
            ("segment_count_keys", kct.segment_count_keys,
             u64.fold_invalid(canon, valid)),
            ("segment_count_keys_wide", kct.segment_count_keys_wide,
             u128.fold_invalid(whi.reshape(-1), wlo.reshape(-1),
                               wvalid.reshape(-1)))):
        # (seg, n, block_lanes): every size one block sorts at 2^20 lanes
        # and 1,000,003; the merge rounds' sizes at 2^20 and 2^20 - 1,000,
        # at blocks of max(seg, 2^14) and of 2 seg
        n = planes[0].shape[0]
        cases = [(seg, m, 1 << 14) for seg in one_block for m in (n, odd)]
        cases += [(seg, m, blk) for seg in LARGE_SEGMENTS
                  for m in (n, n - 1000)
                  for blk in (max(seg, 1 << 14), 2 * seg)]
        err = 0
        for seg, m, blk in cases:
            ps = tuple(p[:m] for p in planes)
            err = max(err, max_abs_err(fn(*ps, seg_lanes=seg,
                                          block_lanes=blk),
                                       kct.segment_count_plain(ps, seg, blk)))
        times = {}
        for seg in (64, 1024) + LARGE_SEGMENTS:
            blk = max(seg, 1 << 14)
            run = lambda: fn(*planes, seg_lanes=seg, block_lanes=blk)
            times[seg] = (time_ms(run), time_ms(
                lambda: kct.segment_count_plain(planes, seg, blk)),
                bound_ms(nbytes(*planes, *run())))
        stats["profiled"][f"{name} seg 64"] = (
            lambda fn=fn, planes=planes: fn(*planes, seg_lanes=64,
                                             block_lanes=1 << 14))
        ms, plain_ms, bound = times[64]
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, library_ms=None, sizes=times)
        sizes = one_block + list(LARGE_SEGMENTS)
        notes.append(f"{name} [{n}] seg_lanes {sizes} ({len(cases)} "
                     "cases); " + ", ".join(
                         f"seg {seg} {t[0]:.4f} ms (plain {t[1]:.3f}, bound "
                         f"{t[2]:.4f})" for seg, t in times.items()))

    # K11: the compact batch's sort keys (word | invalid flag), then 2^24
    # seeded keys below 2^62, a quarter duplicated, a tenth flagged
    key = canon | torch.where(valid, 0, u64.SIGN_BIT)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = SIZES["sort_big"]
    big = torch.randint(0, 1 << 62, (n,), device=DEVICE, generator=g)
    big[: n // 4] = big[n // 2: n // 2 + n // 4]
    big = torch.where(torch.rand(n, device=DEVICE, generator=g) < 0.1,
                      big | u64.SIGN_BIT, big)
    inputs = {"shard": _shard_sort_keys(os.path.join(workdir,
                                                     "ecoli_1m.fastq")),
              "2^20": u64.split_word(key), "2^24": u64.split_word(big),
              str(odd): u64.split_word(big[:odd])}
    times = {}
    err = 0
    for label, (hi, lo) in inputs.items():
        err = max(err, max_abs_err(ksort.radix_sort_u64(hi, lo),
                                   ksort.radix_sort_u64_plain(hi, lo)))
        flipped = u64.to_unsigned_order(u64.join_planes(hi, lo))
        times[label] = (time_ms(lambda: ksort.radix_sort_u64(hi, lo)),
                        time_ms(lambda: ksort.radix_sort_u64_plain(hi, lo)),
                        time_ms(lambda: torch.sort(flipped)),
                        bound_ms(2 * nbytes(hi, lo)))
    ms, plain_ms, library_ms, bound = times["2^20"]
    res["radix_sort_u64"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, library_ms=library_ms,
                                 sizes=times)
    for name in ("segment_count_keys", "segment_count_keys_wide",
                 "radix_sort_u64"):
        if res[name]["max_abs_err"]:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max_abs_err "
                                 f"{res[name]['max_abs_err']})")
    notes += [f"radix_sort_u64 [{label}: {inputs[label][0].shape[0]}] "
              f"{t[0]:.4f} ms (plain {t[1]:.3f}, torch.sort {t[2]:.4f}, "
              f"bound {t[3]:.4f})" for label, t in times.items()]
    say("phase 8 sort kernels: bit-exact vs plain; " + "; ".join(notes))
    return inputs


def phase_sort_call(inputs: dict) -> None:
    """Phase 12: one K11 call on phase 8's 2^20 compact keys.  The host
    must return from it while a queued sleep of ~50 ms still runs (a host
    sync anywhere in the call, torch's or the library's, would wait for
    the sleep); torch's sync debug mode must see no sync; torch.profiler
    lists the device operations it queues.  Then the device time of each
    of its kernels at every size of phase 8."""
    import torch

    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.kernels import sort as ksort

    hi, lo = inputs["2^20"]
    ksort.radix_sort_u64(hi, lo)
    sync()
    torch.cuda._sleep(100_000_000)
    queued = torch.cuda.Event()
    queued.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ksort.radix_sort_u64(hi, lo)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    waited = queued.query()
    sync()
    if waited:
        raise AssertionError("radix_sort_u64: the host waited for the card")
    word = u64.join_planes(hi, lo)
    digits = [u64.shr(word, 8 * p) & 0xFF for p in range(8)]
    differ = sum(bool((d != d[0]).any()) for d in digits)
    profiles = {label: _device_ops(lambda: ksort.radix_sort_u64(*planes))
                for label, planes in inputs.items()}
    queued_ops = {name: n for name, (n, _) in profiles["2^20"].items()}
    say(f"phase 12 K11 call [2^20]: the host returned while a queued sleep "
        f"still ran (no host sync; torch's sync debug mode saw none); device "
        f"operations {queued_ops or 'not seen by torch.profiler'}; "
        f"{8 + 16 * differ} B a key of keys moved ({differ} of 8 digits "
        f"differ); device time by kernel: " + "; ".join(
            f"[{label}] " + ", ".join(f"{name} {n}x {us / 1e3:.4f} ms"
                                      for name, (n, us) in ops.items())
            for label, ops in profiles.items()))


def _device_ops(fn) -> dict:
    """{kernel name or "memset": (count, device us)} of one fn() call,
    from torch.profiler, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = ("memset" if "memset" in e.name.lower()
                    else e.name.split("(")[0].split("<")[0])
            n, us = ops.get(name, (0, 0.0))
            ops[name] = (n + 1, us + e.time_range.elapsed_us())
    return ops


def phase_profiled(stats: dict) -> None:
    """Phase 12, last: the device time of one call of K1 (both stages), K2 at k=31, K7
    and K8 at k=63, K10 at seg 64, K4 at 2^25 lanes, K3 with idx at
    2^24 + 2^24 and phase 13's (b) and (c) lookups at each arm, as
    torch.profiler records it over PROFILED_CALLS calls: the call's device
    operations alone (the six longest by name where there are several),
    without the few us that two CUDA events add to every time_ms
    sample."""
    def per_call(label, fn) -> str:
        # a profile now and then comes back empty: try up to three times
        for _ in range(3):
            ops = _device_ops(lambda: [fn() for _ in range(PROFILED_CALLS)])
            if ops:
                break
        else:
            raise AssertionError(f"{label}: torch.profiler saw no device "
                                 "operation in three profiles")
        ms = sorted(((us / PROFILED_CALLS / 1e3, name, n / PROFILED_CALLS)
                     for name, (n, us) in ops.items()), reverse=True)
        parts = (" (" + ", ".join(f"{name} {n:g}x {t:.5f}"
                                  for t, name, n in ms[:6])
                 + (f", {len(ms) - 6} more" if len(ms) > 6 else "")
                 + ")") if len(ms) > 1 else ""
        return f"{sum(t for t, _, _ in ms):.5f} ms{parts}"

    say("phase 12 profiler device time a call: " + "; ".join(
        f"{label} {per_call(label, fn)}"
        for label, fn in stats["profiled"].items()))


def _fold_batches(batches, count, merge, empty, capacity: int, k: int,
                  merge_every: int = 16):
    """Fold per-batch tables into one with `merge` every `merge_every`
    batches; returns (table, batches, kmers, dropped distinct)."""
    table, pending, n, kmers, dropped = empty, [], 0, 0, 0
    for batch in batches:
        res = count(batch)
        pending.append(res.table)
        kmers += int(res.metrics["kmers_emitted"])
        n += 1
        if len(pending) == merge_every:
            table, du, _ = merge(table, pending, capacity, max_k=k)
            dropped += du
            pending = []
    if pending:
        table, du, _ = merge(table, pending, capacity, max_k=k)
        dropped += du
    return table, n, kmers, dropped


def _same_table(got, want) -> bool:
    import torch

    return (got.n_unique == want.n_unique
            and torch.equal(table_keys(got), table_keys(want))
            and torch.equal(got.counts[:got.n_unique],
                            want.counts[:want.n_unique]))


def phase_count_forms(stats: dict, workdir: str) -> None:
    """Phase 9: the 1M-read set through count_reads(_wide)'s counted forms,
    and through count_words_segmented(_wide) at LARGE_SEGMENTS[0] lanes,
    each batch's table folded with _merge_bounded(_wide) every 16 batches
    at capacity 2^24; each table must be phase 3's / phase 4's, and each
    run must launch its kernel (K11 for the compact form, K10 narrow and
    wide for the run-length forms, at 64-lane segments and through the
    merge rounds)."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.parallel import count as count_ops
    from kmers_tpu_torch.parallel import pipeline, stream

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    capacity, batch, length = 1 << 24, 4096, 256
    seg = LARGE_SEGMENTS[0]
    runs = (("compact", 31, True, "radix_sort_u64"),
            ("runlength", 31, False, "segment_count_keys"),
            ("runlength", 63, False, "segment_count_keys_wide"),
            (f"segmented{seg}", 31, None, "segment_count_keys"),
            (f"segmented{seg}", 63, None, "segment_count_keys_wide"))

    def segmented(r, k, compact=None):
        """count_words_segmented(_wide) at seg lanes: K10's merge rounds."""
        if k > 32:
            words, valid = pipeline.canonical_kmers_wide(r, k)
            table = count_ops.count_words_segmented_wide(words, valid,
                                                         seg_lanes=seg)
        else:
            words, valid = pipeline.canonical_kmers(r, k)
            table = count_ops.count_words_segmented(words, valid,
                                                    seg_lanes=seg)
        return types.SimpleNamespace(
            table=table, metrics={"kmers_emitted": valid.sum()})

    for form, k, compact, kernel in runs:
        wide = k > 32
        count = (segmented if compact is None else pipeline.count_reads_wide
                 if wide else pipeline.count_reads)
        empty = (count_ops.empty_table_wide if wide
                 else count_ops.empty_table)(capacity, DEVICE)
        merge = stream._merge_bounded_wide if wide else stream._merge_bounded
        rows = fastx.prefetch(fastx.read_kmer_batches(fastq, k=k, batch=batch,
                                                      length=length))
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        table, n, kmers, dropped = _fold_batches(
            (torch.from_numpy(r).to(DEVICE) for r in rows),
            lambda r: count(r, k, compact=compact), merge, empty, capacity, k)
        sync()
        wall = time.time() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        name = f"forms_{form}_k{k}"
        ref = stream.StreamingCounter.load(
            os.path.join(workdir, f"ecoli_1m_k{k}.npz"), device=DEVICE)
        if dropped or not _same_table(table, ref.table) or kmers != ref.kmers:
            raise AssertionError(f"{name}: table differs from phase "
                                 f"{4 if wide else 3}'s")
        if launches[kernel] == 0:
            raise AssertionError(f"{name}: {kernel} was not launched")
        stats["launches"][kernel] = (stats["launches"].get(kernel, 0)
                                     + launches[kernel])
        stats[name] = dict(wall_s=wall, batches=n, kmers=kmers,
                           kmers_per_s=kmers / wall, peak_bytes=peak,
                           launches=launches)
        say(f"phase 9 {name}: {n} batches, {kmers} kmers in {wall:.3f}s = "
            f"{kmers / wall:.4g} kmers/s, peak device memory "
            f"{peak / 2**20:.1f} MiB; table == phase {4 if wide else 3}'s; "
            f"launches { {m: c for m, c in launches.items() if c} }")


def phase_sharded_compact(stats: dict, workdir: str) -> None:
    """Phase 11: four shards on the one card.  make_sharded_counter's
    compact per-shard tables over the 1M-read set (packed), each batch's
    global_table folded as in phase 9, must give phase 3's table; and
    make_sharded_minimizer_counter (k=31, w=11) on one [4096, 256] batch
    must give an independent count of its minimizer words.  Both launch
    K11 (each shard's count_words) and route without overflow."""
    import numpy as np
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.ops import hash as hash_ops
    from kmers_tpu_torch.ops import minimizer as mini_ops
    from kmers_tpu_torch.parallel import count as count_ops
    from kmers_tpu_torch.parallel import pipeline, stream
    from kmers_tpu_torch.parallel.mesh import make_mesh

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    capacity, batch, length = 1 << 24, 4096, 256
    shards, route_capacity = SHARDED_COMPACT
    mesh = make_mesh(devices=[DEVICE] * shards)
    step = pipeline.make_sharded_counter(mesh, 31,
                                         route_capacity=route_capacity,
                                         packed=True)
    overflow = []

    def count(wv):
        res = step(*(torch.from_numpy(a.view(np.int32)).to(DEVICE)
                     for a in wv))
        overflow.append(res.metrics["route_overflow"])
        return pipeline.CountResult(pipeline.global_table(res), res.metrics)

    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    table, n, kmers, dropped = _fold_batches(
        fastx.prefetch(fastx.read_packed_batches(fastq, k=31, batch=batch,
                                                 length=length)),
        count, stream._merge_bounded, count_ops.empty_table(capacity, DEVICE),
        capacity, 31)
    sync()
    wall = time.time() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ref = stream.StreamingCounter.load(
        os.path.join(workdir, "ecoli_1m_k31.npz"), device=DEVICE)
    if int(sum(int(o) for o in overflow)) or dropped:
        raise AssertionError("sharded compact: routing overflow or drops")
    if not _same_table(table, ref.table) or kmers != ref.kmers:
        raise AssertionError("sharded compact: table differs from phase 3's")
    if launches["radix_sort_u64"] == 0:
        raise AssertionError("sharded compact: radix_sort_u64 not launched")
    stats["sharded_compact_d4"] = dict(wall_s=wall, kmers=kmers,
                                       kmers_per_s=kmers / wall,
                                       peak_bytes=peak, launches=launches)

    rows = next(iter(fastx.read_kmer_batches(fastq, k=31, batch=batch,
                                             length=length)))
    reads = torch.from_numpy(rows).to(DEVICE)
    mstep = pipeline.make_sharded_minimizer_counter(
        mesh, 31, 11, route_capacity=1 << 16, route_passes=2)
    sync()
    kernels.reset_launch_counts()
    res = mstep(reads)
    got = pipeline.global_table(res)
    sync()
    m_launches = kernels.launch_counts()
    mm = mini_ops.minimizer_stream(reads, 31, 11, hash_ops.mix_hash_fn(0))
    keys, counts = torch.unique(u64.to_unsigned_order(mm.word[mm.valid]),
                                return_counts=True)
    nu = got.n_unique
    if (int(res.metrics["route_overflow"]) or nu != keys.shape[0]
            or not torch.equal(u64.to_unsigned_order(table_keys(got)), keys)
            or not torch.equal(got.counts[:nu].to(torch.int64), counts)):
        raise AssertionError("sharded minimizer counter differs from the "
                             "independent count of its minimizer words")
    if m_launches["radix_sort_u64"] == 0:
        raise AssertionError("sharded minimizer counter: radix_sort_u64 not "
                             "launched")
    stats["launches"]["radix_sort_u64"] += (launches["radix_sort_u64"]
                                            + m_launches["radix_sort_u64"])
    say(f"phase 11 sharded compact, {shards} shards on one card: "
        f"make_sharded_counter {kmers} kmers in {wall:.3f}s = "
        f"{kmers / wall:.4g} kmers/s, peak {peak / 2**20:.1f} MiB, overflow "
        f"0, table == phase 3's, launches "
        f"{ {m: c for m, c in launches.items() if c} }; "
        f"make_sharded_minimizer_counter k=31 w=11: {nu} minimizer words "
        f"({int(counts.sum())} kmers) == independent count, launches "
        f"{ {m: c for m, c in m_launches.items() if c} }")


def phase_sharded_wide(stats: dict, workdir: str, seed: int) -> None:
    """Phase 14, four shards on the one card.  ShardedStreamingCounter
    (hash partition) over the 1M-read set at k = 32, 63 and 64 must save
    phase 10's / phase 4's single-device table (npz_digest) with no
    routing overflow and route_bytes of 9 B (k = 32) or 17 B (128-bit
    keys) a received lane; the k = 63 run, whose pending shard tables
    are UnitTableWide, must launch K6 and K4.  Then
    make_sequence_parallel_counter over the 4,641,652 bp genome the reads
    come from, Ns at and beside the three cuts, at k = 31 and 63: no
    overflow, the union of the shard tables (no key on two shards) equal
    to an independent torch.unique count of the whole sequence's plain
    windows, and K11 launched at k = 31 (each shard's compact table),
    where it is held against its plain version at a shard's keys."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.kernels import sort as ksort
    from kmers_tpu_torch.ops import kmer
    from kmers_tpu_torch.parallel import pipeline
    from kmers_tpu_torch.parallel.mesh import make_mesh
    from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                                 auto_merge_every,
                                                 count_fastx, npz_digest,
                                                 pending_table_lanes)

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    capacity, batch, length = 1 << 24, 4096, 256
    shards, route_capacity = (SHARDED_WIDE["shards"],
                              SHARDED_WIDE["route_capacity"])
    mesh = make_mesh(devices=[DEVICE] * shards)
    merge_every = auto_merge_every(capacity, pending_table_lanes(
        batch, length, devices=shards, route_capacity=route_capacity))
    for k in SHARDED_WIDE["ks"]:
        name = f"sharded_hash_d{shards}_k{k}"
        out = os.path.join(workdir, f"ecoli_1m_{name}.npz")
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        sc = ShardedStreamingCounter(k, capacity, merge_every=merge_every,
                                     mesh=mesh, route_capacity=route_capacity)
        count_fastx(fastq, k, capacity, device=DEVICE, batch=batch,
                    length=length, counter=sc)
        sc.save(out)
        sync()
        wall = time.time() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        lane_bytes = 17 if k > 32 else 9
        lanes = sc.batches * shards * shards * route_capacity
        if sc.route_overflow:
            raise AssertionError(f"{name}: route_overflow {sc.route_overflow}")
        if npz_digest(out) != npz_digest(
                os.path.join(workdir, f"ecoli_1m_k{k}.npz")):
            raise AssertionError(f"{name}: table differs from the "
                                 "single-device count")
        if sc.route_bytes != lanes * lane_bytes:
            raise AssertionError(f"{name}: route_bytes {sc.route_bytes} != "
                                 f"{lane_bytes} B x {lanes} received lanes")
        needed = ("merge_sorted_wide", "compress_flagged") if k == 63 else ()
        for kernel in needed:
            if launches[kernel] == 0:
                raise AssertionError(f"{name}: {kernel} was not launched")
            stats["launches"][kernel] += launches[kernel]
        stats[name] = dict(wall_s=wall, kmers=sc.kmers,
                           kmers_per_s=sc.kmers / wall,
                           route_bytes=sc.route_bytes,
                           route_capacity=route_capacity,
                           merge_every=merge_every, peak_bytes=peak,
                           launches=launches)
        say(f"phase 14 {name}: {sc.kmers} kmers in {wall:.3f}s = "
            f"{sc.kmers / wall:.4g} kmers/s, route_capacity "
            f"{route_capacity}, merge_every {merge_every}, route_bytes "
            f"{sc.route_bytes} ({lane_bytes} B x {lanes} lanes), peak "
            f"device memory {peak / 2**20:.1f} MiB, overflow 0, table == "
            f"single-device; launches "
            f"{ {n: c for n, c in launches.items() if c} }")

    g = SIZES["genome"]
    cut = g // shards
    seq_t = torch.from_numpy(seq_parallel_genome(seed, g)).to(DEVICE)
    route_capacity = seq_parallel_capacity(g)
    for k in SEQ_PARALLEL["ks"]:
        name = f"sequence_parallel_d{shards}_k{k}"
        step = pipeline.make_sequence_parallel_counter(
            mesh, k, route_capacity=route_capacity)
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        with caught_args(ksort, "radix_sort_u64") as caught:
            res = step(seq_t)
            sync()
        wall = time.time() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        emitted = int(res.metrics["kmers_emitted"])
        if int(res.metrics["route_overflow"]):
            raise AssertionError(f"{name}: route_overflow "
                                 f"{int(res.metrics['route_overflow'])}")
        # the union of the shard tables, each key once
        union = u64.to_unsigned_order(torch.cat(
            [table_keys(t) for t in res.table]))
        got, inverse = torch.unique(union, dim=0 if union.dim() == 2 else None,
                                    return_inverse=True)
        if got.shape[0] != union.shape[0]:
            raise AssertionError(f"{name}: {union.shape[0] - got.shape[0]} "
                                 "keys on two shards")
        got_counts = torch.zeros(got.shape[0], dtype=torch.int64,
                                 device=got.device).index_put_(
            (inverse,), torch.cat([t.counts[:t.n_unique]
                                   for t in res.table]).to(torch.int64))
        windows = kmer.kmer_windows_wide if k > 32 else kmer.kmer_windows
        want_keys, want_counts = unique_count(
            [valid_keys(windows(seq_t[None, :], k))])
        if not (torch.equal(u64.to_unsigned_order(got), want_keys)
                and torch.equal(got_counts, want_counts)
                and emitted == int(want_counts.sum())):
            raise AssertionError(
                f"{name}: shard tables differ from the independent count: "
                f"{got.shape[0]} vs {want_keys.shape[0]} keys")
        k11 = ""
        if k <= 31:
            if launches["radix_sort_u64"] == 0:
                raise AssertionError(f"{name}: radix_sort_u64 not launched")
            stats["launches"]["radix_sort_u64"] += launches["radix_sort_u64"]
            # K11 against its plain version at a shard's keys, timed
            hi, lo = caught[0]
            err = max_abs_err(ksort.radix_sort_u64(hi, lo),
                              ksort.radix_sort_u64_plain(hi, lo))
            if err:
                raise AssertionError(f"{name}: radix_sort_u64 differs from "
                                     f"its plain version ({err})")
            flipped = u64.to_unsigned_order(u64.join_planes(hi, lo))
            t = (time_ms(lambda: ksort.radix_sort_u64(hi, lo)),
                 time_ms(lambda: ksort.radix_sort_u64_plain(hi, lo)),
                 time_ms(lambda: torch.sort(flipped)),
                 bound_ms(2 * nbytes(hi, lo)))
            stats["kernels"]["radix_sort_u64"]["sizes"][name] = t
            k11 = (f"; radix_sort_u64 at a shard's {hi.shape[0]} keys "
                   f"bit-exact vs plain, {t[0]:.4f} ms (plain {t[1]:.3f}, "
                   f"torch.sort {t[2]:.4f}, bound {t[3]:.4f})")
        lane_bytes = 17 if k > 32 else 9
        route_bytes = shards * shards * route_capacity * lane_bytes
        stats[name] = dict(wall_s=wall, kmers=emitted,
                           kmers_per_s=emitted / wall,
                           route_bytes=route_bytes,
                           route_capacity=route_capacity, peak_bytes=peak,
                           launches=launches,
                           tables_digest=shard_tables_digest(res.table,
                                                             mesh))
        say(f"phase 14 {name}: {g} bases, {shards} shards of {cut}, "
            f"{emitted} kmers, {got.shape[0]} distinct in {wall:.3f}s = "
            f"{emitted / wall:.4g} kmers/s, route_capacity {route_capacity}, "
            f"route_bytes {route_bytes}, peak device memory "
            f"{peak / 2**20:.1f} MiB, overflow 0, union of the shard tables "
            f"== torch.unique count of the whole sequence, no key on two "
            f"shards; launches { {n: c for n, c in launches.items() if c} }"
            + k11)


def spawn_ranks(cmd: list, workdir: str, name: str) -> list:
    """MULTIPROCESS["processes"] ranks of `cmd`, each given its --rank,
    --world and a file:// store under workdir, gloo on the loopback, and
    its output sent to workdir/<name>.rank<r>.log (files, not pipes: a
    rank blocked on a full pipe would stall the others' collectives).
    Returns [(process, log path)]."""
    store = os.path.join(workdir, name + ".store")
    if os.path.exists(store):
        os.remove(store)
    world = MULTIPROCESS["processes"]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    ranks = []
    for r in range(world):
        log = os.path.join(workdir, f"{name}.rank{r}.log")
        with open(log, "w") as f:
            ranks.append((subprocess.Popen(
                cmd + ["--rank", str(r), "--world", str(world), "--init",
                       "file://" + store], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT), log))
    return ranks


def finish_ranks(ranks: list, what: str) -> list:
    """Each rank's report (the last line of its output, JSON), in rank
    order.  A rank that exits non-zero fails the phase; one that runs past
    MULTIPROCESS["spawn_timeout"] is killed with the others, and fails it."""
    deadline = time.time() + MULTIPROCESS["spawn_timeout"]
    try:
        for p, _ in ranks:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p, _ in ranks:
            p.kill()
            p.wait()
        raise AssertionError(f"{what} ran past "
                             f"{MULTIPROCESS['spawn_timeout']} s")
    texts = []
    for r, (p, log) in enumerate(ranks):
        with open(log) as f:
            texts.append(f.read())
        if p.returncode:
            raise AssertionError(f"{what} rank {r} exited {p.returncode}:\n"
                                 f"{texts[-1][-4000:]}")
    return [json.loads(t.strip().splitlines()[-1]) for t in texts]


def phase_multiprocess(stats: dict, workdir: str, seed: int) -> None:
    """Phase 15: the multi-process mesh, two processes on the one card over
    gloo with CUDA tensors, two shards each (D = 4).  The workers
    (chip_smoke.py --worker) count the 1M reads as MULTIPROCESS["runs"]
    say, each process feeding its local_read_slice of every batch, and
    must each save phase 3's / phase 4's single-device table (npz_digest)
    with route_overflow 0, the route_bytes of the one-process D = 4 run
    (phase 7 / 14), and launch K3 and K4 (K9 by minimizer, K6 and K4 at
    k = 63); then phase 14's sequence-parallel steps, each process its
    half of the genome, whose shard tables must be phase 14's lane for
    lane (K11 at k = 31).  Then two ranks of kmers_tpu_torch.dryrun must
    pass every check and give the one-process D = 4 dry run's arrays and
    checkpoints."""
    import numpy as np
    import torch

    from kmers_tpu_torch import dryrun
    from kmers_tpu_torch.parallel.mesh import make_mesh
    from kmers_tpu_torch.parallel.stream import npz_digest

    sync()
    torch.cuda.empty_cache()
    t_phase = time.time()
    d = MULTIPROCESS["processes"] * MULTIPROCESS["local_shards"]
    reports = finish_ranks(spawn_ranks(
        WORKER_CMD + ["--worker", "--workdir", workdir, "--seed", str(seed),
                      "--device", DEVICE, "--genome", str(SIZES["genome"])],
        workdir, "phase15"), "phase 15 worker")
    want = {k: npz_digest(os.path.join(workdir, f"ecoli_1m_k{k}.npz"))
            for k in (31, 63)}
    for partition, k, route_capacity in MULTIPROCESS["runs"]:
        name = f"multiprocess_{partition}_d{d}_k{k}"
        one = stats[f"sharded_{partition}_d{d}" + ("" if k == 31
                                                    else f"_k{k}")]
        runs = [rep["runs"][name] for rep in reports]
        needed = (("merge_sorted_wide",) if k > 32 else ("merge_sorted",)) + (
            "compress_flagged",) + (("minimizer_kernel",)
                                    if partition == "minimizer" else ())
        for rank, run in enumerate(runs):
            if run["route_overflow"]:
                raise AssertionError(f"{name} rank {rank}: route_overflow "
                                     f"{run['route_overflow']}")
            if run["digest"] != want[k]:
                raise AssertionError(f"{name} rank {rank}: table differs "
                                     "from the single-device count")
            if run["route_bytes"] != one["route_bytes"]:
                raise AssertionError(
                    f"{name} rank {rank}: route_bytes {run['route_bytes']} "
                    f"!= the one-process run's {one['route_bytes']}")
            for kernel in needed:
                if not run["launches"].get(kernel):
                    raise AssertionError(f"{name} rank {rank}: {kernel} was "
                                         "not launched")
        for kernel in needed:
            stats["launches"][kernel] += sum(r["launches"][kernel]
                                             for r in runs)
        walls = [r["wall_s"] for r in runs]
        kmers = runs[0]["kmers"]
        stats[name] = dict(wall_s=walls, kmers=kmers,
                           kmers_per_s=kmers / max(walls),
                           route_bytes=runs[0]["route_bytes"],
                           route_capacity=route_capacity,
                           merge_every=runs[0]["merge_every"],
                           peak_bytes=[r["peak_bytes"] for r in runs],
                           launches=[r["launches"] for r in runs],
                           one_process_wall_s=one["wall_s"])
        say(f"phase 15 {name} ({stats['smi']}): {kmers} kmers, walls "
            f"{' / '.join(f'{w:.3f}' for w in walls)} s by process = "
            f"{kmers / max(walls):.4g} kmers/s (one process, D = {d}: "
            f"{one['wall_s']:.3f} s), route_capacity {route_capacity}, "
            f"merge_every {runs[0]['merge_every']}, route_bytes "
            f"{runs[0]['route_bytes']}, peak device memory "
            f"{' / '.join(f'{r["peak_bytes"] / 2**20:.1f}' for r in runs)} "
            f"MiB by process, overflow 0, both tables == single-device; "
            f"launches by process {[r['launches'] for r in runs]}")
    for k in SEQ_PARALLEL["ks"]:
        name = f"multiprocess_sequence_parallel_d{d}_k{k}"
        one = stats[f"sequence_parallel_d{d}_k{k}"]
        runs = [rep["runs"][name] for rep in reports]
        for rank, run in enumerate(runs):
            if (run["route_overflow"] or run["kmers"] != one["kmers"]
                    or run["tables_digest"] != one["tables_digest"]):
                raise AssertionError(
                    f"{name} rank {rank}: overflow {run['route_overflow']}, "
                    f"kmers {run['kmers']} (phase 14 {one['kmers']}), or the "
                    "shard tables differ from phase 14's")
            if k <= 31 and not run["launches"].get("radix_sort_u64"):
                raise AssertionError(f"{name} rank {rank}: radix_sort_u64 "
                                     "was not launched")
        if k <= 31:
            stats["launches"]["radix_sort_u64"] += sum(
                r["launches"]["radix_sort_u64"] for r in runs)
        walls = [r["wall_s"] for r in runs]
        stats[name] = dict(wall_s=walls, kmers=one["kmers"],
                           kmers_per_s=one["kmers"] / max(walls),
                           route_bytes=one["route_bytes"],
                           peak_bytes=[r["peak_bytes"] for r in runs],
                           launches=[r["launches"] for r in runs],
                           one_process_wall_s=one["wall_s"])
        say(f"phase 15 {name} ({stats['smi']}): {one['kmers']} kmers, walls "
            f"{' / '.join(f'{w:.3f}' for w in walls)} s by process = "
            f"{one['kmers'] / max(walls):.4g} kmers/s (one process: "
            f"{one['wall_s']:.3f} s), route_bytes {one['route_bytes']}, "
            f"peak device memory "
            f"{' / '.join(f'{r["peak_bytes"] / 2**20:.1f}' for r in runs)} "
            f"MiB by process, overflow 0, shard tables == phase 14's; "
            f"launches by process {[r['launches'] for r in runs]}")

    # the dry run: one process of four shards, then two ranks of two
    one_dir = os.path.join(workdir, "dryrun_one")
    mp_dir = os.path.join(workdir, "dryrun_mp")
    os.makedirs(one_dir, exist_ok=True)
    one = dryrun.run(make_mesh(devices=[DEVICE] * d), seed, one_dir)
    reports = finish_ranks(spawn_ranks(
        [sys.executable, "-m", "kmers_tpu_torch.dryrun", "--device", DEVICE,
         "--local-shards", str(MULTIPROCESS["local_shards"]), "--backend",
         "gloo", "--timeout", str(MULTIPROCESS["group_timeout"]), "--seed",
         str(seed), "--out", mp_dir], workdir, "phase15_dryrun"),
        "phase 15 dryrun")
    for rank, rep in enumerate(reports):
        if (rep["checks"] != one["checks"]
                or rep["digests"] != {str(k): v
                                      for k, v in one["digests"].items()}):
            raise AssertionError(f"dryrun rank {rank}: checks {rep['checks']}"
                                 f" or digests differ from one process's")
        with np.load(os.path.join(mp_dir, f"dryrun.rank{rank}.npz")) as z:
            if sorted(z.files) != sorted(one["arrays"]) or any(
                    not np.array_equal(z[n], one["arrays"][n])
                    for n in z.files):
                raise AssertionError(f"dryrun rank {rank}: arrays differ from "
                                     "the one-process dry run's")
    say(f"phase 15 dryrun: two ranks of {MULTIPROCESS['local_shards']} "
        f"shards on {DEVICE} over gloo: {len(one['checks'])} checks passed "
        f"on each, arrays and checkpoints == one process of {d} shards; "
        f"launches by process {[r['launches'] for r in reports]}; phase "
        f"15 took {time.time() - t_phase:.1f}s")


def worker_main(args) -> int:
    """One rank of phase 15 (`chip_smoke.py --worker ...`, spawned by
    phase_multiprocess): joins the gloo process group, builds the global
    mesh of MULTIPROCESS["local_shards"] shards a process on args.device,
    runs MULTIPROCESS["runs"] and phase 14's sequence-parallel steps, and
    prints its report as one JSON line."""
    import torch
    import torch.distributed as dist

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.parallel import mesh as mesh_ops
    from kmers_tpu_torch.parallel import pipeline
    from kmers_tpu_torch.parallel.stream import (ShardedStreamingCounter,
                                                 auto_merge_every,
                                                 npz_digest,
                                                 pending_table_lanes)

    mesh_ops.init_distributed(args.init, args.world, args.rank,
                              backend="gloo",
                              timeout=MULTIPROCESS["group_timeout"])
    try:
        mesh = mesh_ops.make_mesh(
            devices=[args.device] * MULTIPROCESS["local_shards"])
        d = mesh.n_shards
        fastq = os.path.join(args.workdir, "ecoli_1m.fastq")
        capacity, batch, length = 1 << 24, 4096, 256
        report = {"rank": mesh.process_index, "runs": {}}

        def start():
            sync()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            return time.time()

        def finish(t0) -> dict:
            sync()
            return dict(wall_s=time.time() - t0,
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        launches={n: c for n, c in
                                  kernels.launch_counts().items() if c})

        for partition, k, route_capacity in MULTIPROCESS["runs"]:
            name = f"multiprocess_{partition}_d{d}_k{k}"
            merge_every = auto_merge_every(capacity, pending_table_lanes(
                batch, length, devices=d, route_capacity=route_capacity,
                partition=partition, k=k, minimizer_w=11))
            out = os.path.join(args.workdir, f"ecoli_1m_{name}.rank"
                               f"{mesh.process_index}.npz")
            t0 = start()
            sc = ShardedStreamingCounter(
                k, capacity, merge_every=merge_every, mesh=mesh,
                route_capacity=route_capacity, partition=partition,
                minimizer_w=11)
            if partition == "minimizer":
                for rows in fastx.prefetch(fastx.read_kmer_batches(
                        fastq, k=k, batch=batch, length=length)):
                    sc.update(rows[mesh_ops.local_read_slice(rows.shape[0])])
            else:
                for words, vbits in fastx.prefetch(fastx.read_packed_batches(
                        fastq, k=k, batch=batch, length=length)):
                    sl = mesh_ops.local_read_slice(words.shape[0])
                    sc.update_packed(words[sl], vbits[sl])
            sc.save(out)
            run = finish(t0)
            run.update(kmers=sc.kmers, route_overflow=sc.route_overflow,
                       route_bytes=sc.route_bytes, merge_every=merge_every,
                       digest=npz_digest(out))
            report["runs"][name] = run

        part = seq_parallel_genome(args.seed, args.genome)[
            mesh_ops.local_read_slice(args.genome)]
        seq = torch.from_numpy(part).to(args.device)
        for k in SEQ_PARALLEL["ks"]:
            name = f"multiprocess_sequence_parallel_d{d}_k{k}"
            step = pipeline.make_sequence_parallel_counter(
                mesh, k, route_capacity=seq_parallel_capacity(args.genome))
            t0 = start()
            res = step(seq)
            run = finish(t0)
            run.update(kmers=int(res.metrics["kmers_emitted"]),
                       route_overflow=int(res.metrics["route_overflow"]),
                       tables_digest=shard_tables_digest(res.table, mesh))
            report["runs"][name] = run
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0


def _walled(walls: dict, name: str, fn):
    """fn() once to warm up, then once between two syncs: its wall in
    walls[name] (s); returns the timed call's result."""
    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    walls[name] = time.perf_counter() - t0
    return out


def _equal(got, want, what: str) -> None:
    """Tensors (or tuples of them) equal, element for element, on the CPU."""
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want) or not all(
            torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: the card differs from the CPU")


def phase_parity(stats: dict, seed: int, workdir: str) -> None:
    """Phase 16: SeqVector and the generic layer on the card, each output
    equal to the same call on the CPU, and PARITY_DIGEST."""
    import numpy as np
    import torch

    from kmers_tpu_torch import smoke
    from kmers_tpu_torch.io import simulate
    from kmers_tpu_torch.ops import generic
    from kmers_tpu_torch.ops import hash as khash
    from kmers_tpu_torch.ops import kmer as kops
    from kmers_tpu_torch.ops.seqvector import SeqVector
    from kmers_tpu_torch.parallel.stream import npz_digest

    t_phase = time.time()
    genome = simulate.genome(SIZES["genome"], seed).tobytes()
    walls = {}
    sv = _walled(walls, "from_bytes",
                 lambda: SeqVector.from_bytes(genome, device=DEVICE))
    pushed = SeqVector.with_capacity(len(genome), device=DEVICE)
    for i in range(0, len(genome), PARITY["chunk"]):
        pushed.push_chars(genome[i:i + PARITY["chunk"]])
    _equal(pushed.words, sv.words, "push_chars' words vs from_bytes'")
    host = SeqVector.from_bytes(genome, device="cpu")
    _equal(sv.words, host.words, "from_bytes")

    kmers = {}
    for k in PARITY["ks"]:
        run = lambda k=k: sv.all_kmers(k)[0]
        kmers[k] = (_walled(walls, f"all_kmers_{k}", run) if k == 31
                    else run())
        _equal(kmers[k], host.all_kmers(k)[0], f"all_kmers({k})")
    k, w = PARITY["minimizer"]
    for name, fn in (("mix", khash.mix_hash_fn(0)),
                     ("lex", khash.lex_hash_fn(w))):
        run = lambda fn=fn: sv.minimizers(k, w, fn)
        got = _walled(walls, f"minimizers_{k}_{w}", run) if name == "mix" \
            else run()
        _equal(got, host.minimizers(k, w, fn), f"minimizers({k}, {w}) {name}")

    # the canonical words of all_kmers(31), against the windows of the
    # genome as one row (a path the tests hold against JAX)
    g31 = kmers[31]
    canon = kops.canonical_word(g31, kops.reverse_complement(g31, 31))
    row = torch.from_numpy(np.frombuffer(genome, dtype=np.uint8).copy())
    win = kops.kmer_windows(row.to(DEVICE)[None], 31)
    n31 = g31.shape[0]
    if not bool(win.valid[0, :n31].all()) or not torch.equal(
            canon, kops.canonical_word(win.fw, win.rc)[0, :n31]):
        raise AssertionError("all_kmers(31)'s canonical words differ from "
                             "kmer_windows'")

    blob = sv.to_simple_sds()
    if blob != host.to_simple_sds():
        raise AssertionError("simple_sds bytes differ from the CPU's")
    paths = {d: os.path.join(workdir, f"parity_{d}.npz") for d in ("gpu", "cpu")}
    sv.save(paths["gpu"])
    host.save(paths["cpu"])
    if npz_digest(paths["gpu"]) != npz_digest(paths["cpu"]):
        raise AssertionError("the saved SeqVector differs from the CPU's")
    _equal(SeqVector.load(paths["gpu"], device=DEVICE).words, sv.words,
           "load(save())")

    n = PARITY["slice_len"]
    start = (len(genome) - n) // 2
    part = sv.slice(start, start + n)
    pos = torch.arange(n - 31 + 1, device=DEVICE)
    _equal(part.get_kmers(pos, 31), g31[start:start + n - 31 + 1],
           "the middle megabase's k-mers vs the whole's")

    sim = dict(genome_len=SIZES["genome"], read_len=150, sub_rate=1e-3,
               n_rate=1e-4, seed=seed)
    chunks, have = [], 0
    for chunk in simulate.iter_reads(n_reads=SIZES["reads"], **sim):
        chunks.append(chunk)
        have += chunk.shape[0]
        if have >= PARITY["reads"]:
            break
    reads = np.concatenate(chunks)[:PARITY["reads"]]
    specs = [generic.GenericSpec(*s) for s in smoke.PARITY_SPECS]
    for b in range(0, reads.shape[0], PARITY["batch"]):
        cpu = torch.from_numpy(reads[b:b + PARITY["batch"]])
        card = cpu.to(DEVICE)
        for spec in specs:
            run = lambda spec=spec: generic.encode_windows(spec, card)
            lanes, valid = (_walled(walls, "encode_windows_batch", run)
                            if b == 0 and spec is specs[0] else run())
            want_lanes, want_valid = generic.encode_windows(spec, cpu)
            what = f"generic {spec} reads [{b}, +{cpu.shape[0]})"
            _equal(lanes + (valid,), want_lanes + (want_valid,), what)
            _equal(generic.decode(spec, lanes),
                   generic.decode(spec, want_lanes), what + " decode")
            _equal(generic.rev_comp(spec, lanes),
                   generic.rev_comp(spec, want_lanes), what + " rev_comp")

    digest = smoke.digest_arrays(smoke.parity_arrays(DEVICE))
    if digest != smoke.PARITY_DIGEST:
        raise AssertionError(f"parity digest {digest} != "
                             f"{smoke.PARITY_DIGEST}")
    seconds = time.time() - t_phase
    stats["parity"] = dict(walls_s=walls, bases=len(genome),
                           reads=int(reads.shape[0]), phase_s=seconds)
    say(f"phase 16 parity surface in {seconds:.1f}s: {nvidia_smi()}; genome "
        f"{len(genome)} bp: "
        f"from_bytes == push_chars (chunks of {PARITY['chunk']}) == cpu; "
        f"all_kmers {PARITY['ks']} and minimizers{PARITY['minimizer']} (mix, "
        f"lex) == cpu; canonical all_kmers(31) == kmer_windows; simple_sds "
        f"and npz == cpu; slice of {n} == whole; {reads.shape[0]} reads in "
        f"batches of {PARITY['batch']} through encode_windows / decode / "
        f"rev_comp at {[str(s) for s in smoke.PARITY_SPECS]} == cpu; parity "
        f"digest == {digest[:16]}...; walls on the card: "
        + ", ".join(f"{name} {t:.6f}s" for name, t in walls.items()))


def _same_shard_table(a, b) -> bool:
    """Two shard tables of one form, lane for lane."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a.keys, b.keys)) and (
        not hasattr(a, "counts") or (torch.equal(a.counts, b.counts)
                                     and a.n_unique == b.n_unique))


def phase_mesh2d(stats: dict, workdir: str, seed: int) -> None:
    """Phase 17: the mesh's second axis, make_mesh(devices=[cuda] * 4,
    seq_shards=2) on the one card.  The hash counter at k = 31 (compact
    shard tables: K11) over "d" and over "s" on the first 250,000 reads of
    phase 3's set; over "s" the super-k-mer counter (k = 31, w = 11: K9,
    K4) on the first 65,536 of them, the sequence-parallel counter at
    k = 31 on phase 14's genome, and the lookup at both arms (the merge's
    K3 with idx and K4) at phase 13's shape (b), bench_configs.py
    --lookup's table split by owner over the axis's two shards, with its
    2^20 queries.  Every local shard's table must equal, lane for lane,
    the one-axis D = 2 run's at the shard's index along the axis (so the
    replicas over the other axis are equal), with that run's metrics and
    no overflow; the lookup's answers equal the D = 2 run's and
    count.lookup's.  Each 2-D call's wall beside the D = 2 call's; the
    2-D calls must launch K11, K9, K4 and K3 with idx."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.io import fastx
    from kmers_tpu_torch.kernels import lookup as klookup
    from kmers_tpu_torch.parallel import mesh as mesh_ops
    from kmers_tpu_torch.parallel import pipeline

    fastq = os.path.join(workdir, "ecoli_1m.fastq")
    d, s = MESH2D["shape"]
    m2d = mesh_ops.make_mesh(devices=[DEVICE] * (d * s), seq_shards=s)
    m1d = mesh_ops.make_mesh(devices=[DEVICE] * 2)
    reads = torch.from_numpy(next(iter(fastx.read_kmer_batches(
        fastq, k=31, batch=MESH2D["reads"], length=150)))).to(DEVICE)
    genome = torch.from_numpy(seq_parallel_genome(seed, SIZES["genome"])
                              ).to(DEVICE)
    route = MESH2D["route_capacity"]
    runs = (
        ("hash_k31", "d", lambda m, **kw: pipeline.make_sharded_counter(
            m, 31, route_capacity=route, **kw), reads),
        ("hash_k31", "s", lambda m, **kw: pipeline.make_sharded_counter(
            m, 31, route_capacity=route, **kw), reads),
        ("superkmer_k31_w11", "s",
         lambda m, **kw: pipeline.make_superkmer_counter(
             m, 31, 11, route_capacity=MESH2D["superkmer_capacity"], **kw),
         reads[:MESH2D["superkmer_reads"]]),
        ("sequence_parallel_k31", "s",
         lambda m, **kw: pipeline.make_sequence_parallel_counter(
             m, 31, route_capacity=int(SEQ_PARALLEL["margin"]
                                       * SIZES["genome"] / 4), **kw),
         genome))
    launched = dict.fromkeys(kernels.KERNELS, 0)
    results = {}

    def run_2d(fn):
        """fn() on the 2-D mesh: (its result, wall); its launches counted."""
        sync()
        kernels.reset_launch_counts()
        t0 = time.time()
        out = fn()
        sync()
        wall = time.time() - t0
        for name, n in kernels.launch_counts().items():
            launched[name] += n
        return out, wall

    def run_1d(fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        return out, time.time() - t0

    for name, axis, make, x in runs:
        got, wall = run_2d(lambda: make(m2d, axis=axis)(x))
        want, wall_1d = run_1d(lambda: make(m1d)(x))
        pos = mesh_ops.axis_positions(m2d, axis)
        metrics = {m: int(v) for m, v in got.metrics.items()}
        if not all(_same_shard_table(t, want.table[p])
                   for t, p in zip(got.table, pos)):
            raise AssertionError(f"mesh2d {name} over {axis}: a shard table "
                                 "differs from the D = 2 run's")
        if metrics != {m: int(v) for m, v in want.metrics.items()} or (
                metrics["route_overflow"]):
            raise AssertionError(f"mesh2d {name} over {axis}: metrics "
                                 f"{metrics} vs the D = 2 run's")
        results[f"{name} over {axis}"] = dict(wall_s=wall, wall_1d_s=wall_1d,
                                              metrics=metrics)

    table, queries = _bench_lookup_inputs()
    valid = torch.ones_like(queries, dtype=torch.bool)
    split = _split_by_owner(table, 2, LOOKUP["bench_capacity"])
    local = [split[p] for p in mesh_ops.axis_positions(m2d, "s")]
    want = klookup.search_counts_plain(table.keys_hi, table.keys_lo,
                                       table.counts, table.n_unique, queries)
    for arm, merge in (("merge", True), ("binsearch", False)):
        look = lambda m, **kw: pipeline.make_sharded_lookup(
            m, query_capacity=MESH2D["query_capacity"], max_k=31,
            merge_lookup=merge, **kw)
        (counts, overflow), wall = run_2d(
            lambda: look(m2d, axis="s")(local, queries, valid))
        (counts_1d, _), wall_1d = run_1d(
            lambda: look(m1d)(split, queries, valid))
        if int(overflow) or not (torch.equal(counts, counts_1d)
                                 and torch.equal(counts, want)):
            raise AssertionError(f"mesh2d lookup {arm} over s: overflow "
                                 f"{int(overflow)}, answers differ")
        results[f"lookup_{arm} over s"] = dict(wall_s=wall,
                                               wall_1d_s=wall_1d)
    for name in ("radix_sort_u64", "minimizer_kernel", "compress_flagged",
                 "merge_sorted_idx"):
        if launched[name] == 0:
            raise AssertionError(f"mesh2d: {name} was not launched")
    stats["mesh2d"] = dict(results, launches={n: c for n, c in
                                              launched.items() if c})
    say(f"phase 17 two-axis mesh ({d}, {s}) on one card ({stats['smi']}): "
        + "; ".join(f"{label} {r['wall_s']:.3f}s (one-axis D = 2 "
                    f"{r['wall_1d_s']:.3f}s)" for label, r in results.items())
        + "; every local shard's table == the D = 2 run's at its index "
        "along the axis (replicas equal), metrics ==, overflow 0, lookup "
        f"answers == D = 2 and the plain search; launches "
        f"{stats['mesh2d']['launches']}")


def seq_parallel_genome(seed: int, g: int):
    """Phase 14's sequence: the seeded [g] genome the reads come from, Ns
    at and beside each of the four shards' cuts."""
    from kmers_tpu_torch.io import simulate

    seq = simulate.genome(g, seed)
    cut = g // SEQ_PARALLEL["shards"]
    for c in range(cut, g, cut):
        for off in SEQ_PARALLEL["n_offsets"]:
            seq[c + off] = ord("N")
    return seq


def seq_parallel_capacity(g: int) -> int:
    """An even share of a shard's windows a destination, plus a margin."""
    shards = SEQ_PARALLEL["shards"]
    return int(SEQ_PARALLEL["margin"] * (g // shards) / shards)


def shard_tables_digest(tables, mesh) -> str:
    """sha256 over every shard's table of a sharded result (the whole
    mesh's, gathered across processes; npz_digest's order and fields):
    equal digests mean equal shard tables, lane for lane."""
    import hashlib

    import numpy as np

    from kmers_tpu_torch.dryrun import shard_arrays

    arrays = shard_arrays("shard", tables, mesh)
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}\0{a.dtype.str}\0{a.shape}\0".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def caught_args(module, name: str):
    """Record the positional arguments of the first call of module.name
    made inside the block (the call itself goes through)."""
    caught, fn = [], getattr(module, name)

    def catch(*args, **kw):
        if not caught:
            caught.append(args)
        return fn(*args, **kw)

    setattr(module, name, catch)
    try:
        yield caught
    finally:
        setattr(module, name, fn)


def _bench_lookup_inputs():
    """bench_configs.py --lookup's inputs (:576-596), numpy's
    default_rng(11): 2^19 distinct keys below 2^62, ascending, at capacity
    2^20 (zeros past them), counts 1..99, and 2^20 queries of hi below
    2^30, all valid."""
    import numpy as np
    import torch

    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.parallel import count as count_ops

    rng = np.random.default_rng(11)
    cap, n_keys = LOOKUP["bench_capacity"], LOOKUP["bench_keys"]
    keys = np.zeros(cap, np.uint64)
    keys[:n_keys] = np.sort(rng.choice(2**62, size=n_keys, replace=False))
    counts = np.where(np.arange(cap) < n_keys, rng.integers(1, 100, cap), 0)
    nq = LOOKUP["queries"]
    q_hi = rng.integers(0, 2**30, nq, dtype=np.uint32).astype(np.uint64)
    q_lo = rng.integers(0, 2**32, nq, dtype=np.uint32).astype(np.uint64)
    dev = torch.device(DEVICE)
    table = count_ops.CountTable(
        *u64.split_word(torch.from_numpy(keys.view(np.int64)).to(dev)),
        torch.from_numpy(counts.astype(np.int32)).to(dev), n_keys)
    queries = (q_hi << np.uint64(32)) | q_lo
    return table, torch.from_numpy(queries.view(np.int64)).to(dev)


def _split_by_owner(table, shards: int, capacity: int) -> list:
    """A table's keys as the hash partition's shard tables: split by
    route.owner_of, each shard's keys still ascending, zeros past them."""
    import torch

    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.parallel import count as count_ops
    from kmers_tpu_torch.parallel import route

    nu = table.n_unique
    keys = u64.join_planes(table.keys_hi[:nu], table.keys_lo[:nu])
    counts = table.counts[:nu]
    owner = route.owner_of(keys, shards)
    out = []
    for s in range(shards):
        k, c = keys[owner == s], counts[owner == s]
        pad = capacity - k.shape[0]
        out.append(count_ops.CountTable(
            *u64.split_word(torch.cat([k, k.new_zeros(pad)])),
            torch.cat([c, c.new_zeros(pad)]), k.shape[0]))
    return out


def _lookup_queries(keys, g, n: int, seed: int):
    """n shuffled queries: half drawn from `keys`, a quarter random
    canonical k=31 words, a quarter invalid; then lanes 0-4 invalid and
    lane 5 feistel_unmix(MAX, seed), the real query whose mix is the
    invalid lanes' sentinel."""
    import torch

    from kmers_tpu_torch.core import u64

    dev = keys.device
    half, quarter = n // 2, n // 4
    rand = lambda m: torch.randint(0, 1 << 62, (m,), device=dev, generator=g)
    w = rand(quarter)
    words = torch.cat([
        keys[torch.randint(0, keys.shape[0], (half,), device=dev,
                           generator=g)],
        u64.unsigned_min(w, u64.reverse_complement(w, 31)),
        rand(n - half - quarter)])
    valid = torch.arange(n, device=dev) < half + quarter
    perm = torch.randperm(n, device=dev, generator=g)
    words, valid = words[perm], valid[perm]
    valid[:5] = False
    words[5] = u64.feistel_unmix(torch.full((1,), -1, device=dev), seed)[0]
    valid[5] = True
    return words, valid


def phase_lookup(stats: dict, seed: int, workdir: str) -> None:
    """Phase 13: the distributed lookup service, both answer arms
    (make_sharded_lookup, merge_lookup True and False), on (b)
    bench_configs.py --lookup's table and queries on one shard, and on (c)
    phase 3's table split over four shards on the one card with 2^20
    queries; answers equal the plain search (search_counts_plain, no
    kernel; -1 on invalid lanes), no overflow, and StreamingCounter.lookup
    and lookup_sharded agree with it on the valid lanes.  The merge arm's
    main runs must launch K3 with its index plane and K4.  (d) The search kernel K12 bit for bit against its plain
    version at the lookup cell's shape (2^20 lanes over phase 3's table),
    timed.  Then (a) K3 with idx bit for bit against its plain version at
    phase 2's 2^24 + 2^24 lanes and at (c)'s shard shape, timed."""
    import torch

    from kmers_tpu_torch import kernels
    from kmers_tpu_torch.core import u64
    from kmers_tpu_torch.kernels import lookup as klookup
    from kmers_tpu_torch.kernels import merge as kmerge
    from kmers_tpu_torch.parallel import pipeline
    from kmers_tpu_torch.parallel.mesh import make_mesh
    from kmers_tpu_torch.parallel.stream import StreamingCounter

    launched = dict.fromkeys(("merge_sorted_idx", "compress_flagged"), 0)
    searched = dict(launches=0)
    results = {}

    def drive(label, mesh, tables, queries, valid, want, query_capacity):
        """Both arms: a first call (wall, launches, checks), then the
        median of 10 calls between CUDA events."""
        res = results[label] = {}
        for arm, merge in (("merge", True), ("binsearch", False)):
            fn = pipeline.make_sharded_lookup(
                mesh, query_capacity=query_capacity, max_k=31,
                merge_lookup=merge)
            sync()
            kernels.reset_launch_counts()
            t0 = time.time()
            counts, overflow = fn(tables, queries, valid)
            sync()
            wall = time.time() - t0
            launches = kernels.launch_counts()
            if int(overflow) or not torch.equal(counts, want):
                raise AssertionError(
                    f"lookup {label} {arm}: overflow {int(overflow)}, "
                    f"{int((counts != want).sum())} answers differ")
            searched["launches"] += launches["search_counts"]
            if merge:
                for name in launched:
                    if launches[name] == 0:
                        raise AssertionError(f"lookup {label}: {name} was "
                                             "not launched")
                    launched[name] += launches[name]
            ms = time_ms(lambda: fn(tables, queries, valid))
            res[arm] = dict(wall_s=wall, ms=ms,
                            queries_per_s=queries.shape[0] / ms * 1e3)
            stats["profiled"][f"lookup {label} {arm}"] = (
                lambda fn=fn: fn(tables, queries, valid))

    sync()
    torch.cuda.reset_peak_memory_stats()
    table, queries = _bench_lookup_inputs()
    valid = torch.ones_like(queries, dtype=torch.bool)
    drive("bench_d1", make_mesh(devices=[DEVICE]), [table], queries, valid,
          klookup.search_counts_plain(table.keys_hi, table.keys_lo,
                                      table.counts, table.n_unique, queries,
                                      valid),
          LOOKUP["queries"])

    sc = StreamingCounter.load(os.path.join(workdir, "ecoli_1m_k31.npz"),
                               device=DEVICE)
    nu = sc.table.n_unique
    shards = LOOKUP["shards"]
    tables = _split_by_owner(sc.table, shards, LOOKUP["shard_capacity"])
    if sum(t.n_unique for t in tables) != nu:
        raise AssertionError("the shard split lost keys")
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    queries, valid = _lookup_queries(table_keys(sc.table), g,
                                     LOOKUP["queries"], 0)
    want = klookup.search_counts_plain(sc.table.keys_hi, sc.table.keys_lo,
                                       sc.table.counts, nu, queries, valid)
    if not torch.equal(sc.lookup(queries)[valid], want[valid]):
        raise AssertionError("StreamingCounter.lookup differs from the plain "
                             "search on the valid lanes")
    mesh4 = make_mesh(devices=[DEVICE] * shards)
    with caught_args(kmerge, "merge_sorted") as caught:
        pipeline.make_sharded_lookup(
            mesh4, query_capacity=LOOKUP["query_capacity"], max_k=31,
            merge_lookup=True)(tables, queries, valid)
    drive("ecoli_d4", mesh4, tables, queries, valid, want,
          LOOKUP["query_capacity"])
    by_owner = pipeline.lookup_sharded(tables, queries, shards)
    if not torch.equal(by_owner[valid], want[valid]):
        raise AssertionError("lookup_sharded differs on the valid lanes")
    sync()
    peak = torch.cuda.max_memory_allocated()

    # (d) K12 at the lookup cell's shape: 2^20 lanes over phase 3's table,
    # 97 % of them its keys (as fresh reads of the genome give), the rest
    # random canonical words, 0.3 % invalid
    n = LOOKUP["queries"]
    keys = table_keys(sc.table)
    w = torch.randint(0, 1 << 62, (n,), device=DEVICE, generator=g)
    q12 = torch.where(
        torch.rand(n, device=DEVICE, generator=g) < 0.97,
        keys[torch.randint(0, nu, (n,), device=DEVICE, generator=g)],
        u64.unsigned_min(w, u64.reverse_complement(w, 31)))
    v12 = torch.rand(n, device=DEVICE, generator=g) >= 0.003
    args12 = (sc.table.keys_hi, sc.table.keys_lo, sc.table.counts, nu, q12,
              v12)
    got12 = klookup.search_counts(*args12)
    err12 = max_abs_err([got12], [klookup.search_counts_plain(*args12)])
    if err12:
        raise AssertionError(f"search_counts differs from its plain version "
                             f"(max_abs_err {err12})")
    # the library's search with the same answers, the keys joined beforehand
    joined, q_joined = (u64.to_unsigned_order(x) for x in (keys, q12))

    def library():
        at = torch.searchsorted(joined, q_joined)
        at_c = at.clamp(max=nu - 1)
        hit = (at < nu) & (joined[at_c] == q_joined)
        return torch.where(v12, torch.where(hit, sc.table.counts[at_c], 0),
                           -1)

    if not torch.equal(library(), got12):
        raise AssertionError("torch.searchsorted's answers differ from "
                             "search_counts'")
    stats["kernels"]["search_counts"] = dict(
        max_abs_err=err12, ms=time_ms(lambda: klookup.search_counts(*args12)),
        plain_ms=time_ms(lambda: klookup.search_counts_plain(*args12)),
        bound_ms=bound_ms(nbytes(q12, v12, got12)),
        library_ms=time_ms(library))
    stats["launches"]["search_counts"] = searched["launches"]
    stats["profiled"][f"search_counts [2^20 over {nu}]"] = (
        lambda: klookup.search_counts(*args12))

    # (a) K3 with idx at phase 2's inputs (the same generator stream) and at
    # (c)'s shard shape; K4's phase-2 inputs for phase 12's profiler
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    args3 = merge_inputs(g)
    planes, keep = compress_inputs(g)
    at_shard = caught[0]
    err = max(max_abs_err(kmerge.merge_sorted(*a, with_idx=True),
                          kmerge.merge_sorted_plain(*a, with_idx=True))
              for a in (args3, at_shard))
    if err:
        raise AssertionError(f"merge_sorted_idx differs from its plain "
                             f"version (max_abs_err {err})")
    sizes = {}
    shard_label = f"{at_shard[0].shape[0]} + {at_shard[3].shape[0]}"
    for label, a in (("2^24 + 2^24", args3), (shard_label, at_shard)):
        sizes[label] = (
            time_ms(lambda: kmerge.merge_sorted(*a, with_idx=True)),
            time_ms(lambda: kmerge.merge_sorted_plain(*a, with_idx=True)),
            bound_ms(nbytes(*a, *kmerge.merge_sorted(*a, with_idx=True))))
    # lookup_merge's run broadcast at (c)'s merged lanes: the cumsum of
    # the run starts it takes, and the torch.cummax scan it does not take
    starts = torch.rand(sum(map(len, at_shard[::3])), device=DEVICE,
                        generator=g) < 0.5
    pos = torch.arange(starts.shape[0], device=DEVICE)
    broadcast = dict(
        cumsum=time_ms(lambda: torch.cumsum(starts, 0)),
        cummax=time_ms(lambda: torch.cummax(torch.where(starts, pos, 0), 0)))
    ms, plain_ms, bound = sizes["2^24 + 2^24"]
    stats["kernels"]["merge_sorted_idx"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        library_ms=None, sizes=sizes)
    stats["launches"]["merge_sorted_idx"] = launched["merge_sorted_idx"]
    stats["profiled"]["merge_sorted_idx [2^24 + 2^24]"] = (
        lambda: kmerge.merge_sorted(*args3, with_idx=True))
    stats["profiled"]["compress_flagged [2^25]"] = (
        lambda: kmerge.compress_flagged(*planes, keep))

    faster = {min(r, key=lambda arm: r[arm]["ms"]) for r in results.values()}
    faster = faster.pop() if len(faster) == 1 else "neither"
    stats["lookup"] = dict(results, peak_bytes=peak, launches=launched,
                           faster=faster, broadcast_ms=broadcast)
    say("phase 13 lookup service: " + "; ".join(
        f"{label} " + ", ".join(
            f"{arm} {r['ms']:.4f} ms = {r['queries_per_s']:.4g} queries/s "
            f"(first call {r['wall_s']:.3f}s)" for arm, r in res.items())
        for label, res in results.items())
        + f"; faster at both shapes: {faster}; answers == the plain "
        f"search, overflow 0, StreamingCounter.lookup and lookup_sharded "
        f"== on the valid lanes; peak device memory {peak / 2**20:.1f} MiB; "
        f"merge arm launches {launched}; merge_sorted_idx bit-exact vs plain, "
        + ", ".join(f"[{label}] {t[0]:.4f} ms (plain {t[1]:.3f}, bound "
                    f"{t[2]:.4f})" for label, t in sizes.items())
        + "; search_counts bit-exact vs plain at 2^20 over "
        f"{nu} keys, {stats['kernels']['search_counts']['ms']:.4f} ms "
        f"(plain {stats['kernels']['search_counts']['plain_ms']:.4f}, "
        f"torch.searchsorted and gathers "
        f"{stats['kernels']['search_counts']['library_ms']:.4f}, "
        f"bound {stats['kernels']['search_counts']['bound_ms']:.4f})"
        + f"; run broadcast at {starts.shape[0]} lanes: cumsum "
        f"{broadcast['cumsum']:.4f} ms, torch.cummax {broadcast['cummax']:.4f}")


def _top_and_absent_queries(path: str) -> list:
    """The most frequent k-mer of a saved table as a string, and AAA..A."""
    import numpy as np

    from kmers_tpu_torch import convert

    with np.load(path) as z:
        nu = int(z["n_unique"])
        i = int(np.argmax(z["counts"][:nu]))
        names = (convert.WIDE_KEY_NAMES if convert.WIDE_KEY_NAMES[0] in z.files
                 else convert.KEY_NAMES)
        word = 0
        for name in names:
            word = (word << 32) | int(z[name][i])
        k = int(z["k"])
    top = "".join("ACGT"[(word >> (2 * j)) & 3] for j in range(k))
    return [top, "A" * k]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "smoke"))
    # one rank of phase 15, which spawns it: --worker --rank R --world P
    # --init URL (and the device and genome length phase 15 runs at)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for name, kind in (("--rank", int), ("--world", int), ("--init", str),
                       ("--device", str), ("--genome", int)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: chip_smoke needs "
              "a CUDA card", file=sys.stderr)
        return 1
    import kmers_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.worker:
        return worker_main(args)

    os.makedirs(args.workdir, exist_ok=True)
    stats = {"kernels": {}, "launches": {}, "profiled": {}}
    phase_device(stats)
    phase_kernels(stats, args.seed)
    phase_end_to_end(stats, args.seed, args.workdir, 31, 3)
    phase_ablation_packed(stats, args.workdir)
    phase_end_to_end(stats, args.seed, args.workdir, 63, 4)
    phase_reference(stats, args.workdir)
    phase_minimizer(stats, args.seed)
    phase_sharded(stats, args.workdir)
    sort_inputs = phase_sort_kernels(stats, args.seed, args.workdir)
    phase_count_forms(stats, args.workdir)
    for k in (32, 64):
        phase_end_to_end(stats, args.seed, args.workdir, k, 10)
    phase_reference(stats, args.workdir, ks=(32, 64), phase=10)
    phase_sharded_compact(stats, args.workdir)
    phase_sharded_wide(stats, args.workdir, args.seed)
    phase_multiprocess(stats, args.workdir, args.seed)
    phase_parity(stats, args.seed, args.workdir)
    phase_mesh2d(stats, args.workdir, args.seed)
    phase_lookup(stats, args.seed, args.workdir)
    phase_sort_call(sort_inputs)
    phase_profiled(stats)

    kernels = []
    for name, r in stats["kernels"].items():
        if not stats["launches"].get(name):
            raise AssertionError(f"{name} has no launch on its path")
        source, replaces = KERNEL_INFO[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=stats["launches"][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by="bytes", library_ms=r["library_ms"]))
    say(nvidia_smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
