"""Command-line interface: python -m kmers_tpu_torch <command>.

Commands (the same as ``python -m kmers_tpu``):
  count      FASTA/FASTQ -> canonical k-mer count table (npz), with
             periodic checkpointing and resume.
  query      look up k-mers (as ACGT strings) in a saved table.
  stats      summarize a saved table.

Every command takes --device (default cuda).  A cuda device without a
card is an error, never a silent fall back to the CPU.  This port counts
1 <= k <= 64 (128-bit keys past k = 32; k = 32 and k = 64, which fill
every key bit, through the run-length tables), on one device or sharded
over --devices N (N GPUs; N shards on the CPU with --device cpu),
hash-partitioned at every k, minimizer-partitioned at k <= 31;
--partition minimizer with --devices > 1 at k > 31 exits 2 with an
error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .core.spec import NARROW_MAX_K, check_k


def _unsupported(args):
    """The error for arguments the count refuses (k outside 1..64, the
    sharded minimizer partition past k = 31, a minimizer width that does
    not fit k), or None."""
    try:
        check_k(args.k)
    except ValueError as e:
        return str(e)
    if args.devices > 1 and args.partition == "minimizer":
        if args.k > NARROW_MAX_K:
            return (f"--partition minimizer needs k <= {NARROW_MAX_K}, "
                    f"got k={args.k}")
        if not 1 <= args.minimizer_w <= args.k:
            return (f"--minimizer-w {args.minimizer_w} must lie in "
                    f"1..k={args.k}")
    return None


def _cmd_count(args) -> int:
    import signal
    import traceback

    from .io import fastx
    from .parallel.mesh import cli_device, mesh_for
    from .parallel.stream import (ShardedStreamingCounter, StreamingCounter,
                                  auto_merge_every, pending_table_lanes)

    bad = _unsupported(args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 2
    device = cli_device(args.device)
    sharded = args.devices > 1
    if sharded:
        try:
            mesh = mesh_for(device, args.devices)
        except ValueError as e:         # more GPUs asked for than exist
            print(f"error: --devices {args.devices}: {e}", file=sys.stderr)
            return 2

    def auto_cadence():
        return auto_merge_every(args.capacity, pending_table_lanes(
            args.batch, args.length, devices=args.devices,
            route_capacity=args.route_capacity,
            route_passes=args.route_passes, partition=args.partition,
            k=args.k, minimizer_w=args.minimizer_w))

    def make_counter():
        merge_every = args.merge_every or auto_cadence()
        if sharded:
            return ShardedStreamingCounter(
                args.k, args.capacity, merge_every=merge_every, mesh=mesh,
                route_capacity=args.route_capacity,
                route_passes=args.route_passes, seed=args.seed,
                partition=args.partition, minimizer_w=args.minimizer_w)
        return StreamingCounter(args.k, args.capacity,
                                merge_every=merge_every, device=device)

    def load_counter(resuming: bool):
        """(counter, batches_to_skip), from the checkpoint if one exists
        (np.savez appends .npz when the path lacks it: check both)."""
        ckpt_exists = (os.path.exists(args.output)
                       or os.path.exists(args.output + ".npz"))
        if not (resuming and ckpt_exists):
            return make_counter(), 0
        loaded = StreamingCounter.load(args.output, device=device)
        if loaded.k != args.k:
            raise SystemExit(
                f"error: checkpoint has k={loaded.k}, requested k={args.k}")
        if sharded:
            # the flat checkpoint's table and counters move into a sharded
            # counter (the merged table is a valid merge input either way)
            sc = make_counter()
            sc.table = loaded.table
            sc.batches, sc.kmers = loaded.batches, loaded.kmers
            sc.dropped_unique = loaded.dropped_unique
            sc.dropped_kmers = loaded.dropped_kmers
        else:
            sc = loaded
            sc.merge_every = max(1, args.merge_every or auto_cadence())
        print(f"resuming from {args.output}: {sc.batches} batches, "
              f"{sc.kmers} kmers", file=sys.stderr)
        return sc, sc.batches

    # Whether THIS run has written args.output: the in-process restart may
    # trust an existing output only if so (or under --resume); a stale
    # table of an unrelated run must never be merged in.
    wrote_output = False

    def stream(sc, skip: int) -> None:
        """One pass over the file, skipping `skip` counted batches: packed
        ingest on a background parse thread, ASCII rows for
        --ascii-ingest, length % 32 != 0 or the sharded minimizer
        partition (super-k-mers start from ASCII rows)."""
        nonlocal wrote_output
        use_packed = (args.length % 32 == 0 and not args.ascii_ingest
                      and not (sharded and args.partition == "minimizer"))
        if use_packed:
            it = fastx.read_packed_batches(args.input, k=args.k,
                                           batch=args.batch,
                                           length=args.length)
        else:
            it = fastx.read_kmer_batches(args.input, k=args.k,
                                         batch=args.batch,
                                         length=args.length)
        seen = 0
        for item in fastx.prefetch(it):
            seen += 1
            if seen <= skip:
                continue
            if use_packed:
                sc.update_packed(*item)
            else:
                sc.update(item)
            if (args.checkpoint_every
                    and sc.batches % args.checkpoint_every == 0):
                sc.save(args.output)
                wrote_output = True

    def emergency_save(sc) -> bool:
        """Best-effort checkpoint after a failure: pending batches roll
        back first so the saved batch count matches the table."""
        nonlocal wrote_output
        sc.discard_pending()
        try:
            sc.save(args.output)
            wrote_output = True
            return True
        except Exception:  # the device may be gone; report, do not mask
            traceback.print_exc()
            return False

    try:
        sc, skip = load_counter(args.resume)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    # SIGTERM lands as KeyboardInterrupt -> graceful checkpoint; any other
    # mid-stream error saves and restarts in-process from the checkpoint
    def _graceful(_signum, _frame):
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _graceful)
    t0 = time.time()
    restarts = 0
    try:
        while True:
            try:
                stream(sc, skip)
                sc.save(args.output)
                break
            except KeyboardInterrupt:
                saved = emergency_save(sc)
                print(f"interrupted: {'checkpoint saved to ' + args.output if saved else 'checkpoint save FAILED'}"
                      f" ({sc.batches} batches); re-run with --resume",
                      file=sys.stderr)
                return 130
            except Exception:
                traceback.print_exc()
                saved = emergency_save(sc)
                print(f"stream failed after {sc.batches} batches "
                      f"(checkpoint {'saved' if saved else 'save FAILED'})",
                      file=sys.stderr)
                if restarts >= args.max_restarts:
                    print(f"giving up after {restarts} restarts; "
                          f"re-run with --resume to continue",
                          file=sys.stderr)
                    return 4
                restarts += 1
                trust_ckpt = args.resume or wrote_output
                print(f"restart {restarts}/{args.max_restarts} from "
                      f"{'the last checkpoint' if trust_ckpt else 'scratch'}",
                      file=sys.stderr)
                sc, skip = load_counter(resuming=trust_ckpt)
    finally:
        signal.signal(signal.SIGTERM, prev_term)
    dt = time.time() - t0
    print(f"{sc.kmers} kmers ({sc.table.n_unique} distinct) "
          f"from {sc.batches} batches in {dt:.1f}s "
          f"-> {args.output}", file=sys.stderr)
    if getattr(sc, "route_overflow", 0):
        print(f"WARNING: routing overflow: {sc.route_overflow} kmers "
              f"dropped in transit ({sc.route_rerouted} re-routed); "
              f"raise --route-capacity or --route-passes for exact counts",
              file=sys.stderr)
        return 3
    if sc.dropped_unique:
        print(f"WARNING: capacity exceeded: {sc.dropped_unique} distinct "
              f"kmers ({sc.dropped_kmers} occurrences) dropped; "
              f"re-run with a larger --capacity", file=sys.stderr)
        return 3
    return 0


def _cmd_query(args) -> int:
    from .core import u64, u128
    from .ops.kmer import canonical_from_string, canonical_from_string_wide
    from .parallel.mesh import cli_device
    from .parallel.stream import StreamingCounter

    sc = StreamingCounter.load(args.table, device=cli_device(args.device))
    canonical = (canonical_from_string_wide if sc.wide
                 else canonical_from_string)
    words, bad = [], False
    for q in args.kmers:
        if len(q) != sc.k:
            print(f"error: '{q}' has length {len(q)}, table k={sc.k}",
                  file=sys.stderr)
            bad = True
            continue
        try:
            canon = canonical(q)
        except ValueError:
            print(f"error: '{q}' contains non-ACGT characters",
                  file=sys.stderr)
            bad = True
            continue
        words.append((q, canon))
    if words:
        ints = [w for _, w in words]
        qa = u128.from_ints(ints) if sc.wide else u64.from_ints(ints)
        counts = sc.lookup(qa).cpu().tolist()
        for (q, _), c in zip(words, counts):
            print(f"{q}\t{int(c)}")
    return 2 if bad else 0


def _cmd_stats(args) -> int:
    from .parallel.mesh import cli_device
    from .parallel.stream import StreamingCounter

    sc = StreamingCounter.load(args.table, device=cli_device(args.device))
    nu = sc.table.n_unique
    counts = sc.table.counts[:nu].cpu().numpy()
    print(f"k:              {sc.k}")
    print(f"distinct kmers: {nu} / capacity {sc.capacity}")
    print(f"total kmers:    {sc.kmers}")
    print(f"batches:        {sc.batches}")
    print(f"dropped:        {sc.dropped_unique} distinct "
          f"/ {sc.dropped_kmers} occurrences")
    if nu:
        print(f"count range:    [{counts.min()}, {counts.max()}], "
              f"mean {counts.mean():.2f}")
        print(f"singletons:     {(counts == 1).sum()}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmers_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device (default cuda; cpu runs the "
                                 "plain PyTorch versions of the kernels)")

    c = sub.add_parser(
        "count", help="count canonical k-mers of a file",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "exactness contract: counts are exact iff --capacity >= the\n"
            "input's DISTINCT canonical k-mer count.  Past capacity,\n"
            "lowest-count entries are evicted first and the dropped mass\n"
            "is reported (dropped_unique / dropped_kmers; exit code 3) --\n"
            "counts are then lower bounds.\n"))
    c.add_argument("input", help="FASTA/FASTQ path")
    c.add_argument("-k", type=int, required=True,
                   help="k-mer length (1..64)")
    c.add_argument("-o", "--output", required=True, help="output .npz table")
    c.add_argument("--capacity", type=int, default=1 << 22,
                   help="max distinct kmers the table can hold (default 4M)")
    c.add_argument("--batch", type=int, default=256)
    c.add_argument("--length", type=int, default=256,
                   help="row length; long records are halo-chunked")
    c.add_argument("--merge-every", type=int, default=0,
                   help="consolidate pending batch tables every N batches; "
                        "0 = auto, ~capacity/batch-lanes clamped to [8, 64]")
    c.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every N batches (enables --resume)")
    c.add_argument("--resume", action="store_true",
                   help="resume from an existing output checkpoint")
    c.add_argument("--max-restarts", type=int, default=2,
                   help="on a mid-stream failure, auto-save a checkpoint "
                        "and restart in-process up to N times (0 = save "
                        "and exit 4)")
    c.add_argument("--ascii-ingest", action="store_true",
                   help="upload raw ASCII rows instead of 2-bit packed "
                        "batches")
    c.add_argument("--devices", type=int, default=1,
                   help="shard counting over N devices: N GPUs, or N "
                        "shards on the CPU with --device cpu")
    c.add_argument("--route-capacity", type=int, default=4096,
                   help="per-destination lane budget per routing pass "
                        "(sharded mode)")
    c.add_argument("--route-passes", type=int, default=1,
                   help="overflow re-route rounds (sharded mode)")
    c.add_argument("--partition", choices=("hash", "minimizer"),
                   default="hash",
                   help="sharded-mode routing: 'hash' ships each k-mer to "
                        "its hash-prefix owner; 'minimizer' ships packed "
                        "super-k-mer runs to minimizer owners (k <= 31, "
                        "ASCII ingest; --route-capacity is then a budget "
                        "of super-k-mers).  Ignored with --devices 1")
    c.add_argument("--minimizer-w", type=int, default=11,
                   help="minimizer width for --partition minimizer")
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the routing / minimizer mixer hash "
                        "(shard assignment only, never counts)")
    add_device(c)
    c.set_defaults(fn=_cmd_count)

    q = sub.add_parser("query", help="look up k-mers in a saved table")
    q.add_argument("table", help=".npz table from `count`")
    q.add_argument("kmers", nargs="+", help="k-mer strings (ACGT)")
    add_device(q)
    q.set_defaults(fn=_cmd_query)

    s = sub.add_parser("stats", help="summarize a saved table")
    s.add_argument("table")
    add_device(s)
    s.set_defaults(fn=_cmd_stats)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
