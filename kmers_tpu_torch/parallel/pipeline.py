"""Per-batch counting (counterpart of ``kmers_tpu/parallel/pipeline.py``).

A batch becomes one table, in the form `aggregate` names (default from
`compact`, as in the JAX package):

  "compact"    sorted, compacted CountTable(Wide) (count.count_words)
  "runlength"  counts at run starts: K10's per-segment layout at k <= 31 /
               k <= 63, globally sorted with duplicates at k = 32 / 64
  "unit"       raw folded canonical keys, one occurrence per valid lane
               (k <= 31, 33 <= k <= 63), no per-batch sort: what the
               streaming counter consolidates.

  single device   count_reads(_packed) (k <= 32; unit: window kernels K2 /
                  K1) and count_reads(_packed)_wide (33 <= k <= 64; unit:
                  K7, packed plain).  The compact and run-length forms
                  take the plain windows of ops.kmer, as the JAX package
                  does off its unit kernels.
  mesh            make_sharded_counter (k <= 32) and
                  make_sharded_counter_wide (33 <= k <= 64): hash-prefix
                  routing of every k-mer (parallel.route.route,
                  route_wide);
                  make_sequence_parallel_counter: one long sequence split
                  over the shards, windows across the cuts from the halo
                  (parallel.halo), then the same routing;
  mesh, k <= 31   make_superkmer_counter: minimizer partition, runs of
                  k-mers that share a minimizer travel as one lane of
                  packed bases (route_payload), selected by kernel K9;
                  make_sharded_minimizer_counter: each k-mer's minimizer
                  routed to its owner and counted (BASELINE config 4).
  lookup service  make_sharded_lookup: queries routed to the shards that
                  own them (route.route_queries), answered there by binary
                  search or by merge (count.lookup_merge: K3 with its
                  source-index plane, K4), and carried home (on one card,
                  the binary search's step replayed as CUDA graphs);
                  lookup_sharded looks each query up in its owner's table.
  two-axis mesh   every sharded factory takes `axis` ("d" by default):
                  the step runs its one-axis body over each group of that
                  axis (mesh.axis_groups), as JAX's shard_map over one axis
                  of a ("d", "s") mesh runs on every device.

A sharded step takes this process's rows and returns one table per local
shard (on its device) and its metrics summed over every shard of the
mesh, every process's, on the mesh's first local device
(parallel.mesh: one process, or several over torch.distributed).
"""

from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional

import torch

from .. import profiling
from ..core import u64
from ..core.spec import (MAX_K, MAX_WIDE_K, NARROW_MAX_K, WORD_K, KmerSpec,
                         check_k_range)
from ..kernels import lookup as klookup
from ..kernels import merge as kmerge
from ..kernels import minimizer as kmini
from ..kernels import window as kwin
from ..kernels import window_wide as kww
from ..ops import encoding, kmer
from ..ops import hash as hash_ops
from ..ops import minimizer as mini_ops
from . import count as count_ops
from . import halo as halo_ops
from . import mesh as mesh_ops
from . import route as route_ops
from .count import UnitTable, UnitTableWide

AGGREGATES = ("compact", "runlength", "unit")


class CountResult(NamedTuple):
    table: object        # a table, or a list of them (one per shard)
    metrics: Dict[str, torch.Tensor]


def _count_metrics(n_reads: int, n_win: int,
                   emitted: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch counters; tensors stay on the device (no sync)."""
    return {
        "reads": n_reads,
        "kmers_emitted": emitted,
        "windows_skipped": n_reads * n_win - emitted,
    }


def _resolve_aggregate(compact: bool, aggregate: Optional[str]) -> str:
    if aggregate is None:
        return "compact" if compact else "runlength"
    if aggregate not in AGGREGATES:
        raise ValueError(f"aggregate must be one of {AGGREGATES}, got "
                         f"{aggregate!r}")
    return aggregate


def _resolve_k(k, spec: Optional[KmerSpec]) -> int:
    """`k` may be an int or a KmerSpec, or None with `spec` given."""
    if isinstance(k, KmerSpec):
        if spec is not None and spec is not k:
            raise ValueError("pass the KmerSpec once, as k or as spec")
        return k.k
    if spec is not None:
        if k is not None and k != spec.k:
            raise ValueError(f"k={k} contradicts spec.k={spec.k}")
        return spec.k
    if k is None:
        raise TypeError("pass k or spec")
    return k


def canonical_kmers(reads: torch.Tensor, k: int):
    """[B, L] uint8 reads -> (canonical int64 words [B, L], valid [B, L])."""
    win = kmer.kmer_windows(reads, k)
    return kmer.canonical_word(win.fw, win.rc), win.valid


def canonical_kmers_wide(reads: torch.Tensor, k: int):
    """canonical_kmers for 33 <= k <= 64: ((hi, lo) words, valid)."""
    win = kmer.kmer_windows_wide(reads, k)
    return kmer.canonical_word_wide(win.fw, win.rc), win.valid


def _unit_result(keys: tuple, n_reads: int, n_win: int) -> CountResult:
    """A unit table from a window kernel's folded key planes."""
    table = UnitTable(*keys) if len(keys) == 2 else UnitTableWide(tuple(keys))
    return CountResult(table, _count_metrics(n_reads, n_win,
                                             (keys[0] >= 0).sum()))


def _counted(count_words, canon, valid, n_reads: int, n_win: int, k: int,
             mode: str) -> CountResult:
    """The compact or run-length table of canonical words."""
    return CountResult(
        count_words(canon, valid, max_k=k, compact=mode == "compact"),
        _count_metrics(n_reads, n_win, valid.sum()))


def count_reads(reads: torch.Tensor, k=None, compact: bool = True,
                aggregate: Optional[str] = None,
                spec: Optional[KmerSpec] = None) -> CountResult:
    """[B, L] uint8 ASCII reads, k <= 32 -> one table of the batch
    (kmers_tpu/parallel/pipeline.py:107).  "unit" (k <= 31) runs the
    window kernel K2; the other forms the plain windows and count_words
    (K11 for "compact", K10 for "runlength" at k <= 31)."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    n_win = reads.shape[-1] - k + 1
    if mode == "unit":
        check_k_range(k, 1, NARROW_MAX_K, "count_reads (unit)")
        return _unit_result(kwin.pack_canonical_keys(reads, k),
                            reads.shape[0], n_win)
    check_k_range(k, 1, WORD_K, "count_reads")
    return _counted(count_ops.count_words, *canonical_kmers(reads, k),
                    reads.shape[0], n_win, k, mode)


def count_reads_packed(words: torch.Tensor, validbits: torch.Tensor,
                       k=None, compact: bool = True,
                       aggregate: Optional[str] = None,
                       spec: Optional[KmerSpec] = None) -> CountResult:
    """count_reads over packed ingest ([B, L/16] code words + [B, L/32]
    validity bitmaps, int32); "unit" runs window kernel K1
    (kmers_tpu/parallel/pipeline.py:153)."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    n_win = words.shape[-1] * 16 - k + 1
    if mode == "unit":
        check_k_range(k, 1, NARROW_MAX_K, "count_reads_packed (unit)")
        return _unit_result(kwin.pack_canonical_keys_packed(words, validbits,
                                                            k),
                            words.shape[0], n_win)
    check_k_range(k, 1, WORD_K, "count_reads_packed")
    win = kmer.kmer_windows_packed(words, validbits, k)
    return _counted(count_ops.count_words,
                    kmer.canonical_word(win.fw, win.rc), win.valid,
                    words.shape[0], n_win, k, mode)


def count_reads_wide(reads: torch.Tensor, k=None, compact: bool = True,
                     aggregate: Optional[str] = None,
                     spec: Optional[KmerSpec] = None) -> CountResult:
    """[B, L] uint8 ASCII reads, 33 <= k <= 64 -> one table of 128-bit
    keys (kmers_tpu/parallel/pipeline.py:363); "unit" (k <= 63) runs the
    wide window kernel K7."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    n_win = reads.shape[-1] - k + 1
    if mode == "unit":
        check_k_range(k, WORD_K + 1, MAX_K, "count_reads_wide (unit)")
        return _unit_result(kww.pack_canonical_keys_wide(reads, k),
                            reads.shape[0], n_win)
    check_k_range(k, WORD_K + 1, MAX_WIDE_K, "count_reads_wide")
    return _counted(count_ops.count_words_wide,
                    *canonical_kmers_wide(reads, k), reads.shape[0], n_win,
                    k, mode)


def count_reads_packed_wide(words: torch.Tensor, validbits: torch.Tensor,
                            k=None, compact: bool = True,
                            aggregate: Optional[str] = None,
                            spec: Optional[KmerSpec] = None) -> CountResult:
    """count_reads_wide over packed ingest.  The packed wide windows have
    no kernel in the JAX package either: they are ops.kmer's torch code on
    every device (kmers_tpu/parallel/pipeline.py:398)."""
    k = _resolve_k(k, spec)
    mode = _resolve_aggregate(compact, aggregate)
    check_k_range(k, WORD_K + 1, MAX_K if mode == "unit" else MAX_WIDE_K,
                  f"count_reads_packed_wide ({mode})")
    win = kmer.kmer_windows_packed_wide(words, validbits, k)
    canon = kmer.canonical_word_wide(win.fw, win.rc)
    if mode == "unit":
        return CountResult(count_ops.unit_table_wide(canon, win.valid),
                           _count_metrics(words.shape[0], win.n_windows,
                                          win.valid.sum()))
    return _counted(count_ops.count_words_wide, canon, win.valid,
                    words.shape[0], win.n_windows, k, mode)


# -- sharded counting: hash-prefix routing -------------------------------------

def _psums(mesh, per_shard, rows: Optional[int] = None) -> list:
    """Each list of per_shard (one scalar tensor per local shard) summed
    over every shard of the mesh, all through one psum.  With rows (this
    process's batch rows), the rows of every process come last: rows
    itself on one process, else summed in the same collective."""
    multi = rows is not None and mesh.process_count > 1
    vecs = []
    for s, vals in enumerate(zip(*per_shard)):
        if multi:
            vals += (torch.full((), rows if s == 0 else 0, dtype=torch.int64,
                                device=vals[0].device),)
        vecs.append(torch.stack(vals))
    sums = list(mesh_ops.psum(vecs, mesh).unbind())
    return sums + [rows] if rows is not None and not multi else sums


def _check_sharded(aggregate: str, k: int, what: str, lo: int = 1,
                   hi: int = NARROW_MAX_K) -> None:
    """lo <= k <= hi, and a unit table only where the key has a spare flag
    bit: never at k = 32 or 64, whose unit pattern is a real key."""
    _resolve_aggregate(True, aggregate)
    check_k_range(k, lo, hi, what)
    if aggregate == "unit" and k in (WORD_K, MAX_WIDE_K):
        raise ValueError(f"{what}: aggregate='unit' needs a spare key bit, "
                         f"k={k} has none")


def _shard_table(words, valid: torch.Tensor, k: int, aggregate: str):
    """A shard's table of its received words (int64, or (hi, lo) past
    k = 32): the lanes themselves for "unit", else count_words' compact
    table (K11's sort on the card at k <= 31), as the JAX package's
    sharded tails do for "compact" and "runlength"."""
    wide = k > WORD_K
    if aggregate == "unit":
        return (count_ops.unit_table_wide if wide
                else count_ops.unit_table)(words, valid)
    return (count_ops.count_words_wide if wide
            else count_ops.count_words)(words, valid, max_k=k)


def _sharded_count_tail(canon, valid, n_reads: int, n_win: int, mesh,
                        k: int, capacity: int, seed: int, passes: int,
                        aggregate: str) -> CountResult:
    """Shared tail of the sharded count bodies: route (route_wide past
    k = 32), then each local shard's table of the lanes it received.
    n_reads counts this process's rows; the metrics are global."""
    wide = k > WORD_K
    route = route_ops.route_wide if wide else route_ops.route
    routed = route(canon, valid, mesh, capacity, seed, passes=passes)
    emitted, overflow, rerouted, reads = _psums(
        mesh, ([v.sum() for v in valid], [r.overflow for r in routed],
               [r.rerouted for r in routed]), rows=n_reads)
    metrics = {
        "reads": reads,
        "kmers_emitted": emitted,
        "windows_skipped": reads * n_win - emitted,
        "route_overflow": overflow,
        "route_rerouted": rerouted,
        # an 8 B (16 B wide) word + 1 B mask per lane, each of the D
        # shards receiving as many
        "route_bytes": mesh.n_shards * routed[0].valid.numel()
        * (17 if wide else 9),
    }
    with profiling.span("kmers.shard.table"):
        tables = [_shard_table(r.words, r.valid, k, aggregate)
                  for r in routed]
    return CountResult(tables, metrics)


def _windows_tail(make_windows, n_reads: int, **kw) -> CountResult:
    """Each shard's windows (make_windows(): one per local shard) -> their
    canonical words -> the tail."""
    canonical = (kmer.canonical_word_wide if kw["k"] > WORD_K
                 else kmer.canonical_word)
    with profiling.span("kmers.shard.windows"):
        wins = make_windows()
        canon = [canonical(w.fw, w.rc) for w in wins]
    return _sharded_count_tail(canon, [w.valid for w in wins], n_reads,
                               wins[0].n_windows, **kw)


def _sharded_count_body(reads_local, **kw) -> CountResult:
    """Each local shard's [B/D, L] reads -> plain windows -> routed ->
    owned tables."""
    windows = (kmer.kmer_windows_wide if kw["k"] > WORD_K
               else kmer.kmer_windows)
    return _windows_tail(lambda: [windows(r, kw["k"]) for r in reads_local],
                         sum(r.shape[0] for r in reads_local), **kw)


def _sharded_count_body_packed(words_local, validbits_local,
                               **kw) -> CountResult:
    """_sharded_count_body over each shard's packed ingest."""
    windows = (kmer.kmer_windows_packed_wide if kw["k"] > WORD_K
               else kmer.kmer_windows_packed)
    return _windows_tail(
        lambda: [windows(w, v, kw["k"])
                 for w, v in zip(words_local, validbits_local)],
        sum(w.shape[0] for w in words_local), **kw)


def _over_axis(mesh, axis: str, body):
    """fn(*batch): each batch split over `axis` (mesh.batch_sharding), then
    body(*blocks, mesh=group mesh) -> CountResult over every group of the
    axis that holds this process's shards, each group's blocks and its
    one-axis mesh.  One table per local shard, on its device: its group's
    table at its index along the axis, so replicas over the other axis are
    equal; the metrics are the first group's, summed over it (JAX's psum
    over the axis), on mesh[0].  On a one-axis mesh, body over the mesh."""
    mesh = mesh_ops.as_mesh(mesh)
    groups = mesh_ops.axis_groups(mesh, axis)

    def fn(*batch) -> CountResult:
        with profiling.span("kmers.shard.split"):
            blocks = [mesh_ops.batch_sharding(x, mesh, axis) for x in batch]
        tables, metrics = [None] * mesh.n_local, None
        for g in groups:
            res = body(*([b[i] for i in g.local] for b in blocks),
                       mesh=g.mesh)
            for i, t in zip(g.local, res.table):
                tables[i] = t
            metrics = res.metrics if metrics is None else metrics
        return CountResult(tables, metrics)

    return fn


def _sharded_counter(mesh, k: int, route_capacity: int, seed: int,
                     route_passes: int, packed: bool, aggregate: str,
                     axis: str):
    body = _sharded_count_body_packed if packed else _sharded_count_body
    return _over_axis(mesh, axis, lambda *blocks, mesh: body(
        *blocks, mesh=mesh, k=k, capacity=route_capacity, seed=seed,
        passes=route_passes, aggregate=aggregate))


def make_sharded_counter(mesh, k: int, *, route_capacity: int, seed: int = 0,
                         axis: str = "d", route_passes: int = 1,
                         packed: bool = False, aggregate: str = "compact"):
    """A sharded counting step over `mesh` (k <= 32): fn(reads [B, L]
    uint8), or fn(words [B, L/16], validbits [B, L/32]) with packed=True,
    -> CountResult with one table per local shard, holding only the k-mers
    that shard owns (compact by default, K11's sort on the card at
    k <= 31; the routed lanes themselves for aggregate="unit", k <= 31),
    and metrics summed over every shard.  The batch is this process's
    rows (all of them on a one-process mesh; its local_read_slice, or
    make_global_array's value, on a multi-process one), and B must split
    evenly over its local shards.
    The windows are the plain ones of ops.kmer on every device, as in the
    JAX package (pipeline.py:224-243).  At k = 32 "runlength" gives the
    compact table too, as in the JAX package (pipeline.py:206-209).
    On a two-axis mesh the batch splits over `axis` and each local shard
    holds the table of its index along it (_over_axis).

    route_passes > 1 re-routes bucket overflow in extra exchanges (exact
    while every destination load <= passes * capacity); what still
    overflows is counted in metrics["route_overflow"]."""
    _check_sharded(aggregate, k, "make_sharded_counter", hi=WORD_K)
    return _sharded_counter(mesh, k, route_capacity, seed, route_passes,
                            packed, aggregate, axis)


def make_sharded_counter_wide(mesh, k: int, *, route_capacity: int,
                              seed: int = 0, axis: str = "d",
                              route_passes: int = 1, packed: bool = False,
                              aggregate: str = "compact"):
    """make_sharded_counter for 33 <= k <= 64 (kmers_tpu/parallel/
    pipeline.py:464-499): 128-bit words through route_wide (17 wire bytes
    a received lane), each shard's table count_words_wide's compact one,
    or for aggregate="unit" (k <= 63) its UnitTableWide of the routed
    lanes."""
    _check_sharded(aggregate, k, "make_sharded_counter_wide", WORD_K + 1,
                   MAX_WIDE_K)
    return _sharded_counter(mesh, k, route_capacity, seed, route_passes,
                            packed, aggregate, axis)


def gather_tables(tables, mesh):
    """One step's per-local-shard tables (one form and shape) as one table
    on mesh[0] holding every shard's, each plane stacked [D, ...] in
    global shard order (across processes an all_gather, so that every
    process holds the same stack): unit tables (narrow or wide) for the
    streaming merge, compact ones for merge_many, which reads [D, cap]
    shard tables as the JAX package's does."""
    mesh = mesh_ops.as_mesh(mesh)
    t = tables[0]
    keys = tuple(mesh_ops.gather([s.keys[i] for s in tables], mesh)
                 for i in range(len(t.keys)))
    if isinstance(t, UnitTable):
        return UnitTable(*keys)
    if isinstance(t, UnitTableWide):
        return UnitTableWide(keys)
    n_unique = sum(s.n_unique for s in tables)
    if mesh.process_count > 1:
        n_unique = int(mesh_ops.psum(
            [torch.full((), n_unique, dtype=torch.int64, device=mesh[0])],
            mesh))
    return count_ops.make_table(
        keys, mesh_ops.gather([s.counts for s in tables], mesh), n_unique)


def global_table(result: CountResult, mesh=None,
                 axis: str = "d") -> count_ops.CountTable:
    """One key-sorted CountTable from a sharded result's per-shard tables
    of any form, on the first shard's device: merge_many's weighted
    re-count (kmers_tpu/parallel/pipeline.py:299-313).  It re-counts
    across shards, so it is exact for the minimizer partition too, whose
    shards are not key-disjoint.  A multi-process result holds this
    process's shards only: pass its mesh, and every process's tables are
    gathered (a collective: every process calls it) and every process
    gets the whole table.  Under a process group without a mesh it
    raises rather than merge a part.  A two-axis result holds replicas:
    pass its mesh and axis, and one group's tables are merged."""
    tables = result.table
    if mesh is not None:
        group = mesh_ops.axis_groups(mesh, axis)[0]
        tables, mesh = [tables[i] for i in group.local], group.mesh
    if mesh is not None and mesh.process_count > 1:
        tables = [gather_tables(tables, mesh)]
    elif mesh is None and mesh_ops.process_count() > 1:
        raise ValueError("global_table of a multi-process result needs its "
                         "mesh (the other processes hold the other shards)")
    return count_ops.merge_many(tables)


# -- sequence-parallel counting (one long sequence) ---------------------------

def make_sequence_parallel_counter(mesh, k: int, *, route_capacity: int,
                                   seed: int = 0, axis: str = "d",
                                   route_passes: int = 1):
    """Count the k-mers of ONE long sequence split contiguously over
    `mesh` (kmers_tpu/parallel/pipeline.py:509-556): fn(seq [G] uint8
    ASCII, G divisible by the number of shards) -> CountResult with, per
    local shard, the compact table of the k-mers it owns (count_words,
    K11's sort on the card at k <= 31; count_words_wide past k = 32) and
    metrics kmers_emitted, route_overflow, route_rerouted.  Each shard
    windows its block extended by the halo (halo.sharded_windows), and the
    canonical words route as make_sharded_counter's do.  On a
    multi-process mesh, seq is this process's contiguous part of the
    sequence, G / P bases (process p's the p-th), or make_global_array's
    value of it.  On a two-axis mesh the sequence splits over `axis`
    (this process's part: the blocks of the `axis` indices it holds)."""
    check_k_range(k, 1, MAX_WIDE_K, "make_sequence_parallel_counter")
    windows = (halo_ops.sharded_windows_wide if k > WORD_K
               else halo_ops.sharded_windows)

    def body(blocks, mesh) -> CountResult:
        res = _windows_tail(lambda: windows(blocks, k, mesh), 1, mesh=mesh,
                            k=k,
                            capacity=route_capacity, seed=seed,
                            passes=route_passes, aggregate="compact")
        return CountResult(res.table, {
            m: res.metrics[m]
            for m in ("kmers_emitted", "route_overflow", "route_rerouted")})

    step = _over_axis(mesh, axis, body)

    def fn(seq) -> CountResult:
        return step(seq.reshape(-1) if isinstance(seq, torch.Tensor)
                    else seq)

    return fn


# -- sharded counting: super-k-mers (minimizer partition) ----------------------
#
# Consecutive k-mers mostly share their minimizer, so a run of r of them
# travels as ONE lane of packed bases (r + k - 1 <= 2k - w bases) to the
# shard owning the minimizer, instead of r separate words.  Minimizers
# are selected on the forward strand while the counted key is canonical,
# so a k-mer met as a reverse complement elsewhere may land on another
# shard: per-shard tables are NOT key-disjoint, and every consumer
# (global_table, the streaming consolidation) re-counts across shards
# (kmers_tpu/parallel/pipeline.py:606-626).

def _superkmer_payload_words(k: int, w: int) -> int:
    """uint32 words of a super-k-mer's packed bases: a minimizer serves
    at most k-w+1 consecutive windows, spanning <= 2k-w bases."""
    return -(-(2 * (2 * k - w)) // 32)


def _superkmer_layout(k: int, w: int):
    """(nwords, meta_off, fold): where the run's window count (meta,
    <= k-w+1 <= 31, 5 bits) lives.  When the last payload plane has >= 5
    spare bits above the packed bases (fold), meta rides there; a
    receiver's window j reads bits < 2*(2k-w) only and masks to 2k bits."""
    nwords = _superkmer_payload_words(k, w)
    meta_off = 2 * (2 * k - w) - 32 * (nwords - 1)
    return nwords, meta_off, meta_off <= 27


def emit_superkmers(reads_local: torch.Tensor, k: int, w: int, seed: int):
    """Super-k-mers of each row: (owner words int64 [B, L], start bool
    [B, L], planes, kmers_emitted), planes = nwords packed-base int32
    planes (uint32 bit patterns) plus, unless folded, a meta plane (the
    run's window count c).  Lanes are k-mer window positions, live at run
    starts only.  A run is a maximal stretch of windows with the same
    minimizer position; minimizers come from K9 under the mix16 order
    (its plain version for a CPU tensor)."""
    check_k_range(k, 1, NARROW_MAX_K, "emit_superkmers")
    check_k_range(w, 1, k, "emit_superkmers (w)")
    B, L = reads_local.shape
    wh, wl, pos, v8 = kmini.minimizer_kernel(reads_local, k, w, seed=seed,
                                             order="mix16")
    valid = v8.bool()
    dev = reads_local.device
    col = torch.arange(L, device=dev).expand(B, L)
    prev_valid = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                            valid[:, :-1]], 1)
    prev_pos = torch.cat([torch.full((B, 1), -1, dtype=pos.dtype, device=dev),
                          pos[:, :-1]], 1)
    start = valid & (~prev_valid | (prev_pos != pos))
    # the next run start or invalid window strictly after p (every run
    # ends by window L-k: structurally invalid lanes follow)
    m = torch.where(start | ~valid, col, L)
    ns_incl = torch.cummin(m.flip(1), dim=1).values.flip(1)
    ns_excl = torch.cat([ns_incl[:, 1:],
                         torch.full((B, 1), L, dtype=m.dtype, device=dev)], 1)
    c = torch.where(start, ns_excl - col, 0)
    nwords, meta_off, fold = _superkmer_layout(k, w)
    w16 = kmer.pack_u32_words(encoding.ascii_to_codes(reads_local))
    planes = [kmer._shift_left(w16, 16 * j) for j in range(nwords)]
    if fold:
        # meta rides the last plane's spare bits, above its masked payload
        planes[-1] = (planes[-1] & u64.mask(meta_off)) | (c << meta_off)
    else:
        planes.append(c)
    return (u64.join_planes(wh, wl), start,
            tuple(u64.low32_as_int32(p) for p in planes), valid.sum())


def expand_superkmers(planes, valid: torch.Tensor, k: int, w: int):
    """Receiver side: [N] super-k-mer lanes -> (forward window words int64
    [N, W], validity [N, W]), W = k-w+1.  The int32 planes are read as
    uint32 values in int64, so every shift is logical; window j is bits
    [2j, 2j + 2k) of the packed bases, so the folded meta bits never reach
    a window."""
    W = k - w + 1
    _, meta_off, fold = _superkmer_layout(k, w)
    p64 = [u64.as_uint32(p) for p in planes]
    if fold:
        pw, meta = p64, u64.shr(p64[-1], meta_off) & 31
    else:
        pw, meta = p64[:-1], p64[-1]
    zeros = torch.zeros_like(pw[0])
    word_at = lambda i: pw[i] if i < len(pw) else zeros
    words = []
    for j in range(W):
        b, off = divmod(2 * j, 32)
        x = word_at(b) | (word_at(b + 1) << 32)
        if off:
            x = u64.shr(x, off) | (word_at(b + 2) << (64 - off))
        words.append(x & u64.mask(2 * k))
    idx = torch.arange(W, device=valid.device)
    return (torch.stack(words, -1),
            valid[..., None] & (idx < meta[..., None]))


def _prefilter_superkmers(owner: torch.Tensor, start: torch.Tensor, planes,
                          budget: int, meta_off: Optional[int],
                          n_planes: int):
    """Compact the run-start lanes to the front (compress kernel K4, three
    planes a pass over one keep mask, so the passes stay lane-aligned)
    and keep the first `budget` of them.  Returns (owner', valid',
    planes', dropped_weight): the k-mers (meta) of the start lanes past
    the budget are counted, never silently dropped."""
    keep = start.reshape(-1).to(torch.uint8)
    flat = list(u64.split_word(owner.reshape(-1))) + [
        p.reshape(-1) for p in planes]
    zeros = torch.zeros_like(flat[0])
    outs = []
    for i in range(0, len(flat), 3):
        chunk = flat[i:i + 3]
        outs.extend(kmerge.compress_flagged(
            *(chunk + [zeros] * (3 - len(chunk))), keep))
    outs = outs[:len(flat)]
    n = outs[0].shape[0]
    n_start = start.sum()
    n_cap = min(budget, n)
    pos = torch.arange(n, device=start.device)
    meta = u64.as_uint32(outs[2 + n_planes - 1])
    if meta_off is not None:
        meta = u64.shr(meta, meta_off) & 31
    dropped_w = torch.where((pos >= n_cap) & (pos < n_start), meta, 0).sum()
    valid = pos[:n_cap] < torch.clamp(n_start, max=n_cap)
    return (u64.join_planes(outs[0][:n_cap], outs[1][:n_cap]), valid,
            tuple(o[:n_cap] for o in outs[2:2 + n_planes]), dropped_w)


def make_superkmer_counter(mesh, k: int, w: int, *, route_capacity: int,
                           seed: int = 0, axis: str = "d",
                           route_passes: int = 1, aggregate: str = "unit"):
    """A sharded counting step with super-k-mer routing (k <= 31), the
    `--partition minimizer` pipeline: fn(reads [B, L] uint8) ->
    CountResult with one table per shard (unit, of [passes * D * C, k-w+1]
    lanes, by default; aggregate="compact" counts each shard's windows
    with count_words) and metrics: reads, kmers_emitted, windows_skipped,
    superkmers (run starts), route_overflow (in K-MERS: the weight of the
    dropped runs, prefilter drops included), route_rerouted and
    route_bytes.

    The global table after the cross-shard re-count equals single-device
    counting.  route_capacity is a budget of super-k-mers per destination.
    Each shard's run starts are compacted with K4 before the owner sort
    and passes * D * C of them kept (the JAX package's prefilter, which
    it runs on the TPU only), on every device: unless that budget
    truncates, the routed lanes are those of routing every lane."""
    _check_sharded(aggregate, k, "make_superkmer_counter")
    check_k_range(w, 1, k, "make_superkmer_counter (w)")
    nwords, meta_off, fold = _superkmer_layout(k, w)
    n_planes = nwords if fold else nwords + 1

    def body(blocks, mesh) -> CountResult:
        d = mesh.n_shards
        owners, starts, planes, kmers, n_sk, cap_dropped = ([] for _ in range(6))
        for r in blocks:
            owner, start, pl, km = emit_superkmers(r, k, w, seed)
            n_sk.append(start.sum())
            kmers.append(km)
            owner, start, pl, dw = _prefilter_superkmers(
                owner, start, pl, route_passes * d * route_capacity,
                meta_off if fold else None, n_planes)
            cap_dropped.append(dw)
            owners.append(owner)
            starts.append(start)
            planes.append(pl)
        routed = route_ops.route_payload(
            owners, starts, planes, mesh, route_capacity, seed,
            passes=route_passes, weight_plane=n_planes - 1,
            weight_shift=meta_off if fold else 0,
            weight_mask=31 if fold else None)
        tables = []
        for rp in routed:
            fw, wv = expand_superkmers(rp.planes, rp.valid, k, w)
            canon = kmer.canonical_word(fw, u64.reverse_complement(fw, k))
            tables.append(_shard_table(canon, wv, k, aggregate))
        emitted, overflow, n_superkmers, rerouted, n_reads = _psums(
            mesh, (kmers, [rp.overflow_weight + dw for rp, dw in zip(
                routed, cap_dropped)], n_sk, [rp.rerouted for rp in routed]),
            rows=sum(b.shape[0] for b in blocks))
        metrics = {
            "reads": n_reads,
            "kmers_emitted": emitted,
            "windows_skipped": n_reads * (blocks[0].shape[-1] - k + 1)
            - emitted,
            "superkmers": n_superkmers,
            "route_overflow": overflow,
            "route_rerouted": rerouted,
            "route_bytes": d * routed[0].valid.numel() * (4 * n_planes + 1),
        }
        return CountResult(tables, metrics)

    return _over_axis(mesh, axis, body)


# -- sharded minimizer bucketing (BASELINE config 4) ---------------------------

def make_sharded_minimizer_counter(mesh, k: int, w: int, *,
                                   route_capacity: int, seed: int = 0,
                                   use_lex: bool = False, axis: str = "d",
                                   route_passes: int = 1):
    """Minimizer bucketing over `mesh` (kmers_tpu/parallel/pipeline.py:561):
    fn(reads [B, L] uint8) -> CountResult with, per shard, a compact
    table of (minimizer w-mer word, number of k-mers it is the minimizer
    of) for the minimizers that shard owns by hash, and metrics
    kmers_emitted, route_overflow, route_rerouted.  Minimizers are the
    plain ops.minimizer stream (mix_hash order, or lex with use_lex), as
    in the JAX package; each shard's table is count_words(max_k=w), K11's
    sort on the card.  Minimizer words repeat along a read, so the
    destination load is skewed: raise route_passes past 1 for exact
    tables; what still overflows is counted."""
    check_k_range(k, 1, NARROW_MAX_K, "make_sharded_minimizer_counter")
    check_k_range(w, 1, k, "make_sharded_minimizer_counter (w)")
    hash_fn = (hash_ops.lex_hash_fn(w) if use_lex
               else hash_ops.mix_hash_fn(seed))

    def body(blocks, mesh) -> CountResult:
        mms = [mini_ops.minimizer_stream(r, k, w, hash_fn) for r in blocks]
        routed = route_ops.route([m.word for m in mms],
                                 [m.valid for m in mms], mesh,
                                 route_capacity, seed, passes=route_passes)
        emitted, overflow, rerouted = _psums(
            mesh, ([m.valid.sum() for m in mms], [r.overflow for r in routed],
                   [r.rerouted for r in routed]))
        metrics = {"kmers_emitted": emitted, "route_overflow": overflow,
                   "route_rerouted": rerouted}
        return CountResult([count_ops.count_words(r.words, r.valid, max_k=w)
                            for r in routed], metrics)

    return _over_axis(mesh, axis, body)


# -- distributed lookup service (kmers_tpu/parallel/pipeline.py:911-970) -------

def make_sharded_lookup(mesh, *, query_capacity: int, seed: int = 0,
                        axis: str = "d", max_k: Optional[int] = None,
                        merge_lookup: Optional[bool] = None):
    """A query step over per-shard count tables: fn(tables, queries,
    valid) -> (counts int32 [Q] on mesh[0], overflow), counts aligned
    with the queries, -1 where a query was invalid or overflowed its
    sender's query_capacity lanes to its owner; overflow summed over
    every shard.

    tables: one compact CountTable per local shard, on its device,
    holding the keys that shard owns by hash (make_sharded_counter's
    tables); queries int64 [Q] and valid bool [Q], this process's (on a
    multi-process mesh each process answers its own queries, on its first
    local device), split over its local shards (mesh.batch_sharding).
    route_queries takes each query to its owner, which answers by
    count.lookup_merge (merge_lookup=True) or the binary search K12
    (kernels/lookup.py; False, and None: on the CPU as the JAX package off
    a TPU, and on the card because chip_smoke.py's phase 13 measured it
    faster at both of its shapes; PERF.md section 6), and the answers
    ride home.  merge_lookup=True with max_k > 31 raises,
    where the JAX package answers wrongly: the merge keys on bit 63.
    On a two-axis mesh the queries split over `axis`, the tables are those
    of a counter over the same axis, and every group of the axis answers
    (the first group's answers and overflow are returned).

    On a mesh of one shard in one process, answering by the binary search,
    a plain-tensor batch of at most query_capacity lanes skips routing,
    which could drop none of them: the search kernel K12
    (kernels/lookup.py) answers it on mesh[0], overflow 0.  Else one
    process whose shards all sit on one card, answering by the binary
    search, runs the step as CUDA graphs (_LookupGraphs): each batch shape
    and set of tables is captured on its first call and replayed after,
    with the same answers as the op-by-op step every other mesh, the
    merge arm and ShardedRows batches run."""
    use_merge = bool(merge_lookup)
    if use_merge and max_k is not None and max_k > NARROW_MAX_K:
        raise ValueError(f"merge_lookup takes k <= {NARROW_MAX_K} keys, "
                         f"max_k={max_k}")

    def answer(table, r):
        if use_merge:
            got = count_ops.lookup_merge(table, r.words, r.valid)
            return torch.where(r.valid, got, -1)
        return klookup.search_counts(table.keys_hi, table.keys_lo,
                                     table.counts, table.n_unique,
                                     r.words.contiguous(),
                                     r.valid.contiguous())

    mesh = mesh_ops.as_mesh(mesh)
    groups = mesh_ops.axis_groups(mesh, axis)

    # every group answers, as every JAX device does; each group's answers
    # are this process's queries'.  Each phase runs for every group in the
    # groups' order, so every process meets each group's collectives in
    # one order
    def route(queries, valid):
        q, v = (mesh_ops.batch_sharding(x, mesh, axis)
                for x in (queries, valid))
        return [route_ops.route_queries(
            [q[i] for i in g.local], [v[i] for i in g.local], g.mesh,
            query_capacity, seed) for g in groups]

    def answer_all(tables, routes):
        return [[answer(tables[i], r) for i, r in zip(g.local, routed)]
                for g, (routed, _) in zip(groups, routes)]

    def reply_all(routes, answers):
        return [(torch.cat([c.to(g.mesh[0]) for c in reply(a)]),
                 mesh_ops.psum([r.overflow for r in routed], g.mesh))
                for g, (routed, reply), a in zip(groups, routes, answers)][0]

    # one process with every shard on one card, answered by the binary
    # search: no collective leaves the card and no phase syncs the host,
    # so the phases are captured as CUDA graphs and replayed
    one_card = (mesh.process_count == 1 and mesh[0].type == "cuda"
                and all(d == mesh[0] for d in mesh) and not use_merge)
    graphs = (_LookupGraphs(mesh[0], route, answer_all, reply_all)
              if one_card else None)

    # one shard in one process, answered by the binary search: a batch
    # that fits query_capacity cannot overflow, so routing would hand every
    # lane back where it was; the search kernel answers it in place
    one_shard = mesh.n_shards == 1 and not use_merge

    def fn(tables, queries: torch.Tensor, valid: torch.Tensor):
        profiling.add("kmers.lookup.calls")
        plain = (isinstance(queries, torch.Tensor)
                 and isinstance(valid, torch.Tensor))
        if one_shard and plain and queries.numel() <= query_capacity:
            profiling.add("kmers.lookup.direct")
            with profiling.span("kmers.lookup.answer"):
                table = tables[0]
                counts = klookup.search_counts(
                    table.keys_hi, table.keys_lo, table.counts,
                    table.n_unique, queries.to(mesh[0]).contiguous(),
                    valid.to(mesh[0]).contiguous())
                return counts, torch.zeros((), dtype=torch.int64,
                                           device=mesh[0])
        if graphs is not None and plain:
            profiling.add("kmers.lookup.replays")
            return graphs(tables, queries, valid)
        with profiling.span("kmers.lookup.route"):
            routes = route(queries, valid)
        with profiling.span("kmers.lookup.answer"):
            answers = answer_all(tables, routes)
        with profiling.span("kmers.lookup.reply"):
            return reply_all(routes, answers)

    return fn


class _LookupGraphs:
    """make_sharded_lookup's step on one card as three CUDA graphs, route,
    answer and reply, each replayed inside its span.  A key (the batch's
    shapes and dtypes, each table's storage, capacity and n_unique: what a
    capture bakes in besides the step's own device) is captured on its
    first call into static input buffers, the three graphs sharing one
    memory pool and replaying in capture order; the KEEP keys used last
    are kept.  A call copies its batch into the buffers, replays, and
    returns copies of the answers and the overflow, which the next replay
    overwrites."""

    KEEP = 4

    def __init__(self, device, route, answer, reply):
        self.device = device
        self.route, self.answer, self.reply = route, answer, reply
        self.captured = collections.OrderedDict()

    def __call__(self, tables, queries: torch.Tensor, valid: torch.Tensor):
        key = (tuple(queries.shape), queries.dtype, tuple(valid.shape),
               valid.dtype,
               tuple((t.keys_hi.data_ptr(), t.keys_lo.data_ptr(),
                      t.counts.data_ptr(), t.capacity, t.n_unique)
                     for t in tables))
        with torch.cuda.device(self.device):
            entry = self.captured.get(key)
            if entry is None:
                if len(self.captured) >= self.KEEP:
                    self.captured.popitem(last=False)
                entry = self.captured[key] = self._capture(tables, queries,
                                                           valid)
            else:
                self.captured.move_to_end(key)
            (q, v), (route, answer, reply), (counts, overflow), _ = entry
            with profiling.span("kmers.lookup.route"):
                q.copy_(queries)
                v.copy_(valid)
                route.replay()
            with profiling.span("kmers.lookup.answer"):
                answer.replay()
            with profiling.span("kmers.lookup.reply"):
                reply.replay()
                return counts.clone(), overflow.clone()

    def _capture(self, tables, queries: torch.Tensor, valid: torch.Tensor):
        """(static inputs, graphs, static outputs, the static tensors
        between the phases) of one key, after a warm-up on a side stream."""
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                       for x in (queries, valid))
        for s, x in zip(static, (queries, valid)):
            s.copy_(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            routes = self.route(*static)
            self.reply(routes, self.answer(tables, routes))
        torch.cuda.current_stream().wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = tuple(torch.cuda.CUDAGraph() for _ in range(3))
        with torch.cuda.graph(graphs[0], pool=pool):
            routes = self.route(*static)
        with torch.cuda.graph(graphs[1], pool=pool):
            answers = self.answer(tables, routes)
        with torch.cuda.graph(graphs[2], pool=pool):
            out = self.reply(routes, answers)
        return static, graphs, out, (routes, answers)


def lookup_sharded(tables, queries: torch.Tensor, n_shards: int,
                   seed: int = 0) -> torch.Tensor:
    """Count of each int64 query word (int32, 0 if absent) from its owner's
    table (route.owner_of) among per-shard tables, on the queries' device
    (kmers_tpu/parallel/pipeline.py:316-336).  Over the minimizer
    partition's shard tables, which are not key-disjoint, a count is only
    the owner's part, as in the JAX package: look up global_table there.
    It takes every shard's table, so a multi-process result's (this
    process's shards only) raises for the count: make_sharded_lookup
    routes the queries to their owners across processes instead."""
    if len(tables) != n_shards:
        raise ValueError(f"{len(tables)} tables for {n_shards} shards")
    owner = route_ops.owner_of(queries, n_shards, seed)
    out = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    for s, table in enumerate(tables):
        got = count_ops.lookup(table, queries.to(table.counts.device))
        out = torch.where(owner == s, got.to(queries.device), out)
    return out
