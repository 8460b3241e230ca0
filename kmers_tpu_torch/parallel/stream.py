"""Streaming k-mer counting over many read batches (counterpart of
``kmers_tpu/parallel/stream.py``): ``StreamingCounter`` on one device,
1 <= k <= 64 (128-bit keys past k = 32), and ``ShardedStreamingCounter``
over a mesh, 1 <= k <= 64 (the minimizer partition k <= 31).

  per batch:    unit emission -- the window kernel's folded canonical keys
                as a count.UnitTable(Wide); no per-batch sort.  k = 32 and
                k = 64 keys fill every bit, so no flag folds in: their
                batches are run-length tables (KmerSpec.aggregate).
  consolidate:  deferred -- batch tables wait in a pending list and merge
                into the main table every `merge_every` batches (and before
                any read of the table).  Unit tables: one sort of the
                pending keys (two stable torch.sorts for 128-bit keys),
                then count.merge_table_with_sorted_units(_wide) (merge and
                run-reduce kernels).  Count tables, key-sorted over their
                live lanes (k = 32's run-length batches, gathered compact
                shard tables): _merge_bounded, count.merge_sorted_tables's
                merges; 128-bit ones _merge_bounded_wide, count.merge_many_
                wide's weighted re-count.  Then _bound_table's eviction if
                the merged table outgrew capacity.

Eviction policy (the JAX package's): past capacity the LOWEST-count
entries go first, ties evict the numerically largest keys, and the
evicted mass is counted in ``dropped_unique`` / ``dropped_kmers``.

``save`` / ``load`` use the JAX package's npz layout, so a checkpoint of
either package resumes in the other.  ``np.savez`` stamps zip members
with the current time, so two saves of one table differ byte for byte:
compare checkpoints with ``npz_digest``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from .. import convert, profiling
from ..core import u64, u128
from ..core.spec import NARROW_MAX_K, KmerSpec, check_k
from . import count as count_ops
from . import mesh as mesh_ops
from . import pipeline


def npz_digest(path: str) -> str:
    """sha256 over an npz's sorted member names and, for each, the array's
    dtype, shape and bytes: equal tables give equal digests whatever the
    zip timestamps."""
    h = hashlib.sha256()
    with np.load(path) as z:
        for name in sorted(z.files):
            a = np.ascontiguousarray(z[name])
            h.update(f"{name}\0{a.dtype.str}\0{a.shape}\0".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _sort_units(pending) -> tuple:
    """One sort of all pending unit keys, unsigned (flagged lanes last)."""
    return count_ops.sort_unit_keys(
        torch.cat([t.keys_hi.reshape(-1) for t in pending]),
        torch.cat([t.keys_lo.reshape(-1) for t in pending]))


def _sort_units_wide(pending) -> tuple:
    """One unsigned 128-bit sort of all pending wide unit keys (flagged
    lanes last): four planes."""
    planes = [torch.cat([t.keys[i].reshape(-1) for t in pending])
              for i in range(4)]
    hi, lo = u128.join_planes(*planes)
    order = u128.argsort(hi, lo)
    return u128.split_planes(hi[order], lo[order])


def _merge_bounded_streaming(table, pending, capacity: int):
    """Sort the pending keys, merge them into the table, bound it.
    Returns (table, dropped_unique, dropped_kmers)."""
    with profiling.span("kmers.consolidate.sort"):
        s_hi, s_lo = _sort_units(pending)
    with profiling.span("kmers.consolidate.merge"):
        merged = count_ops.merge_table_with_sorted_units(table, s_hi, s_lo)
    return _bound_table(merged, capacity)


def _merge_bounded_streaming_wide(table, pending, capacity: int):
    """_merge_bounded_streaming for 128-bit keys (K6 and K4)."""
    with profiling.span("kmers.consolidate.sort"):
        sorted_units = _sort_units_wide(pending)
    with profiling.span("kmers.consolidate.merge"):
        merged = count_ops.merge_table_with_sorted_units_wide(table,
                                                              sorted_units)
    return _bound_table(merged, capacity)


def _merge_bounded(table, pending, capacity: int, max_k=None):
    """The table and the pending tables in one, then _bound_table
    (kmers_tpu/parallel/stream.py:60-64).  Count tables must be key-sorted
    over their live lanes (compact, or globally sorted run-length: not
    K10's per-segment layout) and merge by count.merge_sorted_tables; a
    mix with unit tables takes merge_many's re-count."""
    with profiling.span("kmers.consolidate.merge"):
        if any(isinstance(t, count_ops.UnitTable) for t in pending):
            merged = count_ops.merge_many([table] + list(pending),
                                          max_k=max_k)
        else:
            merged = count_ops.merge_sorted_tables(table, pending, capacity)
    return _bound_table(merged, capacity)


def _merge_bounded_wide(table, pending, capacity: int, max_k=None):
    """_merge_bounded for 128-bit tables (stream.py:171-179)."""
    with profiling.span("kmers.consolidate.merge"):
        merged = count_ops.merge_many_wide([table] + list(pending),
                                           max_k=max_k)
    return _bound_table(merged, capacity)


def _bound_table(merged, capacity: int):
    """Bound a compact key-sorted table (either width) to `capacity`
    slots: a slice when it fits, rank eviction (dead last, count
    descending, key ascending) otherwise.  Returns (table, dropped_unique,
    dropped_kmers)."""
    with profiling.span("kmers.consolidate.bound"):
        nu = merged.n_unique
        if nu <= capacity:
            return count_ops.make_table(
                tuple(p[:capacity] for p in merged.keys),
                merged.counts[:capacity], nu), 0, 0
        cnt = merged.counts[:nu]
        # the live prefix is key-ascending, so a stable sort by count
        # descending ranks (count desc, key asc); the first `capacity` stay
        rank = torch.sort(cnt, descending=True, stable=True).indices
        kept = torch.sort(rank[:capacity]).values      # back to key order
        dropped_kmers = int(cnt[rank[capacity:]].to(torch.int64).sum())
        out = count_ops.make_table(tuple(p[kept] for p in merged.keys),
                                   cnt[kept], capacity)
        return out, nu - capacity, dropped_kmers


def _as_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """numpy (uint32 read as int32 bit patterns) or tensor, checked."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise TypeError(f"batch dtype {t.dtype}, want {dtype}")
    return t


def _to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy (uint32 read as int32 bit patterns) or tensor -> device."""
    return _as_tensor(a, dtype).to(device).contiguous()


class StreamingCounter:
    """Fold read batches into one fixed-capacity canonical k-mer table on
    `device`: k <= 32 keys are one 64-bit word (two int32 planes),
    33 <= k <= 64 keys 128 bits (four planes) through the whole stack --
    windows, sort, merge, eviction, lookup, checkpoint.  Batches are unit
    tables, or run-length tables at k = 32 and k = 64."""

    def __init__(self, k, capacity: int, merge_every: int = 16, *, device):
        self.spec = k if isinstance(k, KmerSpec) else KmerSpec(k)
        check_k(self.spec.k)
        self.k = self.spec.k
        self.wide = self.spec.wide
        self.capacity = capacity
        self.merge_every = max(1, merge_every)
        self.device = torch.device(device)
        empty = (count_ops.empty_table_wide if self.wide
                 else count_ops.empty_table)
        self.table = empty(capacity, self.device)
        self._pending = []
        self._pending_kmers = []
        self.batches = 0
        self.kmers = 0
        self.dropped_unique = 0
        self.dropped_kmers = 0

    def update(self, reads) -> None:
        """Count one [B, L] uint8 ASCII batch; consolidation is deferred."""
        count = pipeline.count_reads_wide if self.wide else pipeline.count_reads
        with profiling.span("kmers.emit"):
            with profiling.span("kmers.emit.upload"):
                reads = _to_device(reads, torch.uint8, self.device)
            with profiling.span("kmers.emit.count"):
                res = count(reads, self.k, aggregate=self.spec.aggregate)
        # the batch's device copy goes before _absorb may consolidate
        del reads
        self._absorb(res)

    def update_packed(self, words, validbits) -> None:
        """Count one packed batch ([B, L/16] code words + [B, L/32]
        validity bitmaps, io.fastx.read_packed_batches layout)."""
        count = (pipeline.count_reads_packed_wide if self.wide
                 else pipeline.count_reads_packed)
        with profiling.span("kmers.emit"):
            with profiling.span("kmers.emit.upload"):
                words = _to_device(words, torch.int32, self.device)
                validbits = _to_device(validbits, torch.int32, self.device)
            with profiling.span("kmers.emit.count"):
                res = count(words, validbits, self.k,
                            aggregate=self.spec.aggregate)
        # the batch's device copies go before _absorb may consolidate
        del words, validbits
        self._absorb(res)

    def _absorb(self, res) -> None:
        self._pending.append(res.table)
        self._pending_kmers.append(res.metrics["kmers_emitted"])
        self.batches += 1
        if len(self._pending) >= self.merge_every:
            self._consolidate()

    def _consolidate(self) -> None:
        if not self._pending:
            return
        with profiling.span("kmers.consolidate"):
            pending = list(self._pending)
            # pad to merge_every with all-dead tables, as the JAX package
            # does (there to keep one compiled executable)
            if (len({t.capacity for t in pending}) == 1
                    and len(pending) < self.merge_every):
                empty = count_ops.empty_like_table(pending[0])
                pending += [empty] * (self.merge_every - len(pending))
            if all(isinstance(t, (count_ops.UnitTable,
                                  count_ops.UnitTableWide))
                   for t in pending):
                merge = (_merge_bounded_streaming_wide if self.wide
                         else _merge_bounded_streaming)
                new_table, du, dk = merge(self.table, pending, self.capacity)
            else:
                merge = _merge_bounded_wide if self.wide else _merge_bounded
                new_table, du, dk = merge(self.table, pending, self.capacity,
                                          max_k=self.k)
            # commit only after the merge completed: a fault raises before
            # any counter moves, so discard_pending rewinds batches and kmer
            # mass together
            kmers_add = int(torch.stack(self._pending_kmers).sum())
            self.table = new_table
            self.kmers += kmers_add
            self._pending_kmers = []
            self._pending = []
            self.dropped_unique += du
            self.dropped_kmers += dk

    def discard_pending(self) -> None:
        """Roll back unconsolidated batches after a mid-stream failure: the
        batch counter rewinds with them, so a resume recounts exactly
        those batches."""
        self.batches -= len(self._pending)
        self._pending = []
        self._pending_kmers = []

    def lookup(self, words) -> torch.Tensor:
        """Counts (int32) of canonical query words: an int64 tensor
        (k <= 32; u64.from_ints makes one of unsigned ints) or a (hi, lo)
        pair of int64 tensors (k > 32)."""
        self._consolidate()
        if self.wide:
            return count_ops.lookup_wide(
                self.table, *(w.to(self.device) for w in words))
        return count_ops.lookup(self.table, words.to(self.device))

    def to_pairs(self):
        """Host-side [(word, count)] of live slots, sorted by word; words
        are unsigned Python ints (128-bit past k = 32)."""
        self._consolidate()
        nu = self.table.n_unique
        live = [p[:nu] for p in self.table.keys]
        if self.wide:
            keys = u128.to_ints(*u128.join_planes(*live))
        else:
            keys = u64.to_ints(u64.join_planes(*live).cpu())
        counts = self.table.counts[:nu].cpu().tolist()
        return list(zip(keys, counts))

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic checkpoint in the JAX package's npz layout: a temp file
        in the same directory, then os.replace, so a crash never leaves a
        truncated checkpoint."""
        self._consolidate()
        final = path if path.endswith(".npz") else path + ".npz"
        # one temp file per process: the processes of a multi-process
        # counter each write the same table
        tmp = f"{final}.{os.getpid()}.tmp.npz"
        with profiling.span("kmers.save"):
            with profiling.span("kmers.save.fetch"):
                arrays = convert.table_to_numpy(self.table)
            with profiling.span("kmers.save.write"):
                np.savez(
                    tmp,
                    k=np.int64(self.k),
                    capacity=np.int64(self.capacity),
                    batches=np.int64(self.batches),
                    kmers=np.int64(self.kmers),
                    dropped_unique=np.int64(self.dropped_unique),
                    dropped_kmers=np.int64(self.dropped_kmers),
                    **arrays,
                )
                os.replace(tmp, final)

    @staticmethod
    def load(path: str, *, device) -> "StreamingCounter":
        """A counter from a checkpoint of either package, either key
        layout (``keys_hi``... for k <= 32, ``keys_hi_hi``... past it)."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            sc = StreamingCounter(int(z["k"]), int(z["capacity"]),
                                  device=device)
            table = convert.table_from_npz(z, device)
            if isinstance(table, count_ops.CountTableWide) != sc.wide:
                raise ValueError(f"{path}: key planes do not fit k={sc.k}")
            sc.table = table
            sc.batches = int(z["batches"])
            sc.kmers = int(z["kmers"])
            sc.dropped_unique = int(z["dropped_unique"])
            sc.dropped_kmers = int(z["dropped_kmers"])
        return sc


class ShardedStreamingCounter(StreamingCounter):
    """StreamingCounter over a mesh (1 <= k <= 64): each batch splits by
    rows over the shards, its k-mers travel to their owning shards
    (partition="hash": every k-mer, route.route or route_wide past
    k = 32; "minimizer", k <= 31: runs of k-mers sharing a minimizer as
    packed super-k-mers, route_payload), and each shard's received lanes
    become a pending table on its device: a unit table, or at k = 32 and
    k = 64 a compact one.  At consolidation the pending shard tables are
    gathered to the table's device (the mesh's first) and merge as the
    single-device counter's do, so the table is the same.  Routing
    overflow is counted per batch (route_overflow in k-mers,
    route_rerouted) and committed with the merge, as are the super-k-mer
    count and the wire bytes of the send buffers (route_superkmers,
    route_bytes); raise route_capacity or route_passes until
    route_overflow is 0 for exact tables.

    Over a multi-process mesh (kmers_tpu/parallel/stream.py:437-574) every
    process builds the counter over the same global mesh and feeds
    update / update_packed its own rows of each batch (local_read_slice),
    the same number of times; a consolidation gathers the pending shard
    tables of every process, so each merges the same stack and holds the
    same table (JAX's replicated table), and the committed counters are
    global.  save, to_pairs and lookup consolidate first, so every process
    calls them, and each save writes the whole table, as the JAX
    package's does on every process.  The mesh has one axis, as the JAX
    package's counter's (a two-axis mesh raises ValueError)."""

    def __init__(self, k, capacity: int, merge_every: int = 16, *,
                 mesh=None, n_devices: Optional[int] = None,
                 route_capacity: int = 4096, route_passes: int = 1,
                 seed: Optional[int] = None, partition: str = "hash",
                 minimizer_w: Optional[int] = None):
        mesh = (mesh_ops.one_axis(mesh, "ShardedStreamingCounter")
                if mesh is not None else mesh_ops.make_mesh(n_devices))
        # the table lives on the first local device of every process
        super().__init__(k, capacity, merge_every, device=mesh[0])
        if partition not in ("hash", "minimizer"):
            raise ValueError(f"partition must be 'hash' or 'minimizer', "
                             f"got {partition!r}")
        if partition == "minimizer" and self.k > NARROW_MAX_K:
            raise ValueError("minimizer partitioning needs k <= 31")
        # seed and minimizer width default from the spec; kwargs win
        seed = self.spec.seed if seed is None else seed
        if minimizer_w is None:
            minimizer_w = self.spec.w if self.spec.w is not None else 11
        self.mesh = mesh
        self.n_devices = mesh.n_shards
        self.route_capacity = route_capacity
        self.route_passes = route_passes
        self.partition = partition
        self.route_overflow = 0
        self.route_rerouted = 0
        self.route_superkmers = 0
        self.route_bytes = 0
        self._pending_overflow = []
        route = dict(route_capacity=route_capacity, route_passes=route_passes,
                     seed=seed, aggregate=self.spec.aggregate)
        if partition == "minimizer":
            self._scount = pipeline.make_superkmer_counter(
                mesh, self.k, minimizer_w, **route)
            self._scount_packed = None    # super-k-mers start from ASCII
        else:
            mk = (pipeline.make_sharded_counter_wide if self.wide
                  else pipeline.make_sharded_counter)
            self._scount = mk(mesh, self.k, **route)
            self._scount_packed = mk(mesh, self.k, packed=True, **route)

    def _pad_rows(self, t: torch.Tensor, fill: int) -> torch.Tensor:
        """Pad this process's rows with `fill` rows so that they split over
        its local shards (kmers_tpu/parallel/stream.py:518-526); an empty
        slice becomes one row a shard, since every process steps."""
        n = self.mesh.n_local
        short = -t.shape[0] % n if t.shape[0] else n
        if not short:
            return t
        filler = torch.full((short,) + tuple(t.shape[1:]), fill,
                            dtype=t.dtype, device=t.device)
        return torch.cat([t, filler])

    def update(self, reads) -> None:
        with profiling.span("kmers.emit"):
            rows = self._pad_rows(_as_tensor(reads, torch.uint8), ord("N"))
            res = self._scount(rows)
        self._absorb_sharded(res)

    def update_packed(self, words, validbits) -> None:
        if self._scount_packed is None:
            raise NotImplementedError(
                "minimizer partitioning counts from ASCII batches "
                "(use update / --ascii-ingest)")
        with profiling.span("kmers.emit"):
            res = self._scount_packed(
                self._pad_rows(_as_tensor(words, torch.int32), 0),
                self._pad_rows(_as_tensor(validbits, torch.int32), 0))
        self._absorb_sharded(res)

    def _absorb_sharded(self, res) -> None:
        # device scalars only: fetching here would sync every batch
        self._pending_overflow.append(
            (res.metrics["route_overflow"], res.metrics["route_rerouted"],
             res.metrics.get("superkmers"), res.metrics["route_bytes"]))
        self._absorb(res)

    def discard_pending(self) -> None:
        super().discard_pending()
        self._pending_overflow = []

    def _consolidate(self) -> None:
        # gather each pending batch's shard tables, every process's, to
        # the table's device
        if self._pending:
            with profiling.span("kmers.consolidate.gather"):
                self._pending = [pipeline.gather_tables(p, self.mesh)
                                 if isinstance(p, list) else p
                                 for p in self._pending]
        super()._consolidate()
        # the overflow counters commit only after the merge succeeded (it
        # raised otherwise), as the k-mer mass does: discard_pending's
        # rewind leaves them consistent
        for ov, rr, sk, nbytes in self._pending_overflow:
            self.route_overflow += int(ov)
            self.route_rerouted += int(rr)
            self.route_bytes += nbytes
            if sk is not None:
                self.route_superkmers += int(sk)
        self._pending_overflow = []


def auto_merge_every(capacity: int, batch_lanes: int) -> int:
    """Consolidation cadence balancing the merge's two lane terms
    (capacity / merge_every against batch_lanes), clamped to [8, 64].
    batch_lanes is pending_table_lanes()."""
    return max(8, min(64, capacity // max(1, batch_lanes)))


def pending_table_lanes(batch: int, length: int, devices: int = 1,
                        route_capacity: int = 4096, route_passes: int = 1,
                        partition: str = "hash", k: int = 0,
                        minimizer_w: int = 11) -> int:
    """Lane count of one pending per-batch table.  Single device: the
    batch's window lanes, batch * length.  Sharded: each of the D shards
    receives passes * D * route_capacity lanes, so passes * D^2 *
    route_capacity, times k - w + 1 windows per super-k-mer lane under
    the minimizer partition."""
    if devices > 1:
        lanes = route_passes * devices * devices * route_capacity
        if partition == "minimizer":
            lanes *= max(1, k - minimizer_w + 1)
        return lanes
    return batch * length


def count_fastx(path: str, k: int, capacity: int, *, device,
                batch: int = 256, length: int = 256, merge_every: int = 0,
                counter: Optional[StreamingCounter] = None,
                packed: bool = True, prefetch_depth: int = 512,
                devices: int = 1, route_capacity: int = 4096,
                route_passes: int = 1, partition: str = "hash",
                minimizer_w: int = 11) -> StreamingCounter:
    """Count every k-mer of a FASTA/FASTQ file on `device`.  Pass
    `counter` to resume from a checkpoint (or to bring a counter of one's
    own, e.g. a ShardedStreamingCounter over an explicit mesh).
    packed=True ships 2-bit words + validity bitmaps (needs length % 32 ==
    0, else ASCII rows; the minimizer partition always takes ASCII rows).
    devices > 1 shards the count over that many devices of `device`'s
    kind (mesh.mesh_for).  One process, as in the JAX package: every
    batch is the file's; a multi-process count feeds each process's
    local_read_slice to update_packed by hand."""
    from ..io import fastx

    if merge_every <= 0:
        merge_every = auto_merge_every(capacity, pending_table_lanes(
            batch, length, devices=devices, route_capacity=route_capacity,
            route_passes=route_passes, partition=partition, k=k,
            minimizer_w=minimizer_w))
    if counter is not None:
        sc = counter
    elif devices > 1:
        sc = ShardedStreamingCounter(
            k, capacity, merge_every=merge_every,
            mesh=mesh_ops.mesh_for(device, devices),
            route_capacity=route_capacity, route_passes=route_passes,
            partition=partition, minimizer_w=minimizer_w)
    else:
        sc = StreamingCounter(k, capacity, merge_every=merge_every,
                              device=device)
    if getattr(sc, "partition", "hash") == "minimizer":
        packed = False
    if packed and length % 32 == 0:
        it = fastx.read_packed_batches(path, k=k, batch=batch, length=length)
        for words, validbits in fastx.prefetch(it, depth=prefetch_depth):
            sc.update_packed(words, validbits)
    else:
        it = fastx.read_kmer_batches(path, k=k, batch=batch, length=length)
        for rows in fastx.prefetch(it, depth=prefetch_depth):
            sc.update(rows)
    return sc
