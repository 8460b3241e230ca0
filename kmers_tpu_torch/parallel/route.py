"""Hash-prefix routing of k-mers to their owning shards (counterpart of
``kmers_tpu/parallel/route.py``).

Each of the D shards of a mesh owns 1/D of the 64-bit space of the
Feistel-mixed key; a k-mer goes to shard ``(f_hi * D) >> 32`` of its mix
``f = feistel_mix(word)``.  Fixed-capacity buckets stand in for a ragged
all_to_all, as in the JAX package:

  1. per sender, sort the lanes by owner (invalid lanes last);
  2. per-owner counts give each bucket's extent in the sorted lanes;
  3. pass p of ``passes`` cuts lanes [p*C, (p+1)*C) of every bucket into a
     [D, P + 1, C] send buffer (P planes and the in-bucket mask, stacked):
     contiguous ranges of the owner-sorted lanes, read from arrays padded
     so that no range runs off their end;
  4. one ``mesh.all_to_all`` a pass delivers row r of every sender to
     shard r.

Lanes past passes * C of a bucket are dropped and counted (``overflow``);
lanes shipped in passes >= 2 are counted too (``rerouted``).
``route_wide`` routes 128-bit words (33 <= k <= 64) the way
``route_payload`` routes planes: a stable owner sort, the owner taken
from the words' mix hash.  ``route_queries`` is the lookup service's
round trip: one pass out, and the answers carried back to the senders'
lanes.  Every function takes one tensor per local shard (a list in mesh
order) and returns one result per local shard: the senders' phase runs
for every local shard, then the exchange (across processes on a
multi-process mesh), then the receivers' phase.  Owners are taken modulo
the global shard count D (mesh.n_shards); overflow and rerouted are each
local sender's own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import profiling
from ..core import u64, u128
from . import mesh as mesh_ops


class Routed(NamedTuple):
    """k-mer words on their owning shard."""

    words: torch.Tensor     # int64 [passes * D * C] received words
    valid: torch.Tensor     # bool [passes * D * C]
    overflow: torch.Tensor  # int64 scalar: lanes this sender dropped
    rerouted: torch.Tensor  # int64 scalar: lanes it shipped in passes >= 2


class RoutedWide(NamedTuple):
    """128-bit k-mer words on their owning shard."""

    words: tuple            # (hi, lo) int64 [passes * D * C] received words
    valid: torch.Tensor
    overflow: torch.Tensor
    rerouted: torch.Tensor


class RoutedPlanes(NamedTuple):
    """Payload planes on their owning shard."""

    planes: tuple                 # int32 [passes * D * C] each
    valid: torch.Tensor
    overflow: torch.Tensor
    rerouted: torch.Tensor
    overflow_weight: torch.Tensor  # the weight field summed over dropped
    #                                lanes (0 without a weight plane)


def _mul_shift32(x: torch.Tensor, d: int) -> torch.Tensor:
    """floor(x * d / 2^32) for uint32 values x held in int64 (exact: the
    product stays below 2^63 for any d < 2^31)."""
    return u64.shr(x * d, 32)


def owner_of(words: torch.Tensor, n_shards: int, seed: int = 0) -> torch.Tensor:
    """The owning shard of int64 words: the multiply-shift of the high
    half of their Feistel mix (a prefix of the mixed key)."""
    return _mul_shift32(u64.shr(u64.feistel_mix(words, seed), 32), n_shards)


def owner_of_wide(hi: torch.Tensor, lo: torch.Tensor, n_shards: int,
                  seed: int = 0) -> torch.Tensor:
    """The owning shard of 128-bit (hi, lo) words: the multiply-shift of
    the high half of their 64-bit mix hash (kmers_tpu/parallel/
    route.py:335-337)."""
    return _mul_shift32(u64.shr(u128.mix_hash(hi, lo, seed), 32), n_shards)


def _owner_boundaries(n_shards: int) -> list:
    """The f_hi values where ownership changes: owner(x) >= o iff
    x >= ceil(o * 2^32 / D)."""
    return [-(-o * (1 << 32) // n_shards) for o in range(n_shards + 1)]


def _owner_histogram(owner_sorted: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Per-owner lane counts [n_shards] of an owner-sorted lane array, by
    binary search for each bucket's start."""
    probes = torch.arange(n_shards + 1, dtype=owner_sorted.dtype,
                          device=owner_sorted.device)
    bounds = torch.searchsorted(owner_sorted, probes, side="left")
    return bounds[1:] - bounds[:-1]


def bucket_sort(words: torch.Tensor, valid: torch.Tensor, n_shards: int,
                seed: int = 0):
    """Sort lanes by owner, invalid last, in the Feistel-mixed domain.

    Returns (mixed words sorted as unsigned, valid, owner, counts
    [n_shards]).  Invalid lanes become (0xFFFFFFFF, 0xFFFFFFFF), which
    sorts last; validity is positional (lane < n_valid) and the counts
    are clipped to n_valid, so a real key that mixes to the sentinel is
    still counted exactly (equal mixed words are interchangeable)."""
    f = torch.where(valid, u64.feistel_mix(words, seed), -1)
    s = u64.to_unsigned_order(torch.sort(u64.to_unsigned_order(f)).values)
    n_valid = valid.sum()
    sv = torch.arange(s.shape[-1], device=s.device) < n_valid
    return (s, sv, _mul_shift32(u64.shr(s, 32), n_shards),
            _owner_counts(s, n_valid, n_shards))


def _owner_counts(s: torch.Tensor, n_valid: torch.Tensor,
                  n_shards: int) -> torch.Tensor:
    """Per-owner lane counts [n_shards] of mixed words sorted as unsigned,
    the valid ones first: binary searches of the owner boundaries in the
    high halves, clipped to n_valid."""
    s_hi = u64.shr(s, 32)
    # _owner_boundaries(n_shards)[:-1], computed on the device: a host list
    # copied over would be a blocking copy per sender per batch
    o = torch.arange(n_shards, device=s.device)
    probes = (o * (1 << 32) + n_shards - 1) // n_shards
    bounds = torch.minimum(torch.searchsorted(s_hi, probes, side="left"),
                           n_valid)
    return torch.cat([bounds[1:], n_valid[None]]) - bounds


def _bucket_sends(arrs, counts: torch.Tensor, capacity: int, passes: int):
    """One sender's send buffers: send_at(p) is the [D, P + 1, capacity]
    buffer of pass p, row d holding bucket d's lanes p*C .. (p+1)*C of the
    P owner-sorted arrays (one dtype) and, last, their in-bucket mask in
    that dtype.  Bucket d is the contiguous range starting at
    cumsum(counts)[d] - counts[d]; the arrays are padded by passes * C
    zeros so that no range is clamped (a clamped start would shift real
    bucket lanes under the mask)."""
    starts = torch.cumsum(counts, 0) - counts
    pad = passes * capacity
    padded = torch.stack([torch.cat([a, a.new_zeros(pad)]) for a in arrs])
    lane = torch.arange(capacity, device=counts.device)

    def send_at(p: int) -> torch.Tensor:
        off = p * capacity
        bufs = padded[:, starts[:, None] + off + lane]
        mask = lane < torch.clamp(counts - off, 0, capacity)[:, None]
        return torch.cat([bufs, mask[None].to(padded.dtype)]).transpose(0, 1)

    return send_at


def _all_to_all(bufs: Sequence[torch.Tensor], mesh) -> list:
    """mesh.all_to_all of one pass's send buffers in the span
    kmers.route.exchange, counted from their shapes (no sync): every
    local sender's D - 1 rows bound for other shards cross, and each
    shard takes in D - 1 rows of one shape."""
    with profiling.span("kmers.route.exchange"):
        got = mesh_ops.all_to_all(bufs, mesh)
    off_rows = ((mesh.n_shards - 1) * bufs[0][0].numel()
                * bufs[0].element_size())
    profiling.add("kmers.route.exchanges")
    profiling.add("kmers.route.cross_bytes", len(bufs) * off_rows)
    profiling.add("kmers.route.recv_bytes_max", off_rows)
    return got


def _exchange(sorted_planes: Sequence[Sequence[torch.Tensor]],
              counts: Sequence[torch.Tensor], mesh, capacity: int,
              passes: int):
    """The shared body of route and route_payload, after each sender's
    owner sort: per pass, one all_to_all of every sender's stacked planes
    and mask.  Returns, per local shard, (received planes, received valid,
    overflow, rerouted); received lanes run pass, global sender, lane."""
    with profiling.span("kmers.route.bucket"):
        senders = [_bucket_sends(planes, cnt, capacity, passes)
                   for planes, cnt in zip(sorted_planes, counts)]
    recv = [[] for _ in senders]
    for p in range(passes):
        with profiling.span("kmers.route.bucket"):
            bufs = [send_at(p) for send_at in senders]
        got = _all_to_all(bufs, mesh)
        for r, g in enumerate(got):
            recv[r].append(g)
    n_planes = len(sorted_planes[0])
    out = []
    for r, cnt in enumerate(counts):
        x = torch.stack(recv[r])          # [passes, D, P + 1, C]
        planes = [x[:, :, i].reshape(-1) for i in range(n_planes)]
        overflow = torch.clamp(cnt - passes * capacity, min=0).sum()
        rerouted = torch.clamp(cnt - capacity, 0, (passes - 1) * capacity).sum()
        out.append((planes, x[:, :, n_planes].reshape(-1) != 0, overflow,
                    rerouted))
    return out


def route(words: Sequence[torch.Tensor], valid: Sequence[torch.Tensor], mesh,
          capacity: int, seed: int = 0, passes: int = 1) -> list:
    """Route each shard's k-mer words (int64, any shape) to their owners.
    capacity is the per-destination lane budget of a sender per pass;
    each shard receives passes * D * capacity lanes, exact while every
    bucket holds <= passes * capacity lanes.  The wire carries the mixed
    words; receivers unmix them.  Returns one Routed per shard."""
    mesh = mesh_ops.as_mesh(mesh)
    d = mesh.n_shards
    sorted_words, counts = [], []
    with profiling.span("kmers.route.bucket"):
        for w, v in zip(words, valid):
            s, _, _, cnt = bucket_sort(w.reshape(-1), v.reshape(-1), d, seed)
            sorted_words.append((s,))
            counts.append(cnt)
    received = _exchange(sorted_words, counts, mesh, capacity, passes)
    with profiling.span("kmers.route.unmix"):
        return [Routed(u64.feistel_unmix(planes[0], seed), rv, ov, rr)
                for planes, rv, ov, rr in received]


def _owner_sort(owner: torch.Tensor, planes, n_shards: int):
    """A stable sort of one sender's lanes by owner (invalid lanes carry
    owner n_shards and go last): (sorted owners, the planes flattened in
    that order, per-owner counts [n_shards])."""
    order = torch.sort(owner, stable=True).indices
    o = owner[order]
    return (o, [p.reshape(-1)[order] for p in planes],
            _owner_histogram(o, n_shards))


def route_payload(owner_words: Sequence[torch.Tensor],
                  valid: Sequence[torch.Tensor], planes, mesh,
                  capacity: int, seed: int = 0, passes: int = 1,
                  weight_plane: Optional[int] = None, weight_shift: int = 0,
                  weight_mask: Optional[int] = None) -> list:
    """Route each shard's int32 payload planes to the shard owning
    owner_of(owner_words); the owner words themselves are not shipped.
    The owner sort is stable, so a bucket keeps its lanes' order.

    weight_plane (an index into a shard's planes) makes overflow
    weight-aware: overflow_weight sums that plane's bit field
    (>> weight_shift, & weight_mask, read as uint32) over dropped lanes,
    e.g. the k-mers of each dropped super-k-mer.  Returns one
    RoutedPlanes per shard."""
    mesh = mesh_ops.as_mesh(mesh)
    d = mesh.n_shards
    sorted_planes, counts, weights = [], [], []
    with profiling.span("kmers.route.bucket"):
        for ow, v, pl in zip(owner_words, valid, planes):
            v = v.reshape(-1)
            o, sp, cnt = _owner_sort(
                torch.where(v, owner_of(ow.reshape(-1), d, seed), d), pl, d)
            if weight_plane is None:
                weights.append(torch.zeros((), dtype=torch.int64,
                                           device=o.device))
            else:
                starts = torch.cumsum(cnt, 0) - cnt
                rank = (torch.arange(o.shape[0], device=o.device)
                        - starts[torch.clamp(o, 0, d - 1)])
                dropped = (o < d) & (rank >= passes * capacity)
                wvals = u64.shr(u64.as_uint32(sp[weight_plane]),
                                weight_shift)
                if weight_mask is not None:
                    wvals = wvals & weight_mask
                weights.append(torch.where(dropped, wvals, 0).sum())
            sorted_planes.append(sp)
            counts.append(cnt)
    return [RoutedPlanes(tuple(planes_r), rv, ov, rr, w)
            for (planes_r, rv, ov, rr), w in zip(
                _exchange(sorted_planes, counts, mesh, capacity, passes),
                weights)]


def route_wide(words: Sequence[tuple], valid: Sequence[torch.Tensor], mesh,
               capacity: int, seed: int = 0, passes: int = 1) -> list:
    """Route each shard's 128-bit (hi, lo) k-mer words (int64, any shape)
    to their owners, owner_of_wide (kmers_tpu/parallel/route.py:340-381).
    Not the Feistel domain of `route`: a stable sort by owner, invalid
    lanes last, carries the words themselves, so received lanes run pass,
    sender, lane as in the JAX package.  capacity, passes, overflow and
    rerouted as in `route`.  Returns one RoutedWide per shard."""
    mesh = mesh_ops.as_mesh(mesh)
    d = mesh.n_shards
    sorted_words, counts = [], []
    with profiling.span("kmers.route.bucket"):
        for (hi, lo), v in zip(words, valid):
            hi, lo, v = hi.reshape(-1), lo.reshape(-1), v.reshape(-1)
            _, sw, cnt = _owner_sort(
                torch.where(v, owner_of_wide(hi, lo, d, seed), d), (hi, lo),
                d)
            sorted_words.append(sw)
            counts.append(cnt)
    return [RoutedWide(tuple(planes), rv, ov, rr)
            for planes, rv, ov, rr in _exchange(sorted_words, counts, mesh,
                                                capacity, passes)]


class RoutedQueries(NamedTuple):
    """Query words on their owning shard."""

    words: torch.Tensor     # int64 [D, C]: row s holds sender s's bucket
    valid: torch.Tensor     # bool [D, C]
    overflow: torch.Tensor  # int64 scalar: queries this sender dropped


def route_queries(words: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                  mesh, capacity: int, seed: int = 0):
    """Route each shard's query words (int64, any shape) to their owners
    in one exchange of capacity lanes a destination, keeping the way back
    (kmers_tpu/parallel/route.py:384-468).

    Returns (routed, reply): one RoutedQueries per shard, and
    reply(answers), which takes one [D, C] int32 answer array per owner,
    aligned with its received lanes, carries them back by the inverse
    all_to_all and returns, per sender, the answers at its queries'
    positions in their shape: -1 where a query was invalid or overflowed.

    A sender sorts its lanes by (mixed word, position), invalid lanes
    mixed to MAX at position n.  The position matters: the one real query
    whose mix is MAX (feistel_unmix(MAX)) must sort before every invalid
    lane, or it falls out of the valid prefix.  Answers come home by a
    scatter to the positions (JAX's union sort): each position is
    answered at most once, so the arrays are the same."""
    mesh = mesh_ops.as_mesh(mesh)
    d = mesh.n_shards
    sends, homes, overflow = [], [], []
    for w, v in zip(words, valid):
        shape = w.shape
        w, v = w.reshape(-1), v.reshape(-1)
        n = w.shape[0]
        f = torch.where(v, u64.feistel_mix(w, seed), -1)
        # (word, position) order: valid lanes first, each side in lane
        # order, then a stable sort by the word
        first = torch.sort((~v).to(torch.uint8), stable=True).indices
        s, step = torch.sort(u64.to_unsigned_order(f[first]), stable=True)
        s = u64.to_unsigned_order(s)
        orig = first[step]
        counts = _owner_counts(s, v.sum(), d)
        buf = _bucket_sends((s, orig), counts, capacity, 1)(0)  # [D, 3, C]
        # words and mask (planes 0 and 2) by a slice: an index list would
        # be copied up from the host, a sync a call
        sends.append(buf[:, ::2])
        in_bucket = buf[:, 2] != 0
        homes.append((torch.where(in_bucket, buf[:, 1], n).reshape(-1), n,
                      shape))
        overflow.append(torch.clamp(counts - capacity, min=0).sum())
    routed = [RoutedQueries(u64.feistel_unmix(g[:, 0], seed), g[:, 1] != 0, ov)
              for g, ov in zip(mesh_ops.all_to_all(sends, mesh), overflow)]

    def reply(answers: Sequence[torch.Tensor]) -> list:
        out = []
        for back, (slot, n, shape) in zip(mesh_ops.all_to_all(answers, mesh),
                                          homes):
            # slot n takes every unanswered lane and is cut off
            dense = torch.full((n + 1,), -1, dtype=torch.int32,
                               device=back.device)
            dense[slot] = back.reshape(-1).to(torch.int32)
            out.append(dense[:n].reshape(shape))
        return out

    return routed, reply
