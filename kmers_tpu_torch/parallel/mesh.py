"""Device meshes for the sharded pipelines (counterpart of
``kmers_tpu/parallel/mesh.py``), in one process or across several.

The JAX package runs its sharded layer as one SPMD program over a
``("d",)`` mesh of D shards, which spans every process once
``jax.distributed`` is initialised.  The port keeps that shape:

  * a ``Mesh`` is the tuple of this process's local devices, one per local
    shard (a device may repeat: several shards on one card, or on the
    CPU), with the global shape beside it: ``n_shards`` (D, the shards of
    every process) and ``n_local`` (L = len(mesh)).  Owners, route buffer
    rows and metrics use D; the per-shard lists and loops of the parallel
    layer run over the L local shards;
  * one process (no process group): D = L, the shard bodies run in turn
    from this process, and the collectives are copies between its shards;
  * several processes (``init_distributed``, a ``torch.distributed``
    process group of P processes): process p owns the contiguous global
    shards [p * L, (p + 1) * L), as JAX's Mesh over ``jax.devices()``
    orders them, and runs its L shard bodies in turn.  The collectives are
    torch.distributed's, which every process enters in the same order:
    ``all_to_all`` is one ``all_to_all_single`` a call, ``shift_left``
    and ``gather`` an ``all_gather``, ``psum`` an ``all_reduce``, so that
    every process holds the global sums and stacks, as JAX's psum'd
    values are replicated.  A batch that a sharded step takes is
    this process's rows (``local_read_slice`` of the global batch, or
    ``make_global_array``'s value).

NCCL is the default backend for a process with a CUDA device, gloo for
the CPU; gloo also moves CUDA tensors (all_to_all_single, all_gather and
all_reduce do; its send / recv do not, hence the halo's all_gather).

A mesh may have a second axis, as JAX's ``make_mesh(n, seq_shards)``
builds one: ``("d", "s")`` of shape (D / seq_shards, seq_shards), global
shard g at (g // seq_shards, g % seq_shards).  A sharded pipeline runs
over one axis: an axis group is the shards that share the other axis's
index, and ``axis_groups`` gives each group that holds this process's
shards as a one-axis sub-mesh, on which the collectives above run (among
the processes that hold the group's shards, through a
``torch.distributed`` group that every process creates in make_mesh, in
the same order; a group inside one process takes the copies).
"""

from __future__ import annotations

import datetime
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Mesh(tuple):
    """This process's shard devices, in local shard order (so mesh[0] is
    the first local device and zip(blocks, mesh) pairs local shards), and
    the global mesh's shape: process_count processes of len(mesh) shards
    each, this one number process_index; axis_names ("d",), or ("d", "s")
    with seq_shards > 1, and shape, the global size of each axis (as
    jax.sharding.Mesh.shape gives them).  group is the torch.distributed
    group of the processes (None: the default one)."""

    def __new__(cls, devices: Sequence, process_count: int = 1,
                process_index: int = 0, *, seq_shards: int = 1, group=None):
        mesh = super().__new__(cls, (torch.device(d) for d in devices))
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        mesh.process_count = process_count
        mesh.process_index = process_index
        mesh.group = group
        n = mesh.n_shards
        if seq_shards < 1 or n % seq_shards:
            raise ValueError(f"n={n} not divisible by seq_shards={seq_shards}")
        if seq_shards == 1:
            mesh.axis_names, mesh.shape = ("d",), {"d": n}
        else:
            mesh.axis_names = ("d", "s")
            mesh.shape = {"d": n // seq_shards, "s": seq_shards}
        mesh.handles = None     # make_mesh's {(axis, index): process group}
        return mesh

    @property
    def n_local(self) -> int:
        """L: the shards of this process."""
        return len(self)

    @property
    def n_shards(self) -> int:
        """D: the shards of every process."""
        return self.process_count * len(self)


def as_mesh(mesh) -> Mesh:
    """A Mesh as it is; a plain sequence of devices is a one-process
    mesh over them."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


class AxisGroup(NamedTuple):
    """One group of an axis: this process's shards of it as a one-axis
    mesh (in axis order, over the processes that hold the group), and
    their local shard numbers in the whole mesh."""

    mesh: Mesh
    local: tuple


def axis_positions(mesh: Mesh, axis: str = "d") -> list:
    """Each local shard's index along `axis` (global shard g sits at
    (g // seq_shards, g % seq_shards))."""
    mesh = as_mesh(mesh)
    _check_axis(mesh, axis)
    s = mesh.shape.get("s", 1)
    first = mesh.process_index * mesh.n_local
    return [(g // s if axis == "d" else g % s)
            for g in range(first, first + mesh.n_local)]


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's "
                         f"{mesh.axis_names}")


def _group_layout(n: int, s: int, n_local: int, axis: str) -> list:
    """Every group of `axis` on a global (n / s, s) mesh of n_local shards
    a process: [(global shards in axis order, their processes' ranks)],
    by the other axis's index.  A group's processes must each hold the
    same number of its shards, else ValueError (the one-axis collectives
    take equal local shard counts)."""
    d = n // s
    out = []
    for o in range(s if axis == "d" else d):
        shards = ([i * s + o for i in range(d)] if axis == "d"
                  else [o * s + j for j in range(s)])
        owners = [g // n_local for g in shards]
        ranks = sorted(set(owners))
        per = len(shards) // len(ranks)
        if owners != [r for r in ranks for _ in range(per)]:
            raise ValueError(
                f"axis {axis!r} of a ({d}, {s}) mesh of {n_local} shards a "
                "process: a group's processes hold unequal parts of it")
        out.append((shards, ranks))
    return out


def _new_groups(mesh: Mesh) -> dict:
    """{(axis, other index): torch.distributed group} of every group that
    spans processes, each created by every process in the same order."""
    handles = {}
    for axis in mesh.axis_names:
        for o, (_, ranks) in enumerate(_group_layout(
                mesh.n_shards, mesh.shape["s"], mesh.n_local, axis)):
            if len(ranks) > 1:
                kw = {} if _TIMEOUT is None else {"timeout": _TIMEOUT}
                handles[axis, o] = _dist().new_group(ranks, **kw)
    return handles


def axis_groups(mesh, axis: str = "d") -> list:
    """The groups of `axis` that hold this process's shards, by the other
    axis's index (so the first holds local shard 0): each an AxisGroup,
    whose one-axis mesh the collectives and the one-axis pipelines run on.
    On a one-axis mesh, one group: the mesh itself.  An axis the mesh
    lacks raises ValueError."""
    mesh = as_mesh(mesh)
    _check_axis(mesh, axis)
    if len(mesh.axis_names) == 1:
        return [AxisGroup(mesh, tuple(range(mesh.n_local)))]
    handles = mesh.handles or {}
    if mesh.process_count > 1 and mesh.handles is None:
        raise ValueError("a multi-process two-axis mesh comes from make_mesh")
    first = mesh.process_index * mesh.n_local
    out = []
    for o, (shards, ranks) in enumerate(_group_layout(
            mesh.n_shards, mesh.shape["s"], mesh.n_local, axis)):
        local = tuple(g - first for g in shards
                      if first <= g < first + mesh.n_local)
        if local:
            out.append(AxisGroup(Mesh(
                [mesh[i] for i in local], len(ranks),
                ranks.index(mesh.process_index),
                group=handles.get((axis, o))), local))
    return out


def one_axis(mesh, what: str) -> Mesh:
    """The mesh, which `what` runs over whole: a two-axis mesh raises
    (run it on a group of axis_groups)."""
    mesh = as_mesh(mesh)
    if len(mesh.axis_names) > 1:
        raise ValueError(f"{what} runs over a one-axis mesh; a two-axis "
                         "mesh runs it on each group of axis_groups(mesh, "
                         "axis)")
    return mesh


class ShardedRows(list):
    """A batch already split over a mesh's local shards: one row block per
    local shard, on its device (make_global_array's value, which
    batch_sharding passes through)."""


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


# init_distributed's timeout, which make_mesh gives the axis groups'
# process groups (torch's new_group otherwise takes its 30-minute default)
_TIMEOUT = None


def process_count() -> int:
    """Processes of the process group, 1 without one."""
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return _dist().get_rank() if _initialized() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, timeout=None) -> None:
    """Multi-process bring-up: torch.distributed.init_process_group
    (kmers_tpu/parallel/mesh.py:53-71, jax.distributed.initialize's
    arguments).  coordinator_address is "tcp://host:port" (a bare
    "host:port" means tcp) or "file://path"; None takes torch's env://
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  backend defaults to
    "nccl" where this process has a CUDA device, else "gloo"; "gloo" with
    CUDA tensors is an explicit choice, and a backend that fails to start
    raises (nothing falls back to another).  timeout: seconds or a
    timedelta, for the rendezvous and every collective (torch's default
    is 30 minutes).  After this, make_mesh builds the global mesh and each
    process feeds its slice of every batch (local_read_slice)."""
    global _TIMEOUT
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        if "://" not in coordinator_address:
            coordinator_address = "tcp://" + coordinator_address
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout is not None:
        if not isinstance(timeout, datetime.timedelta):
            timeout = datetime.timedelta(seconds=timeout)
        kwargs["timeout"] = timeout
    _dist().init_process_group(backend, **kwargs)
    _TIMEOUT = timeout


def make_mesh(n_devices: Optional[int] = None, seq_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over this process's first n_devices CUDA devices (all of
    them when None), or over an explicit list of local devices, which may
    repeat.  Under a process group the mesh spans every process: n_devices
    then counts the global shards (as JAX's make_mesh does) and each
    process takes n_devices / P of the CUDA devices it sees (processes
    that share a host must see disjoint cards, as JAX's processes own
    disjoint devices); every process must give the same number of local
    shards, else ValueError.  seq_shards > 1 gives the ("d", "s") mesh of
    shape (D / seq_shards, seq_shards) (kmers_tpu/parallel/mesh.py:23-35);
    across processes each of its axis groups must fall on its processes
    evenly (a process's local shards a multiple or a divisor of
    seq_shards), and every process creates the groups' process groups
    here."""
    p = process_count()
    if devices is not None:
        local = list(devices)
        if n_devices is not None and n_devices != p * len(local):
            raise ValueError(f"n_devices={n_devices} but {p} x {len(local)} "
                             "devices given")
    else:
        have = torch.cuda.device_count()
        if n_devices is None:
            n = have
        elif n_devices % p:
            raise ValueError(f"{n_devices} devices do not split over {p} "
                             "processes")
        else:
            n = n_devices // p
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        local = [torch.device("cuda", i) for i in range(n)]
    mesh = Mesh(local, p, process_index(), seq_shards=seq_shards)
    if p > 1:
        counts = _all_gather(torch.full((), len(mesh), dtype=torch.int64,
                                        device=mesh[0]), mesh)
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"every process needs the same number of local "
                             f"shards, got {counts.tolist()}")
        if seq_shards > 1:
            mesh.handles = _new_groups(mesh)
    return mesh


def cli_device(name: str) -> torch.device:
    """The device a --device argument names.  A cuda device without a card
    raises: no entry point falls back to the CPU by itself."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is false "
            "(pass --device cpu to run the plain PyTorch path)")
    return device


def mesh_for(device, n_shards: int) -> Mesh:
    """The CLI's mesh (one process): n_shards CUDA devices for a cuda
    `device`, or n_shards shards on the CPU for a cpu one."""
    device = torch.device(device)
    if device.type == "cuda":
        return make_mesh(n_shards)
    return make_mesh(devices=[device] * n_shards)


def process_local_batch(global_batch: int, mesh: Mesh) -> int:
    """Rows of a global batch that each shard takes (ceil): the batch
    splits over the "d" axis (kmers_tpu/parallel/mesh.py:47-51)."""
    return -(-global_batch // as_mesh(mesh).shape["d"])


def local_read_slice(global_batch: int) -> slice:
    """The slice of each global read batch that this process loads
    (kmers_tpu/parallel/mesh.py:74-79): contiguous, ceil(B / P) rows, the
    last process's shorter or empty."""
    n, i = process_count(), process_index()
    per = -(-global_batch // n)
    return slice(min(i * per, global_batch), min((i + 1) * per, global_batch))


def _as_rows(x) -> torch.Tensor:
    """A tensor of a numpy block (uint32 read as int32 bit patterns)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x)


def make_global_array(local_rows, mesh: Mesh) -> ShardedRows:
    """This process's [B_local, ...] rows (numpy or tensor) split over its
    local shards along "d", each block on its device and the shards that
    share a "d" index given the same block: what every sharded step takes
    as it takes a [B, L] tensor (jax.make_array_from_process_local_data,
    kmers_tpu/parallel/mesh.py:82-89).  B_local must split evenly."""
    return ShardedRows(batch_sharding(_as_rows(local_rows), mesh))


def batch_sharding(x, mesh: Mesh, axis: str = "d") -> list:
    """One row block of this process's [B, ...] rows per local shard, on
    its device: the rows split over `axis` and replicated over the other
    (the JAX package's P(axis) sharding, one process's part of it), so
    this process's rows are the blocks of the `axis` indices its shards
    hold (on a one-axis mesh, len(mesh) blocks, block s on mesh[s]).  B
    must divide evenly; a ShardedRows passes through."""
    mesh = as_mesh(mesh)
    n = mesh.n_local
    if isinstance(x, ShardedRows):
        if len(x) != n:
            raise ValueError(f"{len(x)} row blocks for {n} local shards")
        return list(x)
    pos = axis_positions(mesh, axis)
    first, blocks = min(pos), max(pos) - min(pos) + 1
    if x.shape[0] % blocks:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{blocks} shards")
    per = x.shape[0] // blocks
    return [x[(p - first) * per:(p - first + 1) * per].to(dev).contiguous()
            for p, dev in zip(pos, mesh)]


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's x stacked on a new leading axis, in the order of
    the mesh's processes."""
    parts = [torch.empty_like(x) for _ in range(mesh.process_count)]
    _dist().all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def all_to_all(bufs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The tiled all_to_all over the mesh: bufs[s] is local sender s's
    [D, ...] send buffer on mesh[s], row r bound for global shard r;
    returns, for each local receiver, a [D, ...] buffer on its device
    whose row s came from global sender s
    (``jax.lax.all_to_all(x, "d", 0, 0, tiled=True)``).

    Across processes the local senders' buffers stack to [L, P, L, ...];
    block q (every local sender's rows bound for process q's shards) goes
    to process q in one all_to_all_single, and the received
    [P, L, L, ...] blocks, rank by rank, read as [D senders, L receivers,
    ...]: senders in global order."""
    mesh = one_axis(mesh, "all_to_all")
    d, n = mesh.n_shards, mesh.n_local
    if len(bufs) != n or any(b.shape[0] != d for b in bufs):
        raise ValueError(f"all_to_all over {d} shards needs {n} local "
                         f"[{d}, ...] send buffers")
    if mesh.process_count == 1:
        return [torch.stack([bufs[s][r].to(mesh[r]) for s in range(d)])
                for r in range(d)]
    rest = tuple(bufs[0].shape[1:])
    send = torch.stack([b.to(mesh[0]) for b in bufs]).reshape(
        (n, mesh.process_count, n) + rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send, group=mesh.group)
    recv = recv.reshape((d, n) + rest)
    return [recv[:, r].to(mesh[r]).contiguous() for r in range(n)]


def shift_left(bufs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Each shard's buffer to its left neighbour: global shard i < D - 1
    gets shard i + 1's buffer on its device, the last shard zeros of its
    own buffer's shape
    (``jax.lax.ppermute(x, "d", [(i, i - 1) for i in range(1, D)])``).
    Within a process a copy; the first local shard of process p + 1 sends
    to the last of process p through an all_gather of every process's
    first buffer (a halo is a few bytes, and gloo's send / recv take no
    CUDA tensors).  Every shard's buffer has one shape."""
    mesh = one_axis(mesh, "shift_left")
    n = mesh.n_local
    if len(bufs) != n:
        raise ValueError(f"shift_left over {n} local shards needs {n} "
                         "buffers")
    out = [bufs[i + 1].to(mesh[i]) for i in range(n - 1)]
    nxt = mesh.process_index + 1
    if mesh.process_count == 1:
        return out + [torch.zeros_like(bufs[-1])]
    firsts = _all_gather(bufs[0].to(mesh[0]), mesh)
    return out + [firsts[nxt].to(mesh[-1]) if nxt < mesh.process_count
                  else torch.zeros_like(bufs[-1])]


def gather(tensors: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One tensor per local shard (one shape) -> [D, ...] on mesh[0], every
    shard's tensor in global order: a stack, and across processes an
    all_gather, so every process holds the same stack."""
    mesh = one_axis(mesh, "gather")
    x = torch.stack([t.to(mesh[0]) for t in tensors])
    if mesh.process_count == 1:
        return x
    return _all_gather(x, mesh).reshape((mesh.n_shards,)
                                        + tuple(x.shape[1:]))


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum over every shard of one tensor per local shard (a scalar,
    or a vector of several sums that then share one collective), on
    mesh[0]: across processes an all_reduce, so every process holds it."""
    mesh = one_axis(mesh, "psum")
    total = torch.stack([v.to(mesh[0]) for v in values]).sum(0)
    if mesh.process_count > 1:
        _dist().all_reduce(total, group=mesh.group)
    return total
