"""Device meshes for the sharded pipelines (counterpart of
``kmers_tpu/parallel/mesh.py``, one process).

The JAX package runs its sharded layer as one SPMD program over a
``("d",)`` mesh.  The port keeps that shape in one process:

  * a mesh is a tuple of ``torch.device``s, one per shard; a device may
    repeat (D shards on one card, or on the CPU);
  * the shard bodies run in turn from this process, each on its device;
  * the collectives move tensors between shards by copies:
    ``all_to_all`` moves every sender's ``[D, ...]`` send buffer rows to
    their receivers, ``shift_left`` each shard's buffer to its left
    neighbour (the sequence-parallel halo).

Swapping these for ``torch.distributed``'s ``all_to_all_single`` and
send / recv is what a multi-process (multi-host) mesh needs; nothing else
here assumes one process.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first n_devices CUDA devices (all of them when
    None), or over an explicit list of devices, which may repeat."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             "devices given")
        mesh = tuple(torch.device(d) for d in devices)
    else:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        mesh = tuple(torch.device("cuda", i) for i in range(n))
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def mesh_for(device, n_shards: int) -> Mesh:
    """The CLI's mesh: n_shards CUDA devices for a cuda `device`, or
    n_shards shards on the CPU for a cpu one."""
    device = torch.device(device)
    if device.type == "cuda":
        return make_mesh(n_shards)
    return make_mesh(devices=[device] * n_shards)


def process_local_batch(global_batch: int, mesh: Mesh) -> int:
    """Rows of a batch that each shard takes (ceil)."""
    return -(-global_batch // len(mesh))


def batch_sharding(x: torch.Tensor, mesh: Mesh) -> list:
    """Split a [B, ...] batch into len(mesh) row blocks, block s on mesh[s]
    (the JAX package's P("d") sharding).  B must divide evenly."""
    d = len(mesh)
    if x.shape[0] % d:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                         f"{d} shards")
    per = x.shape[0] // d
    return [x[s * per:(s + 1) * per].to(dev).contiguous()
            for s, dev in enumerate(mesh)]


def all_to_all(bufs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The tiled all_to_all over the mesh: bufs[s] is sender s's [D, ...]
    send buffer on mesh[s], row r bound for shard r; returns, for each
    receiver r, a [D, ...] buffer on mesh[r] whose row s came from sender s
    (``jax.lax.all_to_all(x, "d", 0, 0, tiled=True)``)."""
    d = len(mesh)
    if len(bufs) != d or any(b.shape[0] != d for b in bufs):
        raise ValueError(f"all_to_all over {d} shards needs {d} [{d}, ...] "
                         "send buffers")
    return [torch.stack([bufs[s][r].to(mesh[r]) for s in range(d)])
            for r in range(d)]


def shift_left(bufs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Each shard's buffer to its left neighbour: receiver i < D - 1 gets
    bufs[i + 1] on mesh[i], the last shard zeros of its own buffer's shape
    (``jax.lax.ppermute(x, "d", [(i, i - 1) for i in range(1, D)])``)."""
    d = len(mesh)
    if len(bufs) != d:
        raise ValueError(f"shift_left over {d} shards needs {d} buffers")
    return ([bufs[i + 1].to(mesh[i]) for i in range(d - 1)]
            + [torch.zeros_like(bufs[-1])])


def gather(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Stack one tensor per shard on `device` (a leading shard axis)."""
    return torch.stack([t.to(device) for t in tensors])
