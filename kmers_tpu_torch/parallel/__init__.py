"""The sharded layer (counterpart of ``kmers_tpu/parallel``): meshes of
one process or several (torch.distributed), hash-prefix routing, sharded
counting, sequence parallelism, the lookup service and the streaming
counters."""

from .mesh import (Mesh, axis_groups, batch_sharding, init_distributed,
                   local_read_slice, make_global_array, make_mesh,
                   process_count, process_index)

__all__ = ["Mesh", "axis_groups", "batch_sharding", "init_distributed",
           "local_read_slice", "make_global_array", "make_mesh",
           "process_count", "process_index"]
