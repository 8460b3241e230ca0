"""kmers_tpu_torch: the PyTorch / CUDA port of kmers_tpu for NVIDIA Hopper.

Same layout as ``kmers_tpu`` (core/, ops/, io/, kernels/, parallel/ and
the CLI in __main__), same keys, tables and checkpoints.  Plain tensor
code is PyTorch; each Pallas kernel of the ported path is a hand-written
CUDA kernel under kernels/csrc, built with nvcc on first use.  Imports
torch and numpy only, never JAX.

Ported so far: the single-device ``count`` path for 1 <= k <= 64
(128-bit keys past k = 32), with the streaming unit tables and the
sort-based compact and run-length tables; the hash emitters; minimizers;
sharded counting at every k (hash partition; minimizer partition and
minimizer bucketing at k <= 31) and sequence parallelism; the distributed
lookup service at k <= 31 (parallel.pipeline.make_sharded_lookup,
lookup_sharded); and the meshes under them, of one process or of several
over torch.distributed (parallel.mesh.init_distributed, make_mesh,
local_read_slice, make_global_array; ``python -m kmers_tpu_torch.dryrun``
runs one step of every sharded pipeline as one rank of a process group).
"""

from .parallel import stream  # noqa: F401  (kmers_tpu_torch.stream.npz_digest)
from .parallel.mesh import (init_distributed, local_read_slice,  # noqa: F401
                            make_global_array, make_mesh, process_count,
                            process_index)
