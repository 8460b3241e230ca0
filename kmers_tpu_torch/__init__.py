"""kmers_tpu_torch: the PyTorch / CUDA port of kmers_tpu for NVIDIA Hopper.

Same layout as ``kmers_tpu`` (core/, ops/, io/, kernels/, parallel/ and
the CLI in __main__), same keys, tables and checkpoints.  Plain tensor
code is PyTorch; each Pallas kernel of the ported path is a hand-written
CUDA kernel under kernels/csrc, built with nvcc on first use.  Imports
torch and numpy only, never JAX.

Ported: the single-device ``count`` path for 1 <= k <= 64 (128-bit keys
past k = 32), with the streaming unit tables and the sort-based compact
and run-length tables; the hash emitters; minimizers; sharded counting at
every k (hash partition; minimizer partition and minimizer bucketing at
k <= 31) and sequence parallelism; the distributed lookup service at
k <= 31 (parallel.pipeline.make_sharded_lookup, lookup_sharded); the
meshes under them, of one process or of several over torch.distributed
(parallel.mesh.init_distributed, make_mesh, local_read_slice,
make_global_array; ``python -m kmers_tpu_torch.dryrun`` runs one step of
every sharded pipeline as one rank of a process group); and the rest of
the JAX package's surface: the encodings and k-mer word operations, the
wideint lanes and the generic ``Kmer<P, K, B>`` layer (ops.generic), the
packed SeqVector with its slices, iterators and npz / simple_sds files
(ops.seqvector), the scalar compat API (compat), utils and profiling.
Factories make tensors on ``device="cuda"`` unless told otherwise.
"""

from . import utils
from .core import u64, u128, wideint
from .core.spec import KmerSpec
from .ops import encoding, generic, hash, kmer, minimizer, seqvector
from .ops.generic import GenericSpec
from .ops.kmer import canonical_word, kmer_windows, kmer_windows_wide
from .ops.minimizer import MappedMinimizer, minimizer_stream
from .ops.seqvector import SeqVecKmerIterator, SeqVecMinimizerIter, SeqVector
from .parallel import stream
from .parallel.mesh import (init_distributed, local_read_slice,
                            make_global_array, make_mesh, process_count,
                            process_index)

__version__ = "0.1.0"

__all__ = [
    "KmerSpec",
    "GenericSpec",
    "u64",
    "u128",
    "wideint",
    "utils",
    "encoding",
    "generic",
    "hash",
    "kmer",
    "minimizer",
    "seqvector",
    "kmer_windows",
    "kmer_windows_wide",
    "canonical_word",
    "minimizer_stream",
    "MappedMinimizer",
    "SeqVector",
    "SeqVecKmerIterator",
    "SeqVecMinimizerIter",
    "__version__",
    # the port's own: the streaming counters and the mesh
    "stream",
    "init_distributed",
    "local_read_slice",
    "make_global_array",
    "make_mesh",
    "process_count",
    "process_index",
]
