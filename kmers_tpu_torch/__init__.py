"""kmers_tpu_torch: the PyTorch / CUDA port of kmers_tpu for NVIDIA Hopper.

Same layout as ``kmers_tpu`` (core/, ops/, io/, kernels/, parallel/ and
the CLI in __main__), same keys, tables and checkpoints.  Plain tensor
code is PyTorch; each Pallas kernel of the ported path is a hand-written
CUDA kernel under kernels/csrc, built with nvcc on first use.  Imports
torch and numpy only, never JAX.

Ported so far: the single-device ``count`` path for 1 <= k <= 64
(128-bit keys past k = 32), with the streaming unit tables and the
sort-based compact and run-length tables; the hash emitters; minimizers;
sharded counting at k <= 31 over a one-process mesh (hash or minimizer
partition, and minimizer bucketing); and the distributed lookup service
at k <= 31 (parallel.pipeline.make_sharded_lookup, lookup_sharded).
"""

from .parallel import stream  # noqa: F401  (kmers_tpu_torch.stream.npz_digest)
