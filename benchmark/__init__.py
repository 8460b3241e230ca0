"""The benchmark of kmers_tpu_torch on an NVIDIA H100 (``run.py``)."""
