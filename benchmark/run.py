"""Run one cell of the benchmark once (see benchmark/harness/runner.py):

    python3 benchmark/run.py --workload ecoli-k31.count --seed 7 \
        --seconds 10 --trace 0
"""

import time

T0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# every cache of the program inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, "build", "cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], t0=T0))
