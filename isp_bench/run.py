#!/usr/bin/env python3
"""Runs one cell of the benchmark of pysp_tpu_torch once and prints its result
line; see ``harness.py``.

    python3 isp_bench/run.py --workload cam24.best --seed 7 --seconds 20 --trace 0
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every cache the run writes lives at a fixed path inside the checkout (the
# port's kernels and native library build into pysp_tpu_torch/_build/).
CACHE = os.path.join(ROOT, ".isp_bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["PYSP_TPU_MATRIX_CACHE"] = os.path.join(CACHE, "harvested_matrices.json")
sys.path[0] = ROOT   # the checkout, not this folder: its module names stay its own

from isp_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
