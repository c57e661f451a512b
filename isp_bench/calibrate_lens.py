#!/usr/bin/env python3
"""The readings that the limits of ``checks/mf102.lens.json`` are set from,
taken as ``calibrate.py`` takes them for the other cells: the numbers
``correct`` compares for the program over many seeds (the lower readings),
for the control (``drivers/lens.py``'s ``control``: the lens reference in
bfloat16 in the program's place; the upper readings) and for each fault of
``drivers/lens.py`` (``FAULTS``), each at the cell's own size, in one
process, with the peak device memory of each. The benchmark's runs never
run this.

    python3 isp_bench/calibrate_lens.py --seeds 1,2,3 --control-seeds 4,5,6 \
        --fault-seeds 7 --seconds 2
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ.setdefault("PYSP_TPU_MATRIX_CACHE", os.path.join(ROOT, ".isp_bench_cache",
                                                            "harvested_matrices.json"))

from isp_bench import calibrate  # noqa: E402
from isp_bench.drivers import lens  # noqa: E402

CELL = "mf102.lens"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="", help="each fault on each seed")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_lens.py needs a CUDA device", file=sys.stderr)
        return 2
    runs = [(None, None, a.seeds), (lens.control, "control_bfloat16", a.control_seeds)]
    runs += [(f, f.__name__, a.fault_seeds) for f in lens.FAULTS]
    for make, label, seeds in runs:
        for s in filter(None, seeds.split(",")):
            torch.cuda.reset_peak_memory_stats()
            reading = calibrate.one(CELL, int(s), a.seconds, make)
            reading.update(control=make is lens.control,
                           fault=label if make not in (None, lens.control) else None,
                           memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
            print(json.dumps(reading), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
