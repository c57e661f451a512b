#!/usr/bin/env python3
"""The readings that the limits of ``checks/<cell>.json`` are set from: the
numbers ``correct`` compares, for the program over many seeds (the lower
readings), for the control (``control.py``, the reference in bfloat16 in the
program's place; the upper readings) and for each fault the cell can have
(``faults.py``), each at the cell's own size, in one process. The
benchmark's runs never run this.

    python3 isp_bench/calibrate.py --workload cam24.best --seeds 1,2,3 --control-seeds 4,5,6 \
        --fault-seeds 7,8,9 --seconds 2
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ.setdefault("PYSP_TPU_MATRIX_CACHE", os.path.join(ROOT, ".isp_bench_cache",
                                                            "harvested_matrices.json"))

from isp_bench import control, faults, harness  # noqa: E402


def one(cell: str, seed: int, seconds: float, make=None) -> dict:
    """One reading: the program's, or that of ``make(ctx)`` in its place."""
    import torch

    ctx = harness.Context(cell, seed)
    driver = ctx.driver()
    t0 = time.perf_counter()
    state = driver.prepare(ctx, make(ctx) if make else None)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    driver.window(state, ctx, seconds, None)
    driver.release(state)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    comps = driver.check(state, ctx)
    attempted, failed = driver.attempts(state, ctx)
    return {"cell": cell, "seed": seed, "control": make is control.program,
            "fault": getattr(make, "__name__", None) if make not in (None, control.program) else None,
            "correct": all(c.ok for c in comps) and failed == 0, "attempted": attempted,
            "failed": failed, "items": len(ctx.run.items),
            "setup_s": round(setup, 3), "check_s": round(time.perf_counter() - t1, 3),
            "numbers": {c.name: c.value for c in comps}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="", help="each fault of the cell on each seed")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    runs = [(None, a.seeds), (control.program, a.control_seeds)]
    runs += [(f, a.fault_seeds) for f in faults.BY_CELL.get(a.workload, ())]
    for make, seeds in runs:
        for s in filter(None, seeds.split(",")):
            print(json.dumps(one(a.workload, int(s), a.seconds, make)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
