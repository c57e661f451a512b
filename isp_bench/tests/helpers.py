"""Small sizes at which the CPU tests drive the benchmark's cells."""
import os
import time

os.environ.setdefault("PYSP_TPU_MATRIX_CACHE", os.path.join(
    os.environ.get("TMPDIR", "/tmp"), f"isp_bench_tests_matrices_{os.getpid()}.json"))

SEED = 2**31 + 12345


def scale(cell: str) -> dict:
    """Sizes a CPU test run can hold: hdr5 at 256x384 with six single hot
    sites (a small scene has no 2x2 dark quad), the others at 128x192."""
    if cell.startswith("hdr5"):
        return {"height": 256, "width": 384, "hot_pixels": {"singles": 6, "clusters": 0}}
    return {"height": 128, "width": 192}


def run_cell(cell: str, seconds: float = 0.3, program=None, seed: int = SEED, root=None):
    import torch

    from isp_bench import harness

    # one thread a test process: several run side by side, and a window of a
    # second holds only a few items
    torch.set_num_threads(1)
    kw = {} if root is None else {"root": root}
    ctx = harness.Context(cell, seed, device="cpu", scale=scale(cell), **kw)
    if callable(program):
        program = program(ctx)
    return harness.execute(ctx, seconds, False, time.perf_counter(), program=program), ctx
