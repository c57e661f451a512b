"""The control of ``correct``: the plain reference put in the program's place
and computed in bfloat16, the nearest precision below the float32 that the
configurations state. A sound limit fails it. The benchmark's own runs never
run it; ``calibrate.py`` and the tests do.

The control takes the program's inputs as the timed path gets them (a frame,
a burst, or the paths of DNG files, which it loads with the port's loader:
what the control tests is the develop's precision, not the decode)."""
from __future__ import annotations

import os

import torch

from isp_bench.reference import develop as ref


def _frame(f, k=None, dtype=torch.bfloat16) -> ref.Frame:
    pick = (lambda t: t) if k is None else (lambda t: t[k])
    return ref.Frame(bayer=pick(f.bayer).to(dtype), cam_mat=pick(f.cam_mat),
                     cam_white=pick(f.cam_white), wb_neutral=pick(f.wb_neutral),
                     ev=float(pick(f.ev)), is_hdr=f.is_hdr)


def program(ctx, dtype=torch.bfloat16):
    """The control's entry for the cell's driver."""
    conf = ctx.config
    dev = conf["develop"]
    stages, clip, gamma = dev["postprocess_stages"], dev["clip_highlights"], dev["gamma_encode"]
    if ctx.traffic["driver"] == "files":
        from pysp_tpu_torch import load_raw, save_image

        quality = ctx.traffic["quality"]

        def files(paths, out_dir):
            os.makedirs(out_dir, exist_ok=True)
            written = []
            for p in paths:
                img = ref.develop(_frame(load_raw(p, device=ctx.device), dtype=dtype),
                                  quality, stages, clip, gamma)
                dst = os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".png")
                save_image(dst, img.to(torch.float32))
                written.append(dst)
            return written
        return files
    if ctx.traffic["entry"] == "develop":
        return lambda frame, q: ref.develop(_frame(frame, dtype=dtype), q, stages, clip, gamma)
    pipe = conf["pipeline"]
    return lambda burst, q: ref.hdr_pipeline(
        [_frame(burst, k, dtype) for k in range(burst.bayer.shape[0])], pipe, stages)
