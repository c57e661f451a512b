"""Develop ONE large frame with its rows over the mesh, on pysp_tpu_torch.

The PyTorch + CUDA counterpart of ``examples/large_frame_sharded.py``: a
single frame runs its whole config-5 chain -- hot-pixel repair, CA removal,
AHD develop, DNG rectilinear warp -- with its rows sharded over the mesh's
'spatial' axis:

1. Write one synthetic DNG with an embedded WarpRectilinear opcode (the
   "camera with a wide lens").
2. Load it; take a CA model and the OpcodeList3 block, on the host.
3. ``develop_frame_spatial``: one halo exchange whose width is the summed
   reach of every stage (displacement bounds + stencil reach, on the host),
   then each shard runs the corrections (global statistics by collectives),
   CA and warp on its own window of the full-frame coordinate fields, and
   the develop, on its own device.
4. Compare the rows away from the frame's top and bottom with the
   monolithic pipeline.

The mesh is (1, min(4, len(devices))): every visible card by default (one
card: a (1, 1) mesh). ``devices`` names others, such as ``["cpu"] * 4`` or
``["cuda:0"] * 4``. Sized like the JAX example (a small stand-in: the path
does not depend on the shape).

Run from the repository root: python -m examples.large_frame_sharded_torch
[--device cpu] [--shards N]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

EDGE = 48
ATOL = 3e-5


def main(device="cuda", devices=None):
    """The sharded develop and its check; returns ``(image, interior max abs
    difference from the monolithic composition)``."""
    from pysp_tpu_torch import (
        DevelopConfig,
        PipelineConfig,
        Poly3CorrectionModel,
        QualityDemosaic,
        apply_opcode_3_warp,
        develop,
        encode_warp_rectilinear,
        load_raw,
        make_mesh,
        remove_ca_from_raw,
    )
    from pysp_tpu_torch.io.tiff import write_synthetic_dng
    from pysp_tpu_torch.parallel.spatial_pipeline import develop_frame_spatial
    from pysp_tpu_torch.pipeline.pipeline import _correct_one

    if devices is None:
        if torch.device(device).type != "cuda":
            devices = [device]
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "large_frame_sharded_torch runs on the GPU by default, but no CUDA device "
                "is present (torch.cuda.is_available() is False). Pass device='cpu' (and "
                "devices=['cpu'] * n) to run on the CPU."
            )
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n_sp = min(4, len(devices))
    h, w = 64 * n_sp * 2, 96  # tiny stand-in; the path is shape-generic

    # 1. the "camera": structured scene + a mild barrel warp opcode
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.clip(
        2000 + 1400 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
        + rng.normal(0, 30, (h, w)),
        300,
        3900,
    ).astype(np.uint16)
    block = encode_warp_rectilinear(
        [(1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)] * 3, (0.5, 0.5)
    )
    dng = write_synthetic_dng(scene, opcode_list_3=block)

    # 2. host side: decode + model + opcode block
    frame = load_raw(dng, device=device)
    model = Poly3CorrectionModel(0.008)  # stand-in for a fitted model

    # 3. the sharded single-frame pipeline
    mesh = make_mesh((1, n_sp), devices=list(devices)[:n_sp])
    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Best),
        repair_hot_pixels=True,
    )
    out = develop_frame_spatial(
        frame, mesh, cfg, ca_model_r=model, ca_model_b=model,
        warp_block=block, warp_interpolation="bilinear",
    )
    print(f"sharded develop: {tuple(out.shape)} over {n_sp} spatial shards")

    # 4. interior parity vs the monolithic composition
    f = _correct_one(frame, cfg, None, None, None)
    f = remove_ca_from_raw(f, model, model)
    want = apply_opcode_3_warp(develop(f, cfg.develop), block, interpolation="bilinear")
    err = float((out[EDGE:-EDGE] - want.to(out.device)[EDGE:-EDGE]).abs().max())
    print(f"interior max abs diff vs monolithic: {err:.2e}")
    if err > ATOL:
        raise RuntimeError(f"interior rows {err:.3g} from the monolithic pipeline (> {ATOL})")
    print("OK")
    return out, err


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--shards", type=int, default=None,
                        help="shards on --device (default: one a visible card, at most 4)")
    args = parser.parse_args()
    main(args.device, None if args.shards is None else [args.device] * args.shards)
