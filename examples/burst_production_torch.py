"""Production burst workflow on pysp_tpu_torch: fit once, develop everywhere,
under the mesh.

The PyTorch + CUDA counterpart of ``examples/burst_production.py``:

1. Write a synthetic burst of raw DNGs with a known chromatic aberration
   (the "camera"), on the host.
2. Fit CA models on the FIRST frame only and persist them as a JSON sidecar
   (``utils/sidecar.py``).
3. Load the whole burst (threaded host decode, one copy to the device),
   apply the sidecar's models burst-wide and develop every frame
   data-parallel over the device mesh (``develop_pipeline_sharded``: each
   shard's CA is one remap launch a map over its frames).
4. Save the results through the native PNG writer.

The mesh is ``min(len(paths), len(devices))`` devices on the batch axis:
every visible card by default (one card: a (1, 1) mesh). ``devices`` names
others, such as ``["cpu"] * 4`` or ``["cuda:0"] * 4``.

Run from the repository root: python -m examples.burst_production_torch
[outdir] [--device cpu] [--shards N]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from pysp_tpu_torch import (
    DevelopConfig,
    PipelineConfig,
    Poly3CorrectionModel,
    QualityDemosaic,
    RawFrame,
    fit_ca_models_gradient,
    load_burst,
    make_mesh,
    remove_ca_from_raw,
    save_image,
)
from pysp_tpu_torch.core.frame import unstack_frames
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.parallel.pipeline_sharded import develop_pipeline_sharded
from pysp_tpu_torch.utils.sidecar import load_sidecar, save_sidecar


def make_burst(tmpdir: str, n: int = 4, h: int = 96, w: int = 128):
    """Synthetic raw burst with genuine lateral CA baked in, on the host.

    "Removing" CA that isn't there mis-resamples R/B against G with the
    model's radial maps, i.e. it bakes a real, known lateral aberration into
    the mosaic with the library's own resampling; the gradient fit below
    recovers a correcting model of matching sign and scale."""
    rng = np.random.default_rng(0)
    bake = Poly3CorrectionModel(-0.012)
    paths = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        scene = (
            0.3
            + 0.3 * np.sin(xx / 9.0 + 0.3 * i) * np.cos(yy / 7.0)
            + 0.15 * ((xx // 16) % 2)
            + 0.05 * rng.random((h, w))
        )
        bayer = np.clip(scene, 0.02, 0.98).astype(np.float32)
        aberrated = remove_ca_from_raw(RawFrame.synthetic(bayer, device="cpu"), bake, bake)
        u16 = np.clip(aberrated.bayer.numpy() * 3600 + 260, 0, 4095).astype(np.uint16)
        p = os.path.join(tmpdir, f"burst_{i:02d}.dng")
        with open(p, "wb") as f:
            f.write(write_synthetic_dng(u16))
        paths.append(p)
    return paths


def _visible_cards():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "burst_production_torch runs on the GPU by default, but no CUDA device is "
            "present (torch.cuda.is_available() is False). Pass device='cpu' (and "
            "devices=['cpu'] * n) to run on the CPU."
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(outdir=None, device="cuda", devices=None):
    """The workflow; returns the (N, H, W, 3) developed burst and writes its
    PNGs to ``outdir`` (a new temporary directory by default)."""
    tmpdir = outdir or tempfile.mkdtemp(prefix="pysp_burst_torch_")
    os.makedirs(tmpdir, exist_ok=True)
    paths = make_burst(tmpdir)
    sidecar_path = os.path.join(tmpdir, "burst.json")
    if devices is None:
        devices = _visible_cards() if torch.device(device).type == "cuda" else [device]

    # --- 1. fit on the first frame, persist --------------------------------
    frames = load_burst(paths, device=device)
    first = unstack_frames(frames)[0]
    model_r, model_b = fit_ca_models_gradient(first, steps=60)
    save_sidecar(sidecar_path, ca_model_r=model_r, ca_model_b=model_b)
    print(f"[burst] fitted CA on frame 0 -> {sidecar_path}")

    # --- 2. replay across the burst, sharded over the mesh -----------------
    params = load_sidecar(sidecar_path)
    n_dev = max(1, min(len(paths), len(devices)))
    mesh = make_mesh((n_dev, 1), devices=list(devices)[:n_dev])
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast))
    out = develop_pipeline_sharded(
        frames,
        mesh,
        cfg,
        ca_model_r=params["ca_model_r"],
        ca_model_b=params["ca_model_b"],
    )
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the sharded develop gave non-finite pixels")
    print(f"[burst] developed {out.shape[0]} frames on a {n_dev}-shard mesh")

    # --- 3. save through the fast PNG writer -------------------------------
    for i in range(out.shape[0]):
        save_image(os.path.join(tmpdir, f"out_{i:02d}.png"), out[i])
    print(f"[burst] wrote {out.shape[0]} PNGs under {tmpdir}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--shards", type=int, default=None,
                        help="shards on --device (default: one a visible card)")
    args = parser.parse_args()
    main(args.outdir, args.device,
         None if args.shards is None else [args.device] * args.shards)
