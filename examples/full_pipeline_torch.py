"""The maximal develop on pysp_tpu_torch: every subsystem in one flow.

The PyTorch + CUDA counterpart of ``examples/full_pipeline.py``. Builds a
synthetic bracketed burst of DNGs (with CA, hot pixels, vignetting and an
embedded WarpRectilinear opcode), then runs the full production pipeline on
the card (or ``--device cpu``):

  decode -> hot-pixel heal -> flat-field -> HDR fuse -> blind CA fit + removal ->
  AHD develop (HDR branch) -> DNG opcode warp (bilinear) -> Oklab unsharp -> save PNG

On the card the heal, the Best develop and both resamples run on the
hand-written kernels (heal, AHD's demosaic-only planes, remap).

Run: python examples/full_pipeline_torch.py [outdir] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import threading

import numpy as np
import torch

from pysp_tpu_torch import (
    DevelopConfig,
    Poly3CorrectionModel,
    QualityDemosaic,
    RawFrame,
    apply_opcode_3_warp,
    compute_ca_lens_models_for_raw,
    develop_to_image,
    encode_warp_rectilinear,
    find_erroneous_pixels_median,
    find_shared_pixels,
    flat_frame_correction,
    fuse_exposures_to_raw,
    get_opcode_3_block,
    lin_srgb_to_srgb,
    load_raw_dng,
    remap_bilinear,
    remove_ca_from_raw,
    repair_bad_pixels,
    save_image,
    stack_frames,
    unsharp_mask_lab,
)
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.utils.testing import mosaic_rggb, ring_chart
from pysp_tpu_torch.utils import tracing
from pysp_tpu_torch.utils.tracing import span


def make_burst(outdir: str, n: int = 3, size: int = 256):
    """Synthesize a bracketed DNG burst with CA + hot pixels + vignetting
    (on the host: the files are the input)."""
    img = ring_chart(size, size, radii=(60, 90, 110), amp=0.5, base=0.25)
    rgb = np.dstack([img, img, img]).astype(np.float32)

    # lateral CA on R
    model = Poly3CorrectionModel(0.04)
    coords = model.get_undistorted_coordinates(torch.zeros((size, size))).numpy()
    mx = np.clip(coords[..., 1] + (size - 1) / 2, 0, size - 1).astype(np.float32)
    my = np.clip(coords[..., 0] + (size - 1) / 2, 0, size - 1).astype(np.float32)
    rgb[..., 0] = remap_bilinear(torch.from_numpy(rgb[..., 0].copy()), torch.from_numpy(mx),
                                 torch.from_numpy(my)).numpy()

    # vignetting
    yy, xx = np.mgrid[0:size, 0:size]
    r2 = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2) / (size * size / 2)
    vignette = (1.0 - 0.3 * r2).astype(np.float32)

    paths = []
    rng = np.random.default_rng(0)
    for i in range(n):
        gain = 0.5 * (2.0**i) / (2.0 ** (n - 1))
        mosaic = mosaic_rggb(np.clip(rgb * gain * vignette[..., None], 0, 1))
        counts = np.clip(mosaic * 3839 + 256, 0, 4095).astype(np.uint16)
        # hot pixels
        for _ in range(6):
            y, x = rng.integers(4, size - 4, 2)
            counts[y, x] = 4095
        block = encode_warp_rectilinear(
            [(1.01, -0.03, 0.0, 0.0, 0.0, 0.0)] * 3, (0.5, 0.5)
        )
        path = os.path.join(outdir, f"burst_{i}.dng")
        with open(path, "wb") as f:
            f.write(
                write_synthetic_dng(
                    counts,
                    opcode_list_3=block,
                    exposure_time=(1, 100 * 2 ** (n - 1 - i)),
                    compression=1,
                )
            )
        paths.append(path)
    return paths, vignette


def run(paths, vignette: np.ndarray, out_path: str, device="cuda"):
    """The pipeline on a written burst; returns ``(sRGB image, R's CA model)``
    and saves the image to ``out_path``. Each stage is a span of the port's
    recorder (``utils/tracing.py``), recorded while it is on."""
    with span("decode"):
        frames = [load_raw_dng(p, device=device) for p in paths]

    with span("hot_pixels"):
        masks = [find_erroneous_pixels_median(f, quantile=0.999) for f in frames]
        shared = find_shared_pixels(masks, min_ratio=0.5)
        frames = [repair_bad_pixels(f, shared) for f in frames]

    with span("flat_field"):
        flat = RawFrame.synthetic(mosaic_rggb(np.dstack([vignette] * 3)), device=device)
        frames = [flat_frame_correction(f, flat) for f in frames]

    with span("hdr_fuse"):
        batch = stack_frames(frames, device=device)
        hdr, _counts = fuse_exposures_to_raw(batch)

    with span("ca_fit"):
        model_r, model_b = compute_ca_lens_models_for_raw(
            hdr,
            init_model_r=Poly3CorrectionModel(),
            init_model_b=None,
            max_distortion_additional_scale=0.06,
        )

    with span("ca_remove"):
        hdr = remove_ca_from_raw(hdr, model_r, None)

    with span("develop"):
        cfg = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)
        dev = develop_to_image(hdr, cfg)
        lin = dev.to_lin_srgb(clip_highlights=False)

    with span("dng_warp"):
        block = get_opcode_3_block(paths[0])
        lin = apply_opcode_3_warp(lin, block, interpolation="bilinear")

    with span("sharpen_and_encode"):
        lin = unsharp_mask_lab(torch.clamp(lin, 0, 1), radius=1.0, amount=0.3)
        srgb = lin_srgb_to_srgb(lin)
        save_image(out_path, srgb)
    return srgb, model_r


def stage_report(spans) -> str:
    """Host milliseconds of each stage, the spans opened on this thread with
    no enclosing span, in the order they ran, then their total."""
    main = threading.get_ident()
    times = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.parent_id is None and s.thread_id == main:
            times[s.name] = times.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    lines = [f"{k}: {v:.1f} ms" for k, v in times.items()]
    lines.append(f"total: {sum(times.values()):.1f} ms")
    return "\n".join(lines)


def main(outdir: str = "/tmp/pysp_demo_torch", device="cuda") -> str:
    os.makedirs(outdir, exist_ok=True)
    tracing.enable()
    try:
        with span("synthesize"):
            paths, vignette = make_burst(outdir)
        out_path = os.path.join(outdir, "developed.png")
        _, model_r = run(paths, vignette, out_path, device)
    finally:
        tracing.disable()
        recorded = tracing.drain()

    print(stage_report(recorded.spans))
    print(f"fitted CA k1 = {float(model_r.get_coefficients()[0]):.4f} (true 0.04)")
    print(f"-> {out_path}")
    return out_path


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?", default="/tmp/pysp_demo_torch")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args()
    main(args.outdir, args.device)
