#!/usr/bin/env python3
"""Smoke run of pysp_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. Setup: a CUDA device must be present; prints the card's name and power
   limit, builds the CUDA kernels from ``pysp_tpu_torch/csrc`` with nvcc and
   prints the build time and ptxas report.
2. Each kernel against its plain PyTorch version on the card, on structured
   512x768 scenes (non-HDR and HDR, 0-2 chroma-median stages):
   - AHD kernel (through ``demosaic_ahd_mega``) against
     ``demosaic_ahd_channels``: stitched border bit-exact, interior >= 50 dB
     PSNR with < 5% of pixels off by > 1e-4 (H/V picks that flip at exact
     homogeneity ties); the fused colour tail within 2e-6 of the external tail.
   - postprocess kernel against ``postprocess_color_channels``: bit-exact.
3. The main path at 24 MP: a 4000x6000 RGGB synthetic DNG through
   ``load_raw -> .to("cuda") -> develop(Best) -> save_image``, then a 1500x2000
   BGGR DNG the same way. Asserts that both kernels launched during that run,
   that the images are finite, of the right shape and within [0, 1], and that
   each is >= 50 dB PSNR against the same develop through the plain version on
   the card.
4. Each kernel's wrapper against its plain version at the shapes the main path
   gives it, and times (CUDA events, median of 10 runs after 2 warm-ups) of the
   kernels, their plain versions and the whole develop.

The line before the last holds the per-kernel JSON summary, the one before it
the card's name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pysp_tpu_torch import QualityDemosaic, RawFrame, load_raw, save_image
from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix
from pysp_tpu_torch.demosaic.ahd import demosaic_ahd_channels, postprocess_color_channels
from pysp_tpu_torch.demosaic.ahd_mega import (
    demosaic_ahd_mega,
    develop_channels_mega,
    margin_for,
)
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.pipeline.develop import DevelopConfig, _color_tail_channels, develop
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FULL_H, FULL_W = 4000, 6000
BGGR_H, BGGR_W = 1500, 2000
FLIP_TOL = 1e-4      # a pixel differing by more is counted as a flipped pick
MIN_PSNR = 50.0
MAX_FLIP_FRAC = 0.05
TAIL_ATOL = 2e-6
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median over ``runs`` of one call's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def interior_stats(got: torch.Tensor, want: torch.Tensor):
    """(PSNR dB, fraction of pixels off by > FLIP_TOL, max abs error)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    d = np.abs(g - w)
    return psnr(g, w), float(np.mean(d > FLIP_TOL)), float(d.max())


def frame_on_card(h: int, w: int, seed: int, is_hdr: bool) -> RawFrame:
    bayer = mosaic_rggb(make_scene(h, w, seed=seed))
    return RawFrame.synthetic(bayer, cam_mat=CAM, wb_neutral=WB, is_hdr=is_hdr,
                              device=DEVICE)


def check_kernels_small() -> None:
    """Phase 2: each kernel against its plain version at 512x768."""
    for is_hdr in (False, True):
        for stages in (0, 1, 2):
            frame = frame_on_card(512, 768, seed=1 + stages, is_hdr=is_hdr)
            want = demosaic_ahd_channels(frame, stages)
            got = demosaic_ahd_mega(frame, stages)
            f = 2 * margin_for(stages)
            for name, g, w in zip("rgb", got, want):
                for part in (np.s_[:f, :], np.s_[-f:, :], np.s_[:, :f], np.s_[:, -f:]):
                    if not torch.equal(g[part], w[part]):
                        raise AssertionError(f"AHD {name}: stitched border differs from plain")
            p, flips, err = interior_stats(
                torch.stack(got)[:, f:-f, f:-f], torch.stack(want)[:, f:-f, f:-f]
            )
            mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
            external = torch.stack(_color_tail_channels(*got, mat, True, True), dim=-1)
            fused = develop_channels_mega(frame, stages, True, True)
            tail_err = (fused - external).abs().max().item()
            log(f"AHD kernel vs plain 512x768 hdr={is_hdr} stages={stages}: border "
                f"bit-exact, interior PSNR {p:.2f} dB, flipped {flips:.6f} of pixels "
                f"(max abs {err:.3g}), fused tail max abs err {tail_err:.3g}")
            if p < MIN_PSNR or flips >= MAX_FLIP_FRAC:
                raise AssertionError("AHD kernel interior outside tolerance")
            if tail_err > TAIL_ATOL:
                raise AssertionError("fused colour tail outside tolerance")

    rgb = torch.from_numpy(make_scene(512, 768, seed=5)).to(DEVICE)
    chans = [rgb[..., k].contiguous() for k in range(3)]
    got = K.postprocess_color_kernel(*chans)
    want = postprocess_color_channels(*chans)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("postprocess kernel differs from plain")
    log("postprocess kernel vs plain 512x768: bit-exact")


def synthetic_dng(h: int, w: int, seed: int, bggr: bool) -> bytes:
    """A structured scene as a u16 DNG in about [200, 4000]. A BGGR file holds
    the 180-degree rotation of an RGGB mosaic of the rotated scene, so that it
    develops to the scene in its own orientation."""
    rgb = make_scene(h, w, seed=seed)
    if bggr:
        mosaic = np.rot90(mosaic_rggb(np.ascontiguousarray(np.rot90(rgb, 2))), 2)
    else:
        mosaic = mosaic_rggb(rgb)
    u16 = np.ascontiguousarray(200 + mosaic * 3800).astype(np.uint16)
    pattern = (2, 1, 1, 0) if bggr else (0, 1, 1, 2)
    return write_synthetic_dng(u16, cfa_pattern=pattern)


def main_path(tmp: str):
    """Phase 3: file -> develop -> file on the card; returns the launch counts
    and the frames and images for the checks."""
    paths = {}
    for name, (h, w, bggr) in {"rggb": (FULL_H, FULL_W, False),
                               "bggr": (BGGR_H, BGGR_W, True)}.items():
        paths[name] = os.path.join(tmp, f"{name}.dng")
        with open(paths[name], "wb") as fh:
            fh.write(synthetic_dng(h, w, seed=7, bggr=bggr))

    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    K.ahd_kernel_launches = 0
    K.postprocess_kernel_launches = 0
    results = {}
    t0 = time.perf_counter()
    for name, path in paths.items():
        frame = load_raw(path).to(DEVICE)
        out = develop(frame, cfg)
        save_image(os.path.join(tmp, f"{name}.tif"), out)
        results[name] = (frame, out)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"ahd": K.ahd_kernel_launches,
                "postprocess_color": K.postprocess_kernel_launches}
    log(f"main path (2 DNGs, load_raw -> develop Best -> save_image): "
        f"{seconds:.3f} s host clock, kernel launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched the {name} kernel")

    plain_cfg = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
    for name, (frame, out) in results.items():
        h, w = frame.height, frame.width
        if tuple(out.shape) != (h, w, 3) or out.dtype != torch.float32:
            raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        lo, hi = out.min().item(), out.max().item()
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"{name}: output outside [0, 1]: [{lo}, {hi}]")
        tif = os.path.join(tmp, f"{name}.tif")
        if os.path.getsize(tif) < h * w * 6:
            raise AssertionError(f"{name}: {tif} is too short")
        p, flips, err = interior_stats(out, develop(frame, plain_cfg))
        log(f"{name} {h}x{w}: develop(kernel) vs develop(plain) on the card PSNR "
            f"{p:.2f} dB, {flips:.6f} of pixels off by > {FLIP_TOL:g}, max abs {err:.3g}; "
            f"range [{lo:.4f}, {hi:.4f}]")
        if p < MIN_PSNR:
            raise AssertionError(f"{name}: develop PSNR {p:.2f} dB < {MIN_PSNR}")
    return launches, results["rggb"][0]


def kernels_at_main_shapes(frame: RawFrame):
    """Phase 4: each wrapper against its plain version at the main path's
    shapes, and the times. Returns the per-kernel summary records."""
    stages = 1
    f = 2 * margin_for(stages)
    s = 2 * f + 8
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    tail = (True, True)
    got = K.ahd_kernel(frame.bayer, mat, wb, frame.is_hdr, stages, tail)
    want = K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)
    p, flips, ahd_err = interior_stats(got[f:-f, f:-f], want[f:-f, f:-f])
    log(f"AHD kernel vs plain at {FULL_H}x{FULL_W} (tail fused, border excluded): "
        f"PSNR {p:.2f} dB, {flips:.6f} of pixels off by > {FLIP_TOL:g}, "
        f"max abs {ahd_err:.3g}")
    if p < MIN_PSNR or flips >= MAX_FLIP_FRAC:
        raise AssertionError("AHD kernel at 24 MP outside tolerance")
    del got, want

    # The postprocess kernel's main-path shapes: the four border strips.
    h, w = frame.height, frame.width
    rgb = torch.from_numpy(make_scene(h, w, seed=9)).to(DEVICE)
    strips = [rgb[:s], rgb[h - s:], rgb[:, :s], rgb[:, w - s:]]
    strips = [[t[..., k].contiguous() for k in range(3)] for t in strips]
    full = [rgb[..., k].contiguous() for k in range(3)]
    pp_err = 0.0
    for chans in strips + [full]:
        got = K.postprocess_color_kernel(*chans)
        want = postprocess_color_channels(*chans)
        for g, w_ in zip(got, want):
            pp_err = max(pp_err, (g - w_).abs().max().item())
            if not torch.equal(g, w_):
                raise AssertionError(f"postprocess kernel differs from plain at {tuple(g.shape)}")
    log(f"postprocess kernel vs plain at the strips {s}x{w}, {h}x{s} and at "
        f"{h}x{w}: bit-exact")

    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    plain_cfg = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
    t = {
        "ahd": median_ms(lambda: K.ahd_kernel(frame.bayer, mat, wb, frame.is_hdr, stages, tail)),
        "ahd_plain": median_ms(lambda: K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)),
        "pp_strips": median_ms(lambda: [K.postprocess_color_kernel(*c) for c in strips]),
        "pp_strips_plain": median_ms(lambda: [postprocess_color_channels(*c) for c in strips]),
        "pp_full": median_ms(lambda: K.postprocess_color_kernel(*full)),
        "pp_full_plain": median_ms(lambda: postprocess_color_channels(*full)),
        "develop": median_ms(lambda: develop(frame, cfg)),
        "develop_plain": median_ms(lambda: develop(frame, plain_cfg)),
    }
    mp = h * w / 1e6
    log(f"times at {h}x{w} ({mp:g} MP), median of 10 by CUDA events: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"develop Best {mp / (t['develop'] / 1e3):.2f} MP/s with the kernels, "
        f"{mp / (t['develop_plain'] / 1e3):.2f} MP/s plain")
    return [
        {"name": "ahd", "route": "cuda", "source": "pysp_tpu_torch/csrc/ahd.cu",
         "replaces": "pysp_tpu/ops/pallas_kernels.py:672",
         "max_abs_err": ahd_err, "ms": t["ahd"], "plain_ms": t["ahd_plain"]},
        {"name": "postprocess_color", "route": "cuda",
         "source": "pysp_tpu_torch/csrc/postprocess.cu",
         "replaces": "pysp_tpu/ops/pallas_kernels.py:337",
         "max_abs_err": pp_err, "ms": t["pp_strips"], "plain_ms": t["pp_strips_plain"]},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    K.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {K.build_seconds:.2f} s)")
    log("ptxas report:\n" + "\n".join(
        line for line in K.build_log.splitlines() if "ptxas" in line))

    check_kernels_small()
    with tempfile.TemporaryDirectory() as tmp:
        launches, frame = main_path(tmp)
    records = kernels_at_main_shapes(frame)
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
