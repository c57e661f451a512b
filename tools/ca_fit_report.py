#!/usr/bin/env python3
"""Reports how pysp_tpu_torch's blind CA fits behave on synthetic ring charts
with known chromatic aberration, on the CPU or the card.

    python3 tools/ca_fit_report.py [--device cpu|cuda]

Two measurements, printed one line a case:

1. Fit direction. R is displaced by Poly3(0.04), planted through the model's
   inverse coordinate field as ``tests/test_ca.py`` plants CA, on a 500x752
   ring chart. For the template fit, the gradient fit of G onto R (what
   ``fit_ca_models_gradient`` does) and the gradient fit of R onto G (what the
   JAX package's ``fit_ca_models_gradient`` does), it prints R's fitted k1 and
   the mean absolute error of the R plane against the clean scene after
   ``remove_ca_from_raw`` with that model, beside the error before.
2. The matcher's sum order. On a 256x256 ring chart with R displaced by
   Poly3(0.02) and B by Poly3(-0.01), under three white balances, the R and
   B scale pairs of the template fit with the tile errors summed in one
   row-major accumulator (the port's order) and by ``torch.sum``: how many
   tiles moved, by how much, and the Poly3 k1 fitted from each.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pysp_tpu_torch import (  # noqa: E402
    Poly3CorrectionModel,
    RawFrame,
    compute_ca_lens_models_for_raw,
    remove_ca_from_raw,
)
from pysp_tpu_torch.core.bayer import bayer_to_rgbg  # noqa: E402
from pysp_tpu_torch.correct.ca import gradfit, matcher  # noqa: E402
from pysp_tpu_torch.correct.ca.instability import compute_structural_instability  # noqa: E402
from pysp_tpu_torch.correct.ca.removal import _maps_from_offsets  # noqa: E402
from pysp_tpu_torch.correct.ca.solver import get_scale_pairs_using_pooled_tiler  # noqa: E402
from pysp_tpu_torch.ops.resample import remap_bilinear  # noqa: E402
from pysp_tpu_torch.utils.testing import mosaic_rggb, ring_chart  # noqa: E402


def ca_frame(h: int, w: int, k_r: float, k_b, device, wb_neutral=None) -> tuple:
    """A ring chart's RGGB frame with R (and B unless ``k_b`` is None)
    displaced as tests/test_ca.py plants CA; returns it and the clean mosaic."""
    size = min(h, w)
    img = ring_chart(h, w, radii=tuple(size * f for f in (0.23, 0.33, 0.41)), amp=0.6,
                     sigma=size / 128, base=0.1) + 0.1
    rgb = np.dstack([img] * 3).astype(np.float32)
    planted = rgb.copy()
    for c, k in ((0, k_r), (2, k_b)):
        if k is None:
            continue
        plane = torch.from_numpy(np.ascontiguousarray(rgb[..., c])).to(device)
        coords = Poly3CorrectionModel(k).get_undistorted_coordinates(plane)
        planted[..., c] = remap_bilinear(plane, *_maps_from_offsets(coords, h, w)).cpu().numpy()
    frame = RawFrame.synthetic(mosaic_rggb(planted), wb_neutral=wb_neutral, device=device)
    return frame, mosaic_rggb(rgb)


def r_error(bayer: torch.Tensor, clean: np.ndarray) -> float:
    """Mean absolute error of the R plane against the clean one, 8 sites in."""
    r = bayer[0::2, 0::2].cpu().numpy()
    return float(np.abs(r - clean[0::2, 0::2])[8:-8, 8:-8].mean())


def fit_direction(device) -> None:
    frame, clean = ca_frame(500, 752, 0.04, None, device)
    r0, g1, _, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    template, _ = compute_ca_lens_models_for_raw(
        frame, Poly3CorrectionModel(), Poly3CorrectionModel(),
        max_distortion_additional_scale=0.05)
    fits = {"template": float(template.get_coefficients()[0]),
            "gradient, G onto R": gradfit.fit_radial_gradient(g, r0, "poly3", steps=120)[0][0],
            "gradient, R onto G": gradfit.fit_radial_gradient(r0, g, "poly3", steps=120)[0][0]}
    parts = []
    for name, k1 in fits.items():
        model = Poly3CorrectionModel()
        model._k1 = float(k1)
        after = r_error(remove_ca_from_raw(frame, model, None).bayer, clean)
        parts.append(f"{name}: k1 {k1:+.6f}, error after {after:.6f}")
    print(f"fit direction (R planted by Poly3(0.04), 500x752, {device}): error before "
          f"{r_error(frame.bayer, clean):.6f}; " + "; ".join(parts))


def _tile_errors_torch_sum(target, tiles, p):
    th, tw = tiles.shape[-2:]
    patches = matcher._bilinear_patches(target, p[..., 0], p[..., 1], th, tw)
    return torch.abs(patches - tiles[:, None]).sum(dim=(-2, -1))


def sum_order(device) -> None:
    max_r = float(np.hypot(255 / 2, 255 / 2))
    row_major = matcher._tile_errors
    for wb in ((1.0, 1.0, 1.0), (0.5, 1.0, 0.6), (0.45, 1.0, 0.62)):
        frame, _ = ca_frame(256, 256, 0.02, -0.01, device, wb_neutral=np.array(wb))
        si = compute_structural_instability(frame)
        reference = si[..., 1].contiguous()
        for channel, plane in (("R", 0), ("B", 2)):
            pairs = {}
            for name, fn in (("row-major", row_major), ("torch.sum", _tile_errors_torch_sum)):
                matcher._tile_errors = fn
                try:
                    pairs[name] = get_scale_pairs_using_pooled_tiler(
                        si[..., plane], reference, max_reach=0.03)
                finally:
                    matcher._tile_errors = row_major
            d = np.abs(pairs["row-major"] - pairs["torch.sum"]).max(axis=1)
            k1 = {}
            for name, p in pairs.items():
                model = Poly3CorrectionModel()
                model.compute_coefficients(p)
                k1[name] = float(model.get_coefficients()[0])
            print(f"matcher sum order (256x256 ring chart, WB neutral {wb}, {channel}, "
                  f"{device}): {int((d > 0).sum())} of {len(d)} tiles moved, by up to "
                  f"{d.max():.3g} in normalized radius ({d.max() * max_r:.3g} px); Poly3 k1 "
                  f"row-major {k1['row-major']:.6f}, torch.sum {k1['torch.sum']:.6f} "
                  f"({abs(k1['torch.sum'] / k1['row-major'] - 1):.2%} apart)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    device = torch.device(parser.parse_args().device)
    fit_direction(device)
    sum_order(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
