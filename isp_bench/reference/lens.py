"""The lens-corrected chain of one frame in plain PyTorch, as the command
line runs it after the load (``develop x.dng --params lens.json
--repair-hot-pixels --warp``):

1. lateral CA removal with Poly3 models for R and B: the forward radial map
   ``k1 r^3 + (1 - k1) r`` and its inverse by 8 Newton steps from zero, the
   coordinate fields at full resolution (radius 1 at the corner, scale 1 at
   an exact centre), the edge-aware green, R and B upsampled with its high
   frequencies, bilinear remaps with clamp-to-edge sampling;
2. the hot-pixel detector and heal of ``develop.py`` (one frame, no
   consensus);
3. the Best develop of ``develop.py``;
4. the DNG OpcodeList3 WarpRectilinear (radial and tangential terms about
   the optical centre, normalised by the farthest corner) with a Lanczos4
   remap (exact weights, normalised by their sum).

A frozen copy of the port's plain paths; it imports nothing of the program.
Everything runs in the mosaic's dtype but the coordinate maps, which are
float32 geometry.

The develop and the warp can run in row bands (``band_rows``): the warp of a
band's output rows reads the developed rows its maps reach, and those are
developed from a mosaic band ``HALO`` rows wider on either side, so each
band's rows equal the whole frame's. The CA removal, the detector (whose
quantile is the whole frame's) and the heal run on the whole frame.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import demosaic
from . import develop as ref

Tensor = torch.Tensor

# Mosaic rows developed beyond a band's rows on either side: more than the
# Best develop's reach (the green's 5 taps, the phase upsample's 3x3 on the
# quarter planes, the homogeneity's window and box sum, the chroma-median
# stage's chained 5x5 medians), and even, so that a band keeps the RGGB phase.
HALO = 32

NEWTON_STEPS = 8


# --- the CA removal -------------------------------------------------------------

class Poly3:
    """``Rd = k1 Ru^3 + (1 - k1) Ru``, and its inverse by Newton from zero."""

    def __init__(self, k1: float):
        self.k1 = min(1.0, max(float(k1), -0.499))

    def forward(self, und: Tensor) -> Tensor:
        return self.k1 * und**3 + (1.0 - self.k1) * und

    def _prime(self, und: Tensor) -> Tensor:
        return 3.0 * self.k1 * und**2 + (1.0 - self.k1)

    def inverse(self, dist: Tensor) -> Tensor:
        und = torch.zeros_like(dist)
        for _ in range(NEWTON_STEPS):
            und = und - ((self.forward(und) - dist) / self._prime(und))
        return und


def coordinate_maps(h: int, w: int, radial_fn, device):
    """Clipped (map_x, map_y) float32 of the radial map ``radial_fn`` on an
    (h, w) grid: each pixel moved along its radius by ``radial_fn(r) / r``
    (1 where r is 0), the radius normalised to 1 at the corner."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r_corner = float(np.hypot(cy, cx))
    ys = (torch.arange(h, dtype=torch.float32, device=device) - cy)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, :]
    r = torch.sqrt(ys * ys + xs * xs) / r_corner
    centre = r == 0
    r_safe = torch.where(centre, torch.ones_like(r), r)
    scale = torch.where(centre, torch.ones_like(r), radial_fn(r_safe) / r_safe)
    dy = ys.expand(h, w) * scale
    dx = xs.expand(h, w) * scale
    map_x = torch.clamp(dx + (w - 1) / 2.0, 0, w - 1)
    map_y = torch.clamp(dy + (h - 1) / 2.0, 0, h - 1)
    return map_x, map_y


def _floor_split(map_x: Tensor, map_y: Tensor):
    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    return x0.long(), y0.long(), map_x - x0, map_y - y0


def _gather(img: Tensor, yi: Tensor, xi: Tensor, row0: int = 0, full_h=None) -> Tensor:
    """``img[..., yi, xi]`` with the indices clamped to the frame (of
    ``full_h`` rows, of which ``img`` holds the band from ``row0``)."""
    h, w = img.shape[-2], img.shape[-1]
    yi = yi.clamp(0, (full_h or h) - 1) - row0
    xi = xi.clamp(0, w - 1)
    flat = img.reshape(*img.shape[:-2], h * w)
    idx = yi * w + xi
    return flat.index_select(-1, idx.reshape(-1)).reshape(*img.shape[:-2], *idx.shape)


def remap_bilinear(img: Tensor, map_x: Tensor, map_y: Tensor) -> Tensor:
    x0, y0, fx, fy = _floor_split(map_x, map_y)
    fx, fy = fx.to(img.dtype), fy.to(img.dtype)
    i00, i01 = _gather(img, y0, x0), _gather(img, y0, x0 + 1)
    i10, i11 = _gather(img, y0 + 1, x0), _gather(img, y0 + 1, x0 + 1)
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def green_full(g1: Tensor, g2: Tensor) -> Tensor:
    """The mosaic's green at full resolution: G1 and G2 kept, G at R and B
    by the edge-aware mix of their four neighbours (BORDER_REFLECT)."""
    h, w = g1.shape[-2:]
    g1p = demosaic.pad(g1, 1, 1, 1, 1, "symmetric")
    g2p = demosaic.pad(g2, 1, 1, 1, 1, "symmetric")
    g_at_b = demosaic._mix(g1p[..., 1:1 + h, 1:1 + w], g1p[..., 2:2 + h, 1:1 + w],
                           g2p[..., 1:1 + h, 1:1 + w], g2p[..., 1:1 + h, 2:2 + w])
    g_at_r = demosaic._mix(g2p[..., 0:h, 1:1 + w], g2p[..., 1:1 + h, 1:1 + w],
                           g1p[..., 1:1 + h, 0:w], g1p[..., 1:1 + h, 1:1 + w])
    return demosaic.interleave(g_at_r, g1, g_at_b, g2)


def upsample_with_green(plane: Tensor, g_full: Tensor, left: bool, bottom: bool) -> Tensor:
    """A quarter plane at full resolution: its phase upsample plus the
    green's high frequencies."""
    hf = g_full - demosaic.correlate(g_full, demosaic.GAUSS3)
    return demosaic.phase_upsample(plane, left, bottom) + hf


def remove_ca(bayer: Tensor, wb_neutral: Tensor, model_r: Poly3, model_b: Poly3) -> Tensor:
    """The RGGB mosaic with R and B aligned onto G: G moved onto each
    channel's grid by the inverse map, the channel upsampled with it in WB
    space, moved back by the forward map and sampled at its photosites."""
    h, w = bayer.shape
    wb = 1.0 / wb_neutral
    r, g1, b, g2 = demosaic.rgbg(bayer)
    g = green_full(g1, g2)
    out = {}
    for name, plane, model, k, left, bottom in (("r", r, model_r, 0, True, False),
                                                ("b", b, model_b, 2, False, True)):
        g_at = remap_bilinear(g, *coordinate_maps(h, w, model.inverse, bayer.device))
        full = upsample_with_green(plane * wb[k], g_at, left, bottom)
        back = remap_bilinear(full, *coordinate_maps(h, w, model.forward, bayer.device))
        out[name] = demosaic.rgbg(back)[k] / wb[k]
    return demosaic.interleave(out["r"], g1, out["b"], g2)


# --- the warp ---------------------------------------------------------------------

def warp_maps(coeffs, center, h: int, w: int, row0: int, n_rows: int, device):
    """Clipped (map_x, map_y) float32 of a WarpRectilinear plane for output
    rows [row0, row0 + n_rows) of an (h, w) frame."""
    cx = (w - 1) * center[0]
    cy = (h - 1) * center[1]
    m = (max(abs(-cx), abs(w - 1 - cx)) ** 2 + max(abs(-cy), abs(h - 1 - cy)) ** 2) ** 0.5

    def f32(v):
        return torch.tensor(np.float32(v), device=device)

    k = torch.as_tensor(np.asarray(coeffs, np.float32), device=device)
    kr0, kr1, kr2, kr3, kt0, kt1 = (k[i] for i in range(6))
    m, cx, cy = f32(m), f32(cx), f32(cy)
    sx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(n_rows, w)
    sy = (torch.arange(n_rows, dtype=torch.float32, device=device) + row0)[:, None] \
        .expand(n_rows, w)
    dx = (sx - cx) / m
    dy = (sy - cy) / m
    r2 = dx * dx + dy * dy
    f = kr0 + r2 * (kr1 + r2 * (kr2 + r2 * kr3))
    dxt = kt0 * (2 * dx * dy) + kt1 * (r2 + 2 * dx * dx)
    dyt = kt1 * (2 * dx * dy) + kt0 * (r2 + 2 * dy * dy)
    xp = cx + m * (f * dx + dxt)
    yp = cy + m * (f * dy + dyt)
    out_x = sx + (xp - sx) * 1.0
    out_y = sy + (yp - sy) * 1.0
    return out_x.clamp(0, w - 1), out_y.clamp(0, h - 1)


def _lanczos4_weights(frac: Tensor) -> list:
    """The 8 tap weights at offsets -3..4, normalised by their sum taken in
    tap order."""
    eps = 1e-7
    planes = []
    for k in range(8):
        t = frac - float(k - 3)
        pit = math.pi * t
        small = t.abs() < eps
        safe = torch.where(small, 1.0, pit)
        sinc = torch.where(small, 1.0, torch.sin(safe) / safe)
        safe4 = torch.where(small, 1.0, pit / 4.0)
        sinc4 = torch.where(small, 1.0, torch.sin(safe4) / safe4)
        planes.append(torch.where(t.abs() < 4.0, sinc * sinc4, 0.0))
    total = planes[0]
    for k in range(1, 8):
        total = total + planes[k]
    return [p / total for p in planes]


def remap_lanczos4(img: Tensor, map_x: Tensor, map_y: Tensor, row0: int = 0,
                   full_h=None) -> Tensor:
    """Lanczos4 remap of the (C, rows, W) ``img`` (the frame's rows from
    ``row0``, of ``full_h`` in all) at the maps' points, clamp-to-edge:
    rows outer, taps inner, each sum seeded with zero."""
    x0, y0, fx, fy = _floor_split(map_x, map_y)
    wx = _lanczos4_weights(fx.to(img.dtype))
    wy = _lanczos4_weights(fy.to(img.dtype))
    out = torch.zeros(img.shape[:-2] + map_x.shape, dtype=img.dtype, device=img.device)
    for j in range(8):
        row = torch.zeros_like(out)
        for i in range(8):
            row = row + wx[i] * _gather(img, y0 + (j - 3), x0 + (i - 3), row0, full_h)
        out = out + wy[j] * row
    return out


# --- the chain --------------------------------------------------------------------

def develop_and_warp(f: ref.Frame, develop_conf: dict, warp: dict, band_rows=None) -> Tensor:
    """The (H, W, 3) Best develop of ``f`` warped by ``warp``'s
    WarpRectilinear, whole or in row bands of ``band_rows`` output rows."""
    h, w = f.bayer.shape
    coeffs, center = warp["coefficients"], warp["center"]
    if len(set(map(tuple, coeffs))) != 1:
        raise ValueError("the reference warps with one coefficient set for every plane")
    args = ("best", develop_conf["postprocess_stages"], develop_conf["clip_highlights"],
            develop_conf["gamma_encode"])
    step = h if band_rows is None else int(band_rows)
    out = None
    for a in range(0, h, step):
        b = min(a + step, h)
        mx, my = warp_maps(coeffs[0], center, h, w, a, b - a, f.bayer.device)
        # the developed rows the taps reach, then HALO more, from an even row
        lo = max(int(torch.floor(my.min())) - 3, 0)
        hi = min(int(torch.floor(my.max())) + 5, h)
        s = max(lo - HALO, 0) // 2 * 2
        e = min((hi + HALO + 1) // 2 * 2, h)
        img = ref.develop(dataclasses.replace(f, bayer=f.bayer[s:e]), *args)
        warped = remap_lanczos4(img.movedim(-1, 0), mx, my, s, h).movedim(0, -1)
        if out is None:
            if step >= h:
                return warped.contiguous()
            out = torch.empty((h, w, warped.shape[-1]), dtype=warped.dtype, device=warped.device)
        out[a:b] = warped
        del img, warped
    return out


def lens_chain(f: ref.Frame, lens: dict, detector: dict, develop_conf: dict,
               band_rows=None) -> Tensor:
    """The (H, W, 3) image of one frame through CA removal, the hot-pixel
    heal, the Best develop and the warp."""
    models = {k: Poly3(lens["ca_models"][k]["k1"]) for k in ("r", "b")}
    bayer = remove_ca(f.bayer, f.wb_neutral.to(f.bayer.dtype), models["r"], models["b"])
    masks = ref.hot_masks(bayer, detector["hot_pixel_multiplier"], detector["hot_pixel_quantile"])
    bayer = ref.unplanes(ref.heal(ref.planes(bayer), masks, detector["hot_pixel_iterations"]))
    return develop_and_warp(dataclasses.replace(f, bayer=bayer), develop_conf,
                            lens["warp_rectilinear"], band_rows)
