"""Gather-based resampling: bilinear / Lanczos4 remap, fractional crops.

Counterpart of ``pysp_tpu/ops/resample.py``, with its exact gather semantics
(cv2.remap's convention: ``map_x`` / ``map_y`` give the float source position
of every destination pixel; samples outside the image are clamped to its
edge). ``remap_bilinear`` and ``remap_lanczos4`` are plain PyTorch and are
the semantics of the remap kernel (``ops.cuda_kernels.remap_kernel``), which
``remap_bounded`` runs on CUDA tensors.

Not carried: the select-chain ``remap_*_bounded`` forms, the polynomial
Lanczos weights and the separable ``*_sep`` kinds. They exist because Mosaic
has no gather; Hopper gathers natively, and the port computes the exact
function, as the JAX package does off the TPU.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .cuda_kernels import remap_kernel, remap_plain

Tensor = torch.Tensor


def _gather2d(img: Tensor, yi: Tensor, xi: Tensor) -> Tensor:
    """img[(yi, xi)] with indices clamped to the image bounds; img (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    yi = yi.clamp(0, h - 1)
    xi = xi.clamp(0, w - 1)
    flat = img.reshape(*img.shape[:-2], h * w)
    idx = yi * w + xi
    return flat.index_select(-1, idx.reshape(-1)).reshape(*img.shape[:-2], *idx.shape)


def _floor_split(map_x: Tensor, map_y: Tensor):
    """Integer floor indices and fractional phases of the maps."""
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    return x0.long(), y0.long(), map_x - x0, map_y - y0


def _bilinear_at(img: Tensor, x0i: Tensor, y0i: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    i00 = _gather2d(img, y0i, x0i)
    i01 = _gather2d(img, y0i, x0i + 1)
    i10 = _gather2d(img, y0i + 1, x0i)
    i11 = _gather2d(img, y0i + 1, x0i + 1)
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def remap_bilinear(img: Tensor, map_x: Tensor, map_y: Tensor) -> Tensor:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) with clamp-to-edge sampling."""
    x0i, y0i, fx, fy = _floor_split(map_x, map_y)
    return _bilinear_at(img, x0i, y0i, fx.to(img.dtype), fy.to(img.dtype))


def _lanczos4_weight_planes(frac: Tensor) -> list:
    """8 Lanczos (a=4) tap weights for taps at offsets -3..4 from floor(coord),
    normalized by their sum taken in ascending tap order."""
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
    return [w / total for w in planes]


def _lanczos4_weights(frac: Tensor) -> Tensor:
    """Stacked (..., 8) view of :func:`_lanczos4_weight_planes`."""
    return torch.stack(_lanczos4_weight_planes(frac), dim=-1)


def _lanczos4_at(img: Tensor, x0i: Tensor, y0i: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    wx = _lanczos4_weight_planes(fx)
    wy = _lanczos4_weight_planes(fy)
    out = torch.zeros(torch.broadcast_shapes(x0i.shape, y0i.shape), dtype=img.dtype,
                      device=img.device)
    # rows outer, taps inner, each sum seeded with zero
    for j in range(8):
        row_acc = torch.zeros_like(out)
        for i in range(8):
            row_acc = row_acc + wx[i] * _gather2d(img, y0i + (j - 3), x0i + (i - 3))
        out = out + wy[j] * row_acc
    return out


def remap_lanczos4(img: Tensor, map_x: Tensor, map_y: Tensor) -> Tensor:
    """cv2.remap(img, map_x, map_y, INTER_LANCZOS4) with exact (continuous)
    weights, where cv2 quantizes positions to 1/32 px."""
    x0i, y0i, fx, fy = _floor_split(map_x, map_y)
    return _lanczos4_at(img, x0i, y0i, fx.to(img.dtype), fy.to(img.dtype))


def _delta_fields(
    map_x: Tensor, map_y: Tensor, h: int, w: int,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
):
    """Integer floor-index displacements from the identity grid, clipped into
    the caller's bounds, plus the fractional phases."""
    x0i, y0i, fx, fy = _floor_split(map_x, map_y)
    rows = torch.arange(h, device=map_x.device)[:, None]
    cols = torch.arange(w, device=map_x.device)[None, :]
    dyv = (y0i - rows).clamp(int(dy_bounds[0]), int(dy_bounds[1]))
    dxv = (x0i - cols).clamp(int(dx_bounds[0]), int(dx_bounds[1]))
    return dyv, dxv, fx, fy


def remap_at_bounds(
    img: Tensor, map_x: Tensor, map_y: Tensor,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int], kind: str,
) -> Tensor:
    """The plain displacement-bounded remap: the gather remap with each floor
    displacement from the identity grid clipped into the bounds (equal to the
    gather remap when the bounds hold, as they do for a warp's own bounds)."""
    h, w = img.shape[-2], img.shape[-1]
    dyv, dxv, fx, fy = _delta_fields(map_x, map_y, h, w, dy_bounds, dx_bounds)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    at = _lanczos4_at if kind == "lanczos4" else _bilinear_at
    return at(img, cols + dxv, rows + dyv, fx.to(img.dtype), fy.to(img.dtype))


def remap_bounded(
    img: Tensor, map_x: Tensor, map_y: Tensor,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
    kind: str = "bilinear", use_pallas: bool = True,
) -> Tensor:
    """Displacement-bounded remap of an (H, W) plane or a (C, H, W) stack, with
    maps (H, W) shared across channels or (C, H, W) per channel. ``kind`` is
    "bilinear" or "lanczos4". On a CUDA tensor it runs the remap kernel, which
    launches or raises; with ``use_pallas=False``, or on a CPU tensor, its
    plain version (:func:`remap_at_bounds` per plane)."""
    remap = remap_kernel if use_pallas else remap_plain
    return remap(img, map_x, map_y, kind, bounds=(dy_bounds, dx_bounds))


def bilinear_sample(
    image: Tensor, offset: Tuple[float, float], width: int, height: int
) -> Tensor:
    """Fractional crop via bilinear interpolation. ``offset`` is (y, x) of the
    crop corner through pixel centers."""
    off_y, off_x = offset
    ys = torch.arange(height, dtype=torch.float32, device=image.device) + off_y
    xs = torch.arange(width, dtype=torch.float32, device=image.device) + off_x
    map_y, map_x = torch.meshgrid(ys, xs, indexing="ij")
    return remap_bilinear(image, map_x, map_y)


def identity_map(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: (map_x, map_y) identity coordinate fields."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    return xs, ys
