"""DNG 1.4 WarpRectilinear coordinate tables and the warp resample.

Counterpart of ``pysp_tpu/warp/rectilinear.py``: the radial polynomial
``f = kr0 + kr1 r^2 + kr2 r^4 + kr3 r^6`` plus the tangential ``kt0/kt1`` terms,
normalized by the largest corner distance m, with ``scale`` lerping between
identity and the full warp; a grid variant and a seed (prior) variant that
lets warps compose into one resample.

Maps are float32 tensor arithmetic in the JAX package's order; the division
by m divides by a 0-d tensor on the maps' device, so that CUDA divides as the
CPU does. Every resample goes through the remap kernel
(``ops.cuda_kernels.remap_kernel``); ``warp_image_rectilinear`` warps all
channels of an (H, W, C) image in one launch, in that layout.

With the recorder of ``utils/tracing.py`` on, each warp is the spans
``warp.maps`` (the displacement bounds and the clipped tables) and
``warp.remap`` (the remap kernel's launch), both timed on the device too.

Not carried: the TPU's select-chain sizing (``warp_sep_pos_error``,
``warp_row_zones``, ``warp_grid_zones``, ``_GRID_ZONES``), which exists
because Mosaic has no gather.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import CARD, resolve_device
from ..ops.cuda_kernels import remap_kernel
from ..utils.tracing import span

Tensor = torch.Tensor


def _warp_coords(
    seed_x: Tensor,
    seed_y: Tensor,
    coeffs: Tensor,  # (6,): kr0 kr1 kr2 kr3 kt0 kt1
    m: Tensor,
    center_x: Tensor,
    center_y: Tensor,
    scale: float,
) -> Tuple[Tensor, Tensor]:
    kr0, kr1, kr2, kr3, kt0, kt1 = (coeffs[i] for i in range(6))

    dx = (seed_x - center_x) / m
    dy = (seed_y - center_y) / m
    r2 = dx * dx + dy * dy
    f = kr0 + r2 * (kr1 + r2 * (kr2 + r2 * kr3))

    dxr = f * dx
    dyr = f * dy
    dxt = kt0 * (2 * dx * dy) + kt1 * (r2 + 2 * dx * dx)
    dyt = kt1 * (2 * dx * dy) + kt0 * (r2 + 2 * dy * dy)

    xp = center_x + m * (dxr + dxt)
    yp = center_y + m * (dyr + dyt)

    out_x = seed_x + (xp - seed_x) * scale
    out_y = seed_y + (yp - seed_y) * scale
    return out_x, out_y


def _geometry(width: int, height: int, cam_center_norm: Tuple[float, float]):
    cx = (width - 1) * cam_center_norm[0]
    cy = (height - 1) * cam_center_norm[1]
    max_dist_x = max(abs(-cx), abs(width - 1 - cx))
    max_dist_y = max(abs(-cy), abs(height - 1 - cy))
    m = (max_dist_x**2 + max_dist_y**2) ** 0.5
    return cx, cy, m


def _coords_from_seeds(seed_x, seed_y, coeffs, width, height, cam_center_norm, scale):
    cx, cy, m = _geometry(width, height, cam_center_norm)

    def f32(v):
        return torch.tensor(np.float32(v), device=seed_x.device)

    k = torch.as_tensor(np.asarray(coeffs, np.float32), device=seed_x.device)
    return _warp_coords(seed_x, seed_y, k, f32(m), f32(cx), f32(cy), scale)


def compute_remapping_table(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    device=CARD,
) -> Tuple[Tensor, Tensor]:
    """(map_x, map_y) warp tables from the pixel grid, on ``device``."""
    return compute_remapping_table_window(
        coeffs, width, height, cam_center_norm, scale, 0, height, device
    )


def compute_remapping_table_window(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
    row0,
    n_rows: int,
    device=CARD,
) -> Tuple[Tensor, Tensor]:
    """Warp tables for output rows [row0, row0+n_rows) of a FULL frame: the
    same values as ``compute_remapping_table(...)[row0:row0+n_rows]``, built at
    the absolute rows (the geometry stays the full frame's)."""
    device = resolve_device(device)
    ys = (torch.arange(n_rows, dtype=torch.float32, device=device) + row0)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    seed_x = xs.expand(n_rows, width)
    seed_y = ys.expand(n_rows, width)
    return _coords_from_seeds(seed_x, seed_y, coeffs, width, height, cam_center_norm, scale)


def compute_offset_remapping_table(
    seed_x: Tensor,
    seed_y: Tensor,
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """Warp tables from a prior coordinate field: warp composition."""
    return _coords_from_seeds(seed_x, seed_y, coeffs, width, height, cam_center_norm, scale)


def _floor_disp_minmax(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
    row_range: Tuple[int, int],
    col_range: Tuple[int, int],
):
    """Memoizing front end for :func:`_floor_disp_minmax_impl`."""
    return _floor_disp_minmax_impl(
        tuple(float(v) for v in coeffs),
        width,
        height,
        (float(cam_center_norm[0]), float(cam_center_norm[1])),
        float(scale),
        (int(row_range[0]), int(row_range[1])),
        (int(col_range[0]), int(col_range[1])),
    )


@functools.lru_cache(maxsize=256)
def _floor_disp_minmax_impl(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
    row_range: Tuple[int, int],
    col_range: Tuple[int, int],
):
    """EXACT floor-displacement extrema of the map over an output rectangle,
    swept over every pixel in float64 on the host, 256 rows at a time."""
    cx, cy, m = _geometry(width, height, cam_center_norm)
    k = np.asarray(coeffs, np.float64)
    r0, r1 = row_range
    c0, c1 = col_range
    xs = np.arange(c0, c1, dtype=np.float64)[None, :]
    dy_lo = dy_hi = dx_lo = dx_hi = None
    for b0 in range(r0, r1, 256):
        b1 = min(b0 + 256, r1)
        sy = np.arange(b0, b1, dtype=np.float64)[:, None]
        dx = (xs - cx) / m
        dy = (sy - cy) / m
        r2 = dx * dx + dy * dy
        f = k[0] + r2 * (k[1] + r2 * (k[2] + r2 * k[3]))
        dxt = k[4] * (2 * dx * dy) + k[5] * (r2 + 2 * dx * dx)
        dyt = k[5] * (2 * dx * dy) + k[4] * (r2 + 2 * dy * dy)
        xp = cx + m * (f * dx + dxt)
        yp = cy + m * (f * dy + dyt)
        out_x = np.clip(xs + (xp - xs) * scale, 0, width - 1)
        out_y = np.clip(sy + (yp - sy) * scale, 0, height - 1)
        fdy = np.floor(out_y) - sy
        fdx = np.floor(out_x) - xs
        dy_lo = fdy.min() if dy_lo is None else min(dy_lo, fdy.min())
        dy_hi = fdy.max() if dy_hi is None else max(dy_hi, fdy.max())
        dx_lo = fdx.min() if dx_lo is None else min(dx_lo, fdx.min())
        dx_hi = fdx.max() if dx_hi is None else max(dx_hi, fdx.max())
    return (int(dy_lo), int(dy_hi)), (int(dx_lo), int(dx_hi))


def displacement_bounds(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    margin: int = 1,
    cap: int = 17,
    row_range: Optional[Tuple[int, int]] = None,
    col_range: Optional[Tuple[int, int]] = None,
):
    """Floor-index displacement bounds of the rectilinear map over every output
    pixel of the rectangle (the whole frame by default), widened by
    ``margin`` for the float32-against-float64 floor crossing. Returns
    ((dy_lo, dy_hi), (dx_lo, dx_hi)), or None when either range exceeds
    ``2 * cap``."""
    (fy_lo, fy_hi), (fx_lo, fx_hi) = _floor_disp_minmax(
        coeffs,
        width,
        height,
        cam_center_norm,
        scale,
        (0, height) if row_range is None else row_range,
        (0, width) if col_range is None else col_range,
    )
    dyb = (fy_lo - margin, fy_hi + margin)
    dxb = (fx_lo - margin, fx_hi + margin)
    if max(dyb[1] - dyb[0], dxb[1] - dxb[0]) > 2 * cap:
        return None
    return dyb, dxb


def warp_image_rectilinear(
    image: Tensor,
    coefficients,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    interpolation: str = "lanczos4",
) -> Tensor:
    """All channels of an (H, W, C) image in ONE remap kernel launch, in the
    (H, W, C) layout.

    With identical per-plane coefficients (the usual DNG warp) one (H, W)
    table is shared by every channel, so the kernel reads it and computes its
    weights once per pixel; otherwise each channel has its own table. The
    displacement bounds of every distinct coefficient set are united; when
    one is unavailable (a warp beyond the bounds' cap) the remap is the plain
    gather, which is what the bounded remap equals wherever its bounds hold.
    """
    if image.ndim != 3:
        raise ValueError(f"image must be (H, W, C), got {tuple(image.shape)}")
    h, w, c = image.shape
    coeffs = [tuple(float(v) for v in co) for co in coefficients]
    if len(coeffs) != c:
        raise ValueError(f"{len(coeffs)} coefficient sets for {c} channels")
    unique = list(dict.fromkeys(coeffs))
    with span("warp.maps", device=image.device, cpu=False):
        bounds = [displacement_bounds(co, w, h, cam_center_norm, scale) for co in unique]
        if any(b is None for b in bounds):
            dims = None
        else:
            dims = ((min(b[0][0] for b in bounds), max(b[0][1] for b in bounds)),
                    (min(b[1][0] for b in bounds), max(b[1][1] for b in bounds)))

        tables = [compute_remapping_table(co, w, h, cam_center_norm, scale, image.device)
                  for co in (unique if len(unique) == 1 else coeffs)]
        mx = torch.stack([t[0].clamp(0, w - 1) for t in tables])
        my = torch.stack([t[1].clamp(0, h - 1) for t in tables])
        if len(tables) == 1:
            mx, my = mx[0], my[0]
    with span("warp.remap", device=image.device, cpu=False):
        return remap_kernel(image, mx, my, interpolation, bounds=dims, channels_last=True)


def warp_channel_rectilinear(
    channel: Tensor,
    coeffs,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    prior: Optional[Tuple[Tensor, Tensor]] = None,
    interpolation: str = "lanczos4",
    bounds=None,
) -> Tensor:
    """Table and resample for one channel. Coordinates are clipped into the
    image, as the reference clips them before cv2.remap. Without a prior the
    warp's own displacement bounds are used (``bounds`` supplies them for a
    prior-composed table); with none, the remap is the plain gather. The
    remap kernel runs on a CUDA tensor, its plain version on a CPU tensor."""
    h, w = channel.shape[-2], channel.shape[-1]
    with span("warp.maps", device=channel.device, cpu=False):
        if prior is None:
            map_x, map_y = compute_remapping_table(
                coeffs, w, h, cam_center_norm, scale, channel.device
            )
            if bounds is None:
                bounds = displacement_bounds(coeffs, w, h, cam_center_norm, scale)
        else:
            map_x, map_y = compute_offset_remapping_table(
                prior[0], prior[1], coeffs, w, h, cam_center_norm, scale
            )
        map_x = map_x.clamp(0, w - 1)
        map_y = map_y.clamp(0, h - 1)
    with span("warp.remap", device=channel.device, cpu=False):
        return remap_kernel(channel, map_x, map_y, interpolation, bounds=bounds)
