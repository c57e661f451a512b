"""DNG OpcodeList1/2 gain operators: GainMap (9) and FixVignetteRadial (3).

Counterpart of ``pysp_tpu/warp/gain_opcodes.py``: per-CFA-plane shading grids
(GainMap) and radial vignette polynomials (FixVignetteRadial) that phones,
drones and mirrorless bodies embed in OpcodeList2. The decoders, encoders and
the gain map's bilinear grid are the JAX module's host code; the gains are
applied on the mosaic's device. The DNG structures follow DNG 1.4 section
"Opcode Lists".

Coordinate conventions (the JAX module's):
- GainMap: a pixel (row, col) of the full image maps to normalized coordinates
  (row/H, col/W); grid sample index = (norm - MapOrigin) / MapSpacing, clamped to
  the grid edges, bilinearly interpolated.
- FixVignetteRadial: gain = 1 + k0 r^2 + k1 r^4 + k2 r^6 + k3 r^8 + k4 r^10 with
  r the distance from the optical center (cv, cw in normalized [0,1] coords)
  normalized by the maximum corner distance.
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..colorimetry.transforms import div_const
from .opcodes import iter_opcodes

Tensor = torch.Tensor

OPCODE_FIX_VIGNETTE_RADIAL = 3
OPCODE_GAIN_MAP = 9


class GainMap(NamedTuple):
    top: int
    left: int
    bottom: int
    right: int
    plane: int
    planes: int
    row_pitch: int
    col_pitch: int
    points_v: int
    points_h: int
    spacing_v: float
    spacing_h: float
    origin_v: float
    origin_h: float
    map_planes: int
    gains: np.ndarray  # (points_v, points_h, map_planes) f32


class VignetteRadial(NamedTuple):
    k: Tuple[float, float, float, float, float]
    center_v: float
    center_h: float


def decode_gain_map(data: bytes) -> Optional[GainMap]:
    """Decode one GainMap operator body (DNG 1.4 opcode 9); None if malformed."""
    if len(data) < 76:
        return None
    head = struct.unpack(">8L2L4dL", data[:76])
    (top, left, bottom, right, plane, planes, row_pitch, col_pitch,
     pts_v, pts_h, sp_v, sp_h, or_v, or_h, map_planes) = head
    n = pts_v * pts_h * map_planes
    if len(data) != 76 + 4 * n or n == 0:
        return None
    gains = np.frombuffer(data[76:], dtype=">f4").astype(np.float32)
    return GainMap(
        top, left, bottom, right, plane, planes, row_pitch, col_pitch,
        pts_v, pts_h, float(sp_v), float(sp_h), float(or_v), float(or_h),
        map_planes, gains.reshape(pts_v, pts_h, map_planes),
    )


def encode_gain_map(gm: GainMap) -> bytes:
    body = struct.pack(
        ">8L2L4dL",
        gm.top, gm.left, gm.bottom, gm.right, gm.plane, gm.planes,
        gm.row_pitch, gm.col_pitch, gm.points_v, gm.points_h,
        gm.spacing_v, gm.spacing_h, gm.origin_v, gm.origin_h, gm.map_planes,
    )
    body += np.asarray(gm.gains, ">f4").tobytes()
    return body


def decode_vignette_radial(data: bytes) -> Optional[VignetteRadial]:
    """Decode one FixVignetteRadial operator body (DNG 1.3 opcode 3)."""
    if len(data) != 7 * 8:
        return None
    vals = struct.unpack(">7d", data)
    return VignetteRadial(tuple(vals[:5]), vals[5], vals[6])


def encode_vignette_radial(v: VignetteRadial) -> bytes:
    return struct.pack(">7d", *v.k, v.center_v, v.center_h)


def encode_opcode_list(ops: List[Tuple[int, bytes]], version: int = 0x01040000) -> bytes:
    """Assemble (opcode_id, body) pairs into an OpcodeList block (test fixtures)."""
    block = struct.pack(">L", len(ops))
    for opcode_id, body in ops:
        block += struct.pack(">LLLL", opcode_id, version, 0, len(body)) + body
    return block


def _apply_gain_map(bayer: Tensor, gm: GainMap) -> Tensor:
    """Multiply the opcode's strided area by the bilinearly-sampled gain grid,
    in place (a slice with a positive step is a view of ``bayer``)."""
    h, w = bayer.shape[-2], bayer.shape[-1]
    bottom = min(gm.bottom, h)
    right = min(gm.right, w)
    if gm.top >= bottom or gm.left >= right:
        return bayer

    rows = np.arange(gm.top, bottom, gm.row_pitch)
    cols = np.arange(gm.left, right, gm.col_pitch)
    # normalized image coordinates -> fractional grid indices, edge-clamped
    gy = np.clip((rows / h - gm.origin_v) / max(gm.spacing_v, 1e-12), 0, gm.points_v - 1)
    gx = np.clip((cols / w - gm.origin_h) / max(gm.spacing_h, 1e-12), 0, gm.points_h - 1)

    y0 = np.floor(gy).astype(np.int32)
    x0 = np.floor(gx).astype(np.int32)
    fy = (gy - y0).astype(np.float32)[:, None]
    fx = (gx - x0).astype(np.float32)[None, :]
    y1 = np.minimum(y0 + 1, gm.points_v - 1)
    x1 = np.minimum(x0 + 1, gm.points_h - 1)

    # CFA gain maps carry one map plane; multi-plane maps use plane 0 for Bayer data
    g = np.asarray(gm.gains[..., 0], np.float32)
    grid = (
        g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + g[np.ix_(y0, x1)] * (1 - fy) * fx
        + g[np.ix_(y1, x0)] * fy * (1 - fx)
        + g[np.ix_(y1, x1)] * fy * fx
    )

    area = bayer[..., gm.top : bottom : gm.row_pitch, gm.left : right : gm.col_pitch]
    area.mul_(torch.from_numpy(np.ascontiguousarray(grid, np.float32)).to(bayer.device))
    return bayer


def _apply_vignette_radial(bayer: Tensor, v: VignetteRadial) -> Tensor:
    h, w = bayer.shape[-2], bayer.shape[-1]
    cy = v.center_v * (h - 1)
    cx = v.center_h * (w - 1)
    max_r2 = max(
        (0 - cy) ** 2 + (0 - cx) ** 2,
        (0 - cy) ** 2 + (w - 1 - cx) ** 2,
        (h - 1 - cy) ** 2 + (0 - cx) ** 2,
        (h - 1 - cy) ** 2 + (w - 1 - cx) ** 2,
    )
    dev = bayer.device
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :]
    r2 = div_const(yy * yy + xx * xx, max_r2)
    k0, k1, k2, k3, k4 = (torch.tensor(np.float32(k), device=dev) for k in v.k)
    gain = 1.0 + r2 * (k0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4))))
    return bayer * gain


def apply_gain_opcodes(bayer: Tensor, opcode_block: bytes) -> Tensor:
    """Apply every GainMap / FixVignetteRadial in an OpcodeList block to a
    mosaic (..., H, W) on its device; a NumPy mosaic goes to the CPU.

    Unknown opcodes are skipped (the contract of ``apply_opcode_3_warp``).
    Returns a new tensor; ``bayer`` is not changed."""
    bayer = torch.as_tensor(bayer, dtype=torch.float32).clone()
    for opcode_id, _ver, _flags, data in iter_opcodes(opcode_block):
        if opcode_id == OPCODE_GAIN_MAP:
            gm = decode_gain_map(data)
            if gm is not None:
                bayer = _apply_gain_map(bayer, gm)
        elif opcode_id == OPCODE_FIX_VIGNETTE_RADIAL:
            vr = decode_vignette_radial(data)
            if vr is not None:
                bayer = _apply_vignette_radial(bayer, vr)
    return bayer
