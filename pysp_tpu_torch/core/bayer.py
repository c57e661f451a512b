"""Bayer plane (de)swizzling and pattern canonicalization.

Counterpart of ``pysp_tpu/core/bayer.py``. Plane order matches the reference:
(R, G1, B, G2) where G1 is the top-right green and G2 the bottom-left green of an
RGGB quad.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..const import BayerPattern

Tensor = torch.Tensor


def bayer_to_rgbg(bayer: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Deinterleave an RGGB mosaic (..., H, W) into quarter-res planes (R, G1, B, G2).

    The planes are strided views of ``bayer``."""
    evens = bayer[..., 0::2, :]
    odds = bayer[..., 1::2, :]
    r = evens[..., :, 0::2]
    g1 = evens[..., :, 1::2]
    g2 = odds[..., :, 0::2]
    b = odds[..., :, 1::2]
    return r, g1, b, g2


def rgbg_to_bayer(r: Tensor, g1: Tensor, b: Tensor, g2: Tensor) -> Tensor:
    """Re-interleave quarter-res planes into an RGGB mosaic."""
    h2, w2 = r.shape[-2], r.shape[-1]
    lead = r.shape[:-2]
    even_rows = torch.stack([r, g1], dim=-1).reshape(*lead, h2, w2 * 2)
    odd_rows = torch.stack([g2, b], dim=-1).reshape(*lead, h2, w2 * 2)
    return torch.stack([even_rows, odd_rows], dim=-2).reshape(*lead, h2 * 2, w2 * 2)


def bayer_to_planes(bayer: Tensor) -> Tensor:
    """Mosaic (..., H, W) -> contiguous planes (..., 4, H/2, W/2) in (R, G1, B, G2) order."""
    return torch.stack(bayer_to_rgbg(bayer), dim=-3)


def planes_to_bayer(planes: Tensor) -> Tensor:
    """Planes (..., 4, H/2, W/2) -> mosaic (..., H, W)."""
    return rgbg_to_bayer(*planes.unbind(dim=-3))


def reversible_transform_rggb(sensor: Tensor, pattern: BayerPattern | int) -> Tensor:
    """Rotate/flip a mosaic so its CFA reads RGGB; applying twice round-trips.

    Same transforms as the JAX package: BGGR is a 180 degree rotation, GBRG a
    vertical flip, GRBG a horizontal flip. Works on (H, W) mosaics and (H, W, C)
    demosaiced images alike.
    """
    pattern = BayerPattern(pattern)
    if pattern == BayerPattern.Rggb:
        return sensor
    if pattern == BayerPattern.Bggr:
        return torch.rot90(sensor, k=2, dims=(0, 1))
    if pattern == BayerPattern.Gbrg:
        return torch.flip(sensor, dims=(0,))
    if pattern == BayerPattern.Grbg:
        return torch.flip(sensor, dims=(1,))
    raise NotImplementedError(f"{pattern} not implemented!")
