"""Conversions between a mosaic and its four CFA phase planes.

Counterpart of ``bayer_to_quad`` and ``quad_to_bayer`` of
``pysp_tpu/ops/polyphase.py``. A "quad" is a tuple of four planes indexed by
(row parity, column parity): ``quad[py][px]`` of shape (H/2, W/2); this differs
from the (R, G1, B, G2) order of ``core.bayer``. The fused Draft and Fast
develops stay on the phase planes and assemble the full-resolution image once
per channel through ``quad_to_bayer``.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
Quad = Tuple[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor]]


def bayer_to_quad(bayer: Tensor) -> Quad:
    """Mosaic (..., H, W) -> phases ``quad[py][px]`` (strided views)."""
    evens = bayer[..., 0::2, :]
    odds = bayer[..., 1::2, :]
    return (
        (evens[..., :, 0::2], evens[..., :, 1::2]),
        (odds[..., :, 0::2], odds[..., :, 1::2]),
    )


def quad_to_bayer(quad: Quad) -> Tensor:
    """Phases ``quad[py][px]`` -> mosaic (..., H, W)."""
    (p00, p01), (p10, p11) = quad
    h2, w2 = p00.shape[-2], p00.shape[-1]
    lead = p00.shape[:-2]
    even = torch.stack([p00, p01], dim=-1).reshape(*lead, h2, w2 * 2)
    odd = torch.stack([p10, p11], dim=-1).reshape(*lead, h2, w2 * 2)
    return torch.stack([even, odd], dim=-2).reshape(*lead, h2 * 2, w2 * 2)


def color_tail_quads(quads, mat: Tensor, clip_highlights: bool, gamma_encode: bool):
    """The develop's colour tail (``colorimetry.transforms.color_tail_channels``)
    on each phase of the (r, g, b) ``quads``, then each channel assembled to
    full resolution: the tail of the fused Draft and Fast develops."""
    from ..colorimetry.transforms import color_tail_channels

    rq, gq, bq = quads
    tailed = [[[None, None], [None, None]] for _ in range(3)]
    for py in (0, 1):
        for px in (0, 1):
            channels = color_tail_channels(
                rq[py][px], gq[py][px], bq[py][px], mat, clip_highlights, gamma_encode
            )
            for k, v in enumerate(channels):
                tailed[k][py][px] = v
    return tuple(quad_to_bayer(tailed[k]) for k in range(3))
