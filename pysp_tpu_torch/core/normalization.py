"""Sensor-range normalization (black-level subtract, saturation clip, scale to [0,1]).

Counterpart of ``pysp_tpu/core/normalization.py``: one elementwise pass over
the plane stack, on the mosaic's device. The loader normalizes on the host
(``io/raw_loader._normalize_host``, the same arithmetic).
"""
from __future__ import annotations

import torch

from .bayer import bayer_to_planes, planes_to_bayer

Tensor = torch.Tensor


def bayer_normalize(bayer, chan_black, chan_sat) -> Tensor:
    """Normalize an RGGB mosaic (..., H, W) from sensor counts to [0,1] float32.

    ``chan_black`` / ``chan_sat`` are length-4 per-plane levels in (R, G1, B, G2)
    order. Saturation is the clip ceiling applied after the black subtraction
    and the scale divisor: ``clip(x - black, 0, sat) / sat``.
    """
    bayer = torch.as_tensor(bayer)
    planes = bayer_to_planes(bayer.to(torch.float32))
    black = torch.as_tensor(chan_black, dtype=torch.float32, device=bayer.device).reshape(4, 1, 1)
    sat = torch.as_tensor(chan_sat, dtype=torch.float32, device=bayer.device).reshape(4, 1, 1)
    planes = torch.minimum(torch.clamp(planes - black, min=0.0), sat) / sat
    return planes_to_bayer(planes)
