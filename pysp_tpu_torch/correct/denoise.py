"""Bayer-domain noise reduction: an a-trous B3-spline wavelet shrinkage on the
four CFA phase planes.

Counterpart of ``pysp_tpu/correct/denoise.py``. Per plane:

    smooth_{l+1} = B3 * smooth_l with taps dilated 2^l   ([1, 4, 6, 4, 1] / 16)
    detail_l     = smooth_l - smooth_{l+1}
    detail_l    <- d * max(0, 1 - t_l^2 / d^2)           (non-negative garrote)
    result       = smooth_L + sum_l detail_l

with a symmetric (cv2.BORDER_REFLECT) border. The noise scale comes from the
finest band, sigma = E|d_0| * sqrt(pi / 2), and the thresholds follow the B3
a-trous noise decay per level. The JAX function's ``axis_name`` /
``core_rows`` exist only for spatial sharding and are left out here
(ROADMAP.md item 16).
"""
from __future__ import annotations

import math

import torch

from ..colorimetry.transforms import div_const
from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import RawFrame
from ..ops.stencil import pad_reflect, shift2d

Tensor = torch.Tensor

# relative noise std of each a-trous detail level (B3 spline, unit input noise)
_LEVEL_SIGMA = (0.8907, 0.2007, 0.0855, 0.0412, 0.0202)
_B3 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _b3_smooth(x: Tensor, dilation: int) -> Tensor:
    """Separable dilated B3-spline smoothing as shifts and adds, taps in order."""

    def pass1(v, axis):
        acc = None
        for k, wk in enumerate(_B3):
            off = (k - 2) * dilation
            dy, dx = (off, 0) if axis == 0 else (0, off)
            term = wk * shift2d(v, dy, dx, pad_reflect)
            acc = term if acc is None else acc + term
        return acc

    return pass1(pass1(x, 0), 1)


def _denoise_plane(plane: Tensor, strength: float, levels: int) -> Tensor:
    smooth = plane
    details = []
    for lvl in range(levels):
        nxt = _b3_smooth(smooth, 1 << lvl)
        details.append(smooth - nxt)
        smooth = nxt

    sigma = torch.abs(details[0]).mean() * math.sqrt(math.pi / 2.0)
    sigma = div_const(sigma, _LEVEL_SIGMA[0])

    out = smooth
    for lvl, d in enumerate(details):
        t = (1.5 * strength) * sigma * _LEVEL_SIGMA[min(lvl, len(_LEVEL_SIGMA) - 1)]
        out = out + d * torch.clamp(1.0 - (t * t) / torch.clamp(d * d, min=1e-20), min=0.0)
    return out


def denoise_bayer_wavelet(frame: RawFrame, strength: float = 1.0, levels: int = 3) -> RawFrame:
    """Edge-preserving Bayer-domain noise reduction on the CFA phase planes.

    ``strength`` scales the shrinkage thresholds (0 disables; about 1 targets
    the estimated noise floor); ``levels`` is the number of a-trous scales.
    The JAX function's ``axis_name`` / ``core_rows`` (spatial sharding,
    ROADMAP.md item 16) are left out."""
    if strength <= 0.0 or levels <= 0:
        return frame
    planes = [_denoise_plane(p, float(strength), int(levels)) for p in bayer_to_rgbg(frame.bayer)]
    out = rgbg_to_bayer(*planes)
    return frame.replace(bayer=torch.clamp(out, min=0.0).to(frame.bayer.dtype))
