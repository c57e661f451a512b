"""Photosite-phase channel resampling shared by the demosaics.

Counterpart of the part of ``pysp_tpu/demosaic/eag.py`` that AHD uses
(``resample_channel`` and ``_phase_upsample``). The Fast ("EAG") demosaic
itself is not ported yet (ROADMAP.md queue A, item A1).
"""
from __future__ import annotations

import torch

from ..core.bayer import rgbg_to_bayer
from ..ops.phase_kernels import BayerPatternPosition, get_rgbg_kernel
from ..ops.stencil import filter2d

Tensor = torch.Tensor


def _phase_upsample(plane: Tensor, position: BayerPatternPosition) -> Tensor:
    """Upsample a quarter-res plane to full res with the 4 phase kernels."""
    k_tl, k_tr, k_bl, k_br = get_rgbg_kernel(position)
    return rgbg_to_bayer(
        filter2d(plane, k_tl),
        filter2d(plane, k_tr),
        filter2d(plane, k_br),
        filter2d(plane, k_bl),
    )


def resample_channel(
    subpixel: Tensor,
    g_at_subpixel: Tensor,
    g_hf_pass: Tensor,
    position: BayerPatternPosition,
) -> Tensor:
    """Full-res channel from quarter-res samples via G-difference upsampling,
    in the reduced form ``up(sub) + hf`` (the green term cancels because the
    photosite-phase correlation is linear), as in the JAX package."""
    del g_at_subpixel  # cancels by linearity
    return _phase_upsample(subpixel, position) + g_hf_pass
