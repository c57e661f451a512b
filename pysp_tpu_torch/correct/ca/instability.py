"""Structural instability: Bayer-domain edge proxy used for blind CA fitting.

Counterpart of ``pysp_tpu/correct/ca/instability.py`` (pySP's
corr_ca/instability.py:7-60). For each photosite phase and each target color,
the instability is max-min over a small set of neighboring same-color
photosites (12 offset tables). Output is an (H, W, 3) map.

Offsets are (x, y) pairs into the WB-applied mosaic padded by 4 (BORDER_REFLECT),
strided by 2 to stay on the phase's color sites. Plain torch on the frame's
device: one pass of strided slices over the mosaic, no kernel.
"""
from __future__ import annotations

import torch

from ...core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ...core.frame import RawFrame
from ...ops.stencil import pad_reflect

Tensor = torch.Tensor

_PAD = 4

# (phase_offset (x, y)) -> offsets per output color; offsets are (x, y)
_OFFSETS = {
    # R photosite (0,0)
    (0, 0): {
        "r": [(0, 0), (0, -2), (0, 2), (-2, 0), (2, 0)],
        "g": [(-1, 0), (1, 0), (0, -1), (0, 1)],
        "b": [(-1, -1), (1, -1), (1, 1), (-1, 1)],
    },
    # G1 photosite (1,0) — top-right green
    (1, 0): {
        "r": [(-1, 0), (-1, -2), (-1, 2), (1, -2), (1, 0), (1, 2)],
        "g": [(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)],
        "b": [(0, -1), (0, 1), (-2, -1), (-2, 1), (2, -1), (2, 1)],
    },
    # G2 photosite (0,1) — bottom-left green
    (0, 1): {
        "r": [(0, -1), (-2, -1), (2, -1), (0, 1), (-2, 1), (2, 1)],
        "g": [(0, 0), (-1, 1), (1, 1), (-1, -1), (1, -1)],
        "b": [(-1, 0), (1, 0), (-1, -2), (1, -2), (-1, 2), (1, 2)],
    },
    # B photosite (1,1)
    (1, 1): {
        "r": [(-1, -1), (1, -1), (-1, 1), (1, 1)],
        "g": [(-1, 0), (1, 0), (0, -1), (0, 1)],
        "b": [(0, 0), (-2, 0), (2, 0), (0, -2), (0, 2)],
    },
}


def _phase_instability(padded: Tensor, phase_xy, offsets, h2: int, w2: int) -> Tensor:
    """max-min over the offset samples for one photosite phase (instability.py:24-43)."""
    px, py = phase_xy
    stack = []
    for ox, oy in offsets:
        xs = ox + _PAD + px
        ys = oy + _PAD + py
        stack.append(padded[ys::2, xs::2][:h2, :w2])
    stacked = torch.stack(stack, dim=0)
    return torch.amax(stacked, dim=0) - torch.amin(stacked, dim=0)


def compute_structural_instability(frame: RawFrame) -> Tensor:
    """(H, W, 3) instability map from the WB-applied mosaic of one frame, on
    the frame's device."""
    wb = frame.wb_reciprocal()
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    mosaic = rgbg_to_bayer(r * wb[0], g1 * wb[1], b * wb[2], g2 * wb[1])
    padded = pad_reflect(mosaic, _PAD)

    h2 = frame.bayer.shape[-2] // 2
    w2 = frame.bayer.shape[-1] // 2

    per_color_planes = {"r": [], "g": [], "b": []}
    for phase in [(0, 0), (1, 0), (0, 1), (1, 1)]:
        for color in ("r", "g", "b"):
            per_color_planes[color].append(
                _phase_instability(padded, phase, _OFFSETS[phase][color], h2, w2)
            )

    out = []
    for color in ("r", "g", "b"):
        p_r, p_g1, p_g2, p_b = per_color_planes[color]
        out.append(rgbg_to_bayer(p_r, p_g1, p_b, p_g2))
    return torch.stack(out, dim=-1)
