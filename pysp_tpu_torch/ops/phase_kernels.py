"""Photosite-phase low-pass kernels for plane-centered Bayer upsampling.

Reference behavior: /root/reference/debayer/gaussian.py:6-54. A 5x5 binomial kernel is
split into four per-phase sub-kernels (one per Bayer quad position) so that upsampling a
quarter-res plane to full resolution keeps each phase centered on its photosite. The
kernels are tiny host-side constants; the device work is four 3x3 cross-correlations.
"""
from __future__ import annotations

from enum import IntEnum
from functools import lru_cache
from typing import Tuple

import numpy as np

# cv2.pyrUp's unnormalized 5x5 binomial (gaussian.py:6-10)
BINOMIAL5 = np.array(
    [
        [1, 4, 6, 4, 1],
        [4, 16, 24, 16, 4],
        [6, 24, 36, 24, 6],
        [4, 16, 24, 16, 4],
        [1, 4, 6, 4, 1],
    ],
    dtype=np.float64,
)
DEFAULT_KERNEL_SIGMA = 1.0


class BayerPatternPosition(IntEnum):
    TOP_LEFT = 0
    TOP_RIGHT = 1
    BOTTOM_LEFT = 2
    BOTTOM_RIGHT = 3


@lru_cache(maxsize=None)
def get_rgbg_kernel(
    base_position: BayerPatternPosition,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extract the 4 per-photosite kernels for a plane at ``base_position``.

    Returns kernels ordered [TopLeft, TopRight, BottomLeft, BottomRight], each 3x3,
    normalized by sum (gaussian.py:19-54).
    """
    kernel = BINOMIAL5
    is_base_left = base_position in (
        BayerPatternPosition.TOP_LEFT,
        BayerPatternPosition.BOTTOM_LEFT,
    )
    is_base_bottom = base_position in (
        BayerPatternPosition.BOTTOM_LEFT,
        BayerPatternPosition.BOTTOM_RIGHT,
    )

    out = []
    for idx in range(4):
        target = BayerPatternPosition(idx)
        is_left = target in (
            BayerPatternPosition.TOP_LEFT,
            BayerPatternPosition.BOTTOM_LEFT,
        )
        is_bottom = target in (
            BayerPatternPosition.BOTTOM_LEFT,
            BayerPatternPosition.BOTTOM_RIGHT,
        )

        k = kernel[0::2] if is_base_bottom == is_bottom else kernel[1::2]
        k = k[:, 0::2] if is_base_left == is_left else k[:, 1::2]
        if is_left != is_base_left:
            zeros_col = np.zeros((k.shape[0], 1))
            k = np.hstack([k, zeros_col]) if is_left else np.hstack([zeros_col, k])
        if is_bottom != is_base_bottom:
            zeros_row = np.zeros((1, k.shape[1]))
            k = np.vstack([zeros_row, k]) if is_bottom else np.vstack([k, zeros_row])

        out.append((k / k.sum()).astype(np.float32))

    return out[0], out[1], out[2], out[3]
