"""Core enums shared across the framework.

Mirrors the reference's quality/pattern vocabulary (`/root/reference/const.py:3-8`,
`/root/reference/base_types/image_base.py:13-17`) but as plain IntEnums so they are
hashable and usable as static jit arguments.
"""
from __future__ import annotations

from enum import IntEnum


class QualityDemosaic(IntEnum):
    """Demosaic quality tier (reference: const.py:3-6)."""

    Draft = 1  # quarter-res resolve + bilinear upsample
    Fast = 2   # edge-assisted Gaussian
    Best = 3   # AHD (adaptive homogeneity-directed)


class BayerPattern(IntEnum):
    """2x2 CFA layout (reference: base_types/image_base.py:13-17)."""

    Rggb = 1
    Bggr = 2
    Grbg = 3
    Gbrg = 4


class PatternDemosaic(IntEnum):
    """Supported CFA family (reference: const.py:8)."""

    Rgbg = 1
