"""The yardstick of the remap kernel (B4) in the lens-corrected chain: the
least time of one item's remap work on one NVIDIA H100 (``roofline.py``'s
peaks), fixed here so that the count reads the same work whatever
implements it.

An item of mf102.lens launches the remap five times on an (H, W) frame:
four bilinear launches in the CA removal (G onto the R grid and R back, G
onto the B grid and B back), each one (H, W) float32 plane with its own two
(H, W) float32 maps, and one Lanczos4 launch in the warp, the (H, W, 3)
float32 image with two shared (H, W) maps.

- Operations: ``roofline.FloatOpCount`` on the plain reference's remaps
  (``reference/lens.py``: ``remap_bilinear`` of one plane, ``remap_lanczos4``
  of three planes), per output pixel; ``isp_bench/tests`` recounts them.
- Bytes: each launch's planes read once, its maps read once and its output
  written once: a CA launch 4 + 8 + 4 = 16 B a pixel, the warp 12 + 8 + 12 =
  32 B a pixel.

Each launch's least time is the larger of its two bounds, and an item's the
sum over its launches.
"""
from __future__ import annotations

import re

from isp_bench.roofline import least_s

# float32 operations a pixel, as FloatOpCount counts the frozen reference
BILINEAR_OPS_PER_PX = 16       # one plane
LANCZOS4_OPS_PER_PX = 738      # three planes with shared maps
CA_LAUNCHES = 4
CA_BYTES_PER_PX = 4 + 8 + 4
WARP_BYTES_PER_PX = 12 + 8 + 12

# the remap kernel's two kinds in a device trace (``csrc/remap.cu``), by the
# short names of ``devtrace.short_name``
KERNEL = re.compile(r"(?:^|::)(?:bilinear|lanczos4)_kernel(?:<|$)")


def item_least_s(pixels: int) -> float:
    """The least time of one item's remap work on an ``pixels`` frame."""
    ca = least_s(BILINEAR_OPS_PER_PX * pixels, CA_BYTES_PER_PX * pixels)
    warp = least_s(LANCZOS4_OPS_PER_PX * pixels, WARP_BYTES_PER_PX * pixels)
    return CA_LAUNCHES * ca + warp


def is_remap_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None
