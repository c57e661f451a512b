"""Synthetic-scene and fidelity helpers (NumPy, host only).

Copied from ``pysp_tpu/utils/testing.py`` (the functions the port's smoke run
and tests use, ``ring_chart`` the CA scene among them), so that they import
without JAX, plus the test cases of the heal and postprocess kernels, which the smoke run, ``tools/time_kernels.py``
and the tests share.
"""
from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays."""
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float(np.inf)
    return float(10 * np.log10(peak**2 / mse))


def make_scene(h: int = 64, w: int = 80, seed: int = 0) -> np.ndarray:
    """Synthetic RGB scene: smooth gradients + edges + texture + mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.3 + 0.4 * np.sin(xx / 9) * np.cos(yy / 13) + 0.2 * (xx > w / 2)
    g = 0.4 + 0.3 * np.cos(xx / 7) + 0.15 * (yy > h / 3)
    b = 0.5 - 0.3 * np.sin(yy / 11) + 0.1 * ((xx + yy) % 17 > 8)
    rgb = np.clip(np.dstack([r, g, b]) + rng.normal(0, 0.01, (h, w, 3)), 0.02, 0.98)
    return rgb.astype(np.float32)


def mosaic_rggb(rgb: np.ndarray) -> np.ndarray:
    """Sample an RGB image through an RGGB CFA."""
    h, w, _ = rgb.shape
    bayer = np.zeros((h, w), np.float32)
    bayer[0::2, 0::2] = rgb[0::2, 0::2, 0]
    bayer[0::2, 1::2] = rgb[0::2, 1::2, 1]
    bayer[1::2, 0::2] = rgb[1::2, 0::2, 1]
    bayer[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return bayer


def ring_chart(
    h: int = 256, w: int = 256, radii=(60, 90, 110), amp: float = 0.5,
    sigma: float = 2.0, base: float = 0.2,
) -> np.ndarray:
    """Concentric rings: tangential edges perpendicular to the radius — the content
    the blind CA fit needs."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r = np.hypot(yy - cy, xx - cx)
    img = np.full((h, w), base, np.float32)
    for rad in radii:
        img += amp * np.exp(-0.5 * ((r - rad) / sigma) ** 2)
    return img.astype(np.float32)


def heal_case(h2: int, w2: int, density: float, seed: int):
    """CFA planes (4, h2, w2) float32 of a structured scene and a bool mask for
    the heal: random sites at ``density``, every plane corner and, where the
    planes hold them, a 3x3 cluster, a 13x13 blob that four fill sweeps cannot
    reach (it seeds from the plane mean) and blobs across tile corners."""
    rng = np.random.default_rng(seed)
    planes = make_scene(h2, w2, seed=seed)[..., [0, 1, 2, 1]].transpose(2, 0, 1).copy()
    mask = rng.random((4, h2, w2)) < density
    for y, x in ((0, 0), (0, w2 - 1), (h2 - 1, 0), (h2 - 1, w2 - 1)):
        mask[:, y, x] = True
    if h2 >= 40 and w2 >= 40:
        mask[0, 10:13, 20:23] = True
        mask[1, 20:33, 5:18] = True
    # Blobs across a corner of the kernel's 32x32 tiles reaching R - 1 sites
    # past it on every side, for R = 6 and 8 sweeps: a fill front enters them
    # at the first sweep just outside a halo one site short of R.
    for p, (ty, tx), r in ((2, (32, 64), 6), (3, (96, 192), 8)):
        if h2 > ty + r and w2 > tx + r:
            mask[p, ty - r + 1 : ty + r - 1, tx - r + 1 : tx + r - 1] = True
    return planes, mask


HEAL_TILE_KINDS = ("no_site", "every_tile", "tile_corners")


def heal_tile_case(h2: int, w2: int, kind: str, seed: int):
    """CFA planes (4, h2, w2) float32 of a structured scene and a bool mask
    that walks the heal kernel's tiling (16x16 sweep sub-tiles in 32x64 copy
    tiles): ``no_site``, an empty mask; ``every_tile``, one site in every
    16x16 sub-tile, at a place that moves from sub-tile to sub-tile; and
    ``tile_corners``, sites on every sub-tile corner and 1, 5 and 7 sites
    (R - 1 for R = 2, 6 and 8 sweeps) before and past it on both axes."""
    planes = make_scene(h2, w2, seed=seed)[..., [0, 1, 2, 1]].transpose(2, 0, 1).copy()
    mask = np.zeros((4, h2, w2), bool)
    if kind == "every_tile":
        for p in range(4):
            for k, ty in enumerate(range(0, h2, 16)):
                for j, tx in enumerate(range(0, w2, 16)):
                    y = min(ty + (5 * k + 3 * j + p) % 16, h2 - 1)
                    x = min(tx + (7 * j + 2 * k + p) % 16, w2 - 1)
                    mask[p, y, x] = True
    elif kind == "tile_corners":
        offsets = (-7, -5, -1, 0, 5, 7)
        for ty in range(0, h2 + 1, 16):
            for tx in range(0, w2 + 1, 16):
                for dy in offsets:
                    for dx in offsets:
                        if 0 <= ty + dy < h2 and 0 <= tx + dx < w2:
                            mask[:, ty + dy, tx + dx] = True
    elif kind != "no_site":
        raise ValueError(f"kind must be one of {HEAL_TILE_KINDS}, got {kind!r}")
    return planes, mask


def chroma_case(h: int, w: int, seed: int) -> np.ndarray:
    """r, g, b planes (3, h, w) float32 for the chroma-median stage: a scene
    with noise, so that the medians differ from pixel to pixel up to the
    frame's edge, and every plane corner an outlier, which enters a border
    pixel's window as often as the border rule repeats it."""
    rng = np.random.default_rng(seed)
    rgb = make_scene(h, w, seed=seed) + rng.normal(0, 0.05, (h, w, 3))
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1), np.float32)
    corners = ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1))
    for k, values in enumerate(((1.5, -1.5, -1.0, 1.0), (-0.8, 0.9, 1.2, -1.1),
                                (1.1, 1.3, -0.9, -1.4))):
        for (y, x), v in zip(corners, values):
            planes[k, y, x] = v
    return planes
