"""Synthetic-scene and fidelity helpers (NumPy, host only).

Copied from ``pysp_tpu/utils/testing.py`` (the functions the port's smoke run
and tests use), so that they import without JAX.
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
