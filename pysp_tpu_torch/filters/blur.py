"""Separable Gaussian blur with auto-sized windows.

Counterpart of ``pysp_tpu/filters/blur.py``: window = ceil(6 sigma), odd,
at least 3; the 1-D bell ``exp(-x^2 / 2 s^2) / (sqrt(2 pi) s)`` is NOT
normalized by its sum, as in the reference; two 1-D passes (H then V) with a
symmetric (cv2.BORDER_REFLECT) border. Plain PyTorch: no kernel computes it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.stencil import filter2d_hwc

Tensor = torch.Tensor


def get_gaussian_filter_window_size(sigma: float, cutoff: int = 3) -> int:
    """Odd window size covering ``cutoff`` standard deviations."""
    if sigma < 0:
        raise ValueError("Filter cannot be computed with negative sigma!")
    radius = sigma * cutoff
    diameter = math.ceil(radius * 2)
    if diameter % 2 == 0:
        diameter += 1
    return max(3, int(diameter))


def get_1d_gaussian_filter(sigma: float) -> np.ndarray:
    """1D Gaussian bell, unnormalized by its sum like the reference."""
    try:
        radius = get_gaussian_filter_window_size(sigma) // 2
    except ValueError:
        return np.array([1.0], dtype=np.float32)

    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    denom = 1.0 / (np.sqrt(2 * np.pi) * sigma)
    return (denom * np.exp(-(xs**2) / (2 * sigma**2))).astype(np.float32)


def blur_taps(image: Tensor, taps: np.ndarray) -> Tensor:
    """The separable blur by the 1-D ``taps``: H pass, then V pass, each with
    the symmetric border and taps ascending."""
    h_pass = filter2d_hwc(image, taps.reshape(1, -1), border="reflect")
    return filter2d_hwc(h_pass, taps.reshape(-1, 1), border="reflect")


def blur_gaussian(image: Tensor, sigma: float) -> Tensor:
    """Separable Gaussian blur of an (H, W) or (H, W, C) image, symmetric
    border. Like the reference, the kernel is NOT normalized by its sum: the
    overall gain is sum(filter)^2 (about 1 for reasonable sigma)."""
    return blur_taps(image, get_1d_gaussian_filter(float(sigma)))
