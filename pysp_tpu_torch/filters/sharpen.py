"""Sharpening: unsharp mask and Richardson-Lucy (RL) deconvolution.

Counterpart of ``pysp_tpu/filters/sharpen.py``: per-channel and Oklab-L
unsharp masks, and RL with a symmetric Gaussian PSF on an image, on Oklab L
and on linear luma (YUV).

``gaussian_rt_deconvolution`` on a float32 image runs the RL kernel
(``ops.cuda_kernels.rl_kernel``, one launch per iteration over every channel)
for every frame the kernel takes: PSF reach at most 32 px and H, W at least
twice the reach, the JAX package's gate for its Pallas kernel. Other frames
run the plain loop, as the JAX package runs its XLA loop there. On a CPU
tensor the kernel's wrapper runs the same plain loop.
"""
from __future__ import annotations

import torch

from ..colorimetry.transforms import lin_srgb_to_oklab, oklab_to_lin_srgb
from ..ops.cuda_kernels import rl_kernel, rl_kernel_admits, rl_plain
from .blur import blur_gaussian, get_1d_gaussian_filter

Tensor = torch.Tensor


def unsharp_mask_per_channel(image: Tensor, radius: float, amount: float) -> Tensor:
    """Naive per-channel unsharp. Unclipped output."""
    high_pass = image - blur_gaussian(image, radius)
    return image + high_pass * amount


def unsharp_mask_lab(lin_srgb: Tensor, radius: float, amount: float) -> Tensor:
    """Oklab-L-only unsharp, to avoid colour fringing."""
    lab = lin_srgb_to_oklab(lin_srgb)
    sharpened_l = unsharp_mask_per_channel(lab[..., 0], radius, amount)
    lab = torch.cat([sharpened_l[..., None], lab[..., 1:]], dim=-1)
    return oklab_to_lin_srgb(lab)


def gaussian_rt_deconvolution(
    image: Tensor, sigma: float, iterations: int = 20
) -> Tensor:
    """Richardson-Lucy with a symmetric Gaussian PSF on an (H, W) or (H, W, C)
    image: ``est <- est * blur(image / (blur(est) + 1e-25))``, starting from
    the image. Through the RL kernel inside its gate (module docstring), which
    launches or raises on a CUDA tensor; the plain loop outside the gate."""
    taps = get_1d_gaussian_filter(float(sigma))
    if image.dtype == torch.float32 and rl_kernel_admits(tuple(image.shape), taps):
        return rl_kernel(image, taps, iterations)
    return rl_plain(image, taps, iterations)


def gaussian_rt_deconvolution_lab(
    lin_srgb: Tensor, radius: float, iterations: int = 20
) -> Tensor:
    """RL on the Oklab L channel only."""
    lab = lin_srgb_to_oklab(lin_srgb)
    l_sharp = gaussian_rt_deconvolution(lab[..., 0].contiguous(), radius, iterations)
    lab = torch.cat([l_sharp[..., None], lab[..., 1:]], dim=-1)
    return oklab_to_lin_srgb(lab)


def gaussian_rt_deconvolution_yuv(
    lin_srgb: Tensor, radius: float, iterations: int = 20
) -> Tensor:
    """RL on linear luma, the per-pixel gain applied to RGB."""
    y = (
        0.299 * lin_srgb[..., 0]
        + 0.587 * lin_srgb[..., 1]
        + 0.114 * lin_srgb[..., 2]
    )
    y_mod = gaussian_rt_deconvolution(y, radius, iterations)
    scale = y_mod / y
    return lin_srgb * scale[..., None]
