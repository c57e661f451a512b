"""AHD homogeneity map as a vectorized 3x3 stencil.

Counterpart of ``pysp_tpu/demosaic/homogeneity.py``, including the one-sided
luminance test (``L_window - L_ref <= eps``, not abs).
"""
from __future__ import annotations

import torch

from ..ops.stencil import pad_reflect

Tensor = torch.Tensor


def homogeneity_map_channels(
    lum: Tensor, a: Tensor, b: Tensor, is_vertical: bool, domain_k: int = 3
) -> Tensor:
    """Count of in-window neighbours within the adaptive (eps_L, eps_C^2) bounds
    of each pixel, on separate L/a/b planes (BORDER_REFLECT). The plain
    version of the homogeneity kernel (``ops.cuda_kernels.homogeneity_kernel``)."""
    if domain_k % 2 != 1:
        raise ValueError("domain_k must be odd")
    k_pad = domain_k // 2

    lum_p = pad_reflect(lum, k_pad)
    a_p = pad_reflect(a, k_pad)
    b_p = pad_reflect(b, k_pad)

    h, w = lum.shape[-2], lum.shape[-1]

    def window(arr_p: Tensor, dy: int, dx: int) -> Tensor:
        return arr_p[..., k_pad + dy : k_pad + dy + h, k_pad + dx : k_pad + dx + w]

    # Adaptive bounds from the two directional neighbours
    if is_vertical:
        n1 = (window(lum_p, -1, 0), window(a_p, -1, 0), window(b_p, -1, 0))
        n2 = (window(lum_p, 1, 0), window(a_p, 1, 0), window(b_p, 1, 0))
    else:
        n1 = (window(lum_p, 0, -1), window(a_p, 0, -1), window(b_p, 0, -1))
        n2 = (window(lum_p, 0, 1), window(a_p, 0, 1), window(b_p, 0, 1))

    eps_l = torch.maximum(torch.abs(lum - n1[0]), torch.abs(lum - n2[0]))
    eps_c2 = torch.maximum(
        (a - n1[1]) ** 2 + (b - n1[2]) ** 2,
        (a - n2[1]) ** 2 + (b - n2[2]) ** 2,
    )

    # The center and the two eps-defining neighbours pass their own bounds
    # exactly in float32, so they count as a constant 3.
    free = {(0, 0), (-1, 0), (1, 0)} if is_vertical else {(0, 0), (0, -1), (0, 1)}
    count = torch.full_like(lum, 3.0)
    for dy in range(-k_pad, k_pad + 1):
        for dx in range(-k_pad, k_pad + 1):
            if (dy, dx) in free:
                continue
            wl = window(lum_p, dy, dx)
            wa = window(a_p, dy, dx)
            wb = window(b_p, dy, dx)
            ok = ((wl - lum) <= eps_l) & (((wa - a) ** 2 + (wb - b) ** 2) <= eps_c2)
            count = count + ok.to(torch.float32)

    return count


def homogeneity_map(lab: Tensor, is_vertical: bool, domain_k: int = 3) -> Tensor:
    """:func:`homogeneity_map_channels` of an unpadded (H, W, 3) CIELAB image."""
    return homogeneity_map_channels(
        lab[..., 0], lab[..., 1], lab[..., 2], is_vertical, domain_k
    )
