"""Device-side colour transforms on tensors.

Counterpart of the device half of ``pysp_tpu/colorimetry/transforms.py``:
the de-tint row-normalized camera -> destination RGB conversion (linear sRGB,
or XYZ through a Rec. 2020 PCS), the sRGB gamma encode and decode, Oklab and
the cv2-compatible RGB -> CIELAB used by AHD.

Two numerical rules keep the CPU and CUDA results the same as each other:

- a division by a constant divides by a 0-d tensor on the operand's device.
  PyTorch's CUDA division by a Python scalar multiplies by the rounded
  reciprocal instead, which is up to one ulp off the true quotient that the CPU,
  the JAX package and the hand-written kernels compute.
- torch has no ``cbrt``; :func:`cbrt` is ``pow(x, 1/3)`` refined by one Newton
  step (see its docstring).
"""
from __future__ import annotations

import numpy as np
import torch

from .spaces import LinRgbColorspace

Tensor = torch.Tensor

# Base (unadapted, D65-white) RGB->XYZ matrices, computed once on host in float64.
_REC709_TO_XYZ = np.asarray(LinRgbColorspace.REC709.mat_to_xyz(), np.float64)
_REC2020_TO_XYZ = np.asarray(LinRgbColorspace.REC2020.mat_to_xyz(), np.float64)
_D65_XYZ = np.array([0.31272 / 0.32903, 1.0, (1 - 0.31272 - 0.32903) / 0.32903])

_BRADFORD_NP = np.array(
    [
        [0.8951000, 0.2664000, -0.1614000],
        [-0.7502000, 1.7135000, 0.0367000],
        [0.0389000, -0.0685000, 1.0296000],
    ],
    dtype=np.float64,
)
_BRADFORD_INV_NP = np.linalg.inv(_BRADFORD_NP)


# This module's constant matrices, each copied once to each device: a copy
# from pageable host memory waits for the device's queue, which would stall
# the host in every develop.
_ON_DEVICE: dict = {}


def _f32(value, like: Tensor) -> Tensor:
    """The constant ``value`` as float32 on ``like``'s device."""
    a = np.asarray(value, np.float32)
    key = (a.tobytes(), a.shape, like.device)
    t = _ON_DEVICE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _ON_DEVICE[key] = torch.as_tensor(a, device=like.device)
    return t


def div_const(x: Tensor, c: float) -> Tensor:
    """``x / c`` as an IEEE float32 division on every device."""
    return x / torch.full((), float(np.float32(c)), dtype=x.dtype, device=x.device)


def cbrt(x: Tensor) -> Tensor:
    """Cube root of a positive tensor: ``y = x ** (1/3)``, then one Newton step
    ``y + (x / y**2 - y) / 3``.

    Measured on 3M float32 samples over [1e-6, 4]: within 1 ulp of the exact
    cube root (8.7% of values not correctly rounded), against 3 ulp for the bare
    ``pow``."""
    y = x.pow(1.0 / 3.0)
    return y + (x / (y * y) - y) * (1.0 / 3.0)


def cbrt_signed(x: Tensor) -> Tensor:
    """Cube root of any real tensor, as ``jnp.cbrt``: :func:`cbrt` of ``|x|``
    with the sign of ``x``, and 0 at 0."""
    a = x.abs()
    root = torch.where(a > 0, cbrt(torch.where(a > 0, a, 1.0)), 0.0)
    return torch.copysign(root, x)


def clip_rgb(rgb: Tensor) -> Tensor:
    """Clip an RGB image to [0,1]."""
    return torch.clamp(rgb, 0.0, 1.0)


def mat3_apply(img: Tensor, mat: Tensor) -> Tensor:
    """Apply a 3x3 matrix to the last axis of an image as nine scalar
    multiply-adds (the same association as the JAX package)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    out0 = mat[0, 0] * r + mat[0, 1] * g + mat[0, 2] * b
    out1 = mat[1, 0] * r + mat[1, 1] * g + mat[1, 2] * b
    out2 = mat[2, 0] * r + mat[2, 1] * g + mat[2, 2] * b
    return torch.stack([out0, out1, out2], dim=-1)


def bradford_adapt(current_xyz: Tensor, target_xyz: Tensor) -> Tensor:
    """Bradford adaptation matrix."""
    bradford = _f32(_BRADFORD_NP, current_xyz)
    bradford_inv = _f32(_BRADFORD_INV_NP, current_xyz)
    lms_curr = bradford @ current_xyz
    lms_targ = bradford @ target_xyz
    scale = lms_targ / lms_curr
    return bradford_inv @ (scale[:, None] * bradford)


def cam_to_rgb_norm_matrix(
    cam_mat: Tensor, cam_white: Tensor, dest_base: Tensor, dest_white: Tensor
) -> Tensor:
    """The 3x3 camera->destination matrix of cam_to_rgb_norm:
    ``inv(row_normalize(cam_mat @ (RGB->XYZ adapted to camera white)))``."""
    mat_rgb_to_xyz_d_cam = bradford_adapt(dest_white, cam_white) @ dest_base
    color_mat = cam_mat @ mat_rgb_to_xyz_d_cam
    color_sum = torch.sum(color_mat, dim=1, keepdim=True)
    color_mat = color_mat / color_sum
    # inv_ex: the same inverse without the check of its info on the host,
    # which would wait for the device's queue
    return torch.linalg.inv_ex(color_mat).inverse


def cam_to_lin_srgb_matrix(cam_mat: Tensor, cam_white: Tensor) -> Tensor:
    """Camera->linear-sRGB 3x3 (the matrix cam_to_lin_srgb applies)."""
    return cam_to_rgb_norm_matrix(
        cam_mat,
        cam_white,
        _f32(_REC709_TO_XYZ, cam_mat),
        _f32(_D65_XYZ, cam_mat),
    )


def color_tail_channels(
    r: Tensor, g: Tensor, b: Tensor, mat: Tensor,
    clip_highlights: bool, gamma_encode: bool,
):
    """The develop's channelwise colour tail: clip -> the cam->lin-sRGB
    ``mat`` -> sRGB gamma. The plain version of the AHD kernel's fused tail."""
    if clip_highlights:
        r = torch.clamp(r, 0.0, 1.0)
        g = torch.clamp(g, 0.0, 1.0)
        b = torch.clamp(b, 0.0, 1.0)
    ir = mat[0, 0] * r + mat[0, 1] * g + mat[0, 2] * b
    ig = mat[1, 0] * r + mat[1, 1] * g + mat[1, 2] * b
    ib = mat[2, 0] * r + mat[2, 1] * g + mat[2, 2] * b

    if gamma_encode:
        def gamma(x):
            x = torch.clamp(x, 0.0, 1.0)
            return torch.where(
                x <= 0.0031308,
                x * 12.92,
                1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055,
            )

        ir, ig, ib = gamma(ir), gamma(ig), gamma(ib)
    return ir, ig, ib


def cam_to_rgb_norm(
    rgb: Tensor,
    cam_mat: Tensor,
    cam_white: Tensor,
    dest_base: Tensor,
    dest_white: Tensor,
    clip_highlights: bool = True,
) -> Tensor:
    """Camera-space RGB (..., 3) -> destination linear RGB with de-tint
    normalization: build ``cam_mat @ (RGB->XYZ adapted to camera white)``,
    row-normalize so camera r=g=b maps to output r=g=b, invert, apply."""
    if clip_highlights:
        rgb = clip_rgb(rgb)
    color_mat = cam_to_rgb_norm_matrix(cam_mat, cam_white, dest_base, dest_white)
    return mat3_apply(rgb, color_mat).to(torch.float32)


def cam_to_lin_srgb(
    rgb: Tensor, cam_mat: Tensor, cam_white: Tensor, clip_highlights: bool = True
) -> Tensor:
    """Camera-space RGB (..., 3) -> linear sRGB with de-tint normalization."""
    return cam_to_rgb_norm(
        rgb, cam_mat, cam_white, _f32(_REC709_TO_XYZ, cam_mat), _f32(_D65_XYZ, cam_mat),
        clip_highlights,
    )


def cam_to_clean_xyz(
    rgb: Tensor, cam_mat: Tensor, cam_white: Tensor, clip_highlights: bool = True
) -> Tensor:
    """Camera RGB (..., 3) -> XYZ through a wide-gamut PCS (Rec. 2020)."""
    dest_base = _f32(_REC2020_TO_XYZ, cam_mat)
    rgb_norm = cam_to_rgb_norm(
        rgb, cam_mat, cam_white, dest_base, _f32(_D65_XYZ, cam_mat), clip_highlights
    )
    return mat3_apply(rgb_norm, dest_base).to(torch.float32)


def lin_srgb_to_srgb(rgb: Tensor) -> Tensor:
    """Linear sRGB -> sRGB gamma encode. Clips to [0,1] first."""
    rgb = clip_rgb(rgb)
    return torch.where(
        rgb <= 0.0031308,
        rgb * 12.92,
        1.055 * torch.pow(torch.clamp(rgb, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_to_lin_srgb(srgb: Tensor) -> Tensor:
    """sRGB -> linear sRGB gamma decode. Clips to [0,1] first."""
    srgb = clip_rgb(srgb)
    return torch.where(
        srgb <= 0.04045,
        div_const(srgb, 12.92),
        torch.pow(div_const(srgb + 0.055, 1.055), 2.4),
    )


def lin_srgb_to_oklab(lin_srgb: Tensor) -> Tensor:
    """Linear sRGB (..., 3) -> Oklab (Björn Ottosson's constants)."""
    r, g, b = lin_srgb[..., 0], lin_srgb[..., 1], lin_srgb[..., 2]

    l = 0.4122214708 * r + 0.5363325363 * g + 0.0514459929 * b
    m = 0.2119034982 * r + 0.6806995451 * g + 0.1073969566 * b
    s = 0.0883024619 * r + 0.2817188376 * g + 0.6299787005 * b

    lp, mp, sp = cbrt_signed(l), cbrt_signed(m), cbrt_signed(s)

    ok_l = 0.2104542553 * lp + 0.7936177850 * mp - 0.0040720468 * sp
    ok_a = 1.9779984951 * lp - 2.4285922050 * mp + 0.4505937099 * sp
    ok_b = 0.0259040371 * lp + 0.7827717662 * mp - 0.8086757660 * sp
    return torch.stack([ok_l, ok_a, ok_b], dim=-1)


def oklab_to_lin_srgb(oklab: Tensor) -> Tensor:
    """Oklab (..., 3) -> linear sRGB. No clamping applied."""
    ok_l, ok_a, ok_b = oklab[..., 0], oklab[..., 1], oklab[..., 2]

    lp = ok_l + 0.3963377774 * ok_a + 0.2158037573 * ok_b
    mp = ok_l - 0.1055613458 * ok_a - 0.0638541728 * ok_b
    sp = ok_l - 0.0894841775 * ok_a - 1.2914855480 * ok_b

    l, m, s = lp * lp * lp, mp * mp * mp, sp * sp * sp

    r = 4.0767416621 * l - 3.3077115913 * m + 0.2309699292 * s
    g = -1.2684380046 * l + 2.6097574011 * m - 0.3413193965 * s
    b = -0.0041960863 * l - 0.7034186147 * m + 1.7076147010 * s
    return torch.stack([r, g, b], dim=-1)


# --- CIELAB (cv2.cvtColor-compatible float path) -------------------------------------
# OpenCV's float32 RGB2Lab: linear RGB in [0,1] -> XYZ via the fixed matrix below,
# whitepoint-normalized (D65), then the CIE f() with the 0.008856 linear toe.
_CV2_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_CV2_LAB_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)


def rgb_to_lab_channels(r: Tensor, g: Tensor, b: Tensor):
    """Channelwise RGB [0,1] -> CIELAB with cv2's float semantics: clamp, sRGB
    decode, fixed XYZ matrix, D65 white, CIE f() with the linear toe. Same
    operation order as the JAX package."""

    def decode(x):
        x = torch.clamp(x, 0.0, 1.0)
        base = torch.clamp(div_const(x + 0.055, 1.055), min=1e-12)
        p = torch.pow(base, 2.4)
        return torch.where(x <= 0.04045, div_const(x, 12.92), p)

    r, g, b = decode(r), decode(g), decode(b)
    m = [[float(v) for v in row] for row in _CV2_RGB_TO_XYZ]
    wt = [float(v) for v in _CV2_LAB_WHITE]

    def f(t):
        return torch.where(
            t > 0.008856,
            cbrt(torch.clamp(t, min=1e-12)),
            7.787 * t + 16.0 / 116.0,
        )

    tx = div_const(m[0][0] * r + m[0][1] * g + m[0][2] * b, wt[0])
    ty = div_const(m[1][0] * r + m[1][1] * g + m[1][2] * b, wt[1])
    tz = div_const(m[2][0] * r + m[2][1] * g + m[2][2] * b, wt[2])

    fx, fy, fz = f(tx), f(ty), f(tz)
    lum = torch.where(ty > 0.008856, 116.0 * fy - 16.0, 903.3 * ty)
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return lum, a, bb


def rgb_to_lab(rgb: Tensor) -> Tensor:
    """RGB [0,1] (..., 3) -> CIELAB (..., 3) with cv2's float semantics:
    :func:`rgb_to_lab_channels` on the three channels, stacked."""
    lum, a, b = rgb_to_lab_channels(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return torch.stack([lum, a, b], dim=-1)
