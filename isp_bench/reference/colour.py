"""The colour metadata's arithmetic, worked out again from the camera's DNG
tags: the white-balance solve (two calibration matrices blended to the
as-shot neutral, Ohno's CCT), the camera -> linear sRGB matrix, CIELAB and
the colour tail. A frozen copy of the plain paths of the port's
``colorimetry/``; host arithmetic in float64 NumPy, pixels in the dtype of
the tensors given.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# --- CCT (Ohno 2013) on the Wyman-Sloan-Shirley fits of the CIE 1931 CMFs ------

_C1, _C2 = 3.741771e-16, 1.4388e-2
_X_LOBES = ((0.362, 442.0, 1 / 16.0, 1 / 26.7), (1.056, 599.8, 1 / 37.9, 1 / 31.0),
            (-0.065, 501.1, 1 / 20.4, 1 / 26.2))
_Y_LOBES = ((0.821, 568.8, 1 / 46.9, 1 / 40.5), (0.286, 530.9, 1 / 16.3, 1 / 31.1))
_Z_LOBES = ((1.217, 437.0, 1 / 11.8, 1 / 36.0), (0.681, 459.0, 1 / 26.0, 1 / 13.8))


def _lobes(lam, lobes):
    out = np.zeros_like(lam, dtype=np.float64)
    for scale, center, inv_l, inv_r in lobes:
        inv = np.where(lam < center, inv_l, inv_r)
        out += scale * np.exp(-0.5 * ((lam - center) * inv) ** 2)
    return out


def _xyz_to_uv(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    d = x + 15.0 * y + 3.0 * z
    return np.stack([4.0 * x / d, 6.0 * y / d], axis=-1)


def _planck_table():
    lam = np.arange(360.0, 831.0, 1.0)
    cmf = np.stack([_lobes(lam, _X_LOBES), _lobes(lam, _Y_LOBES), _lobes(lam, _Z_LOBES)], 1)
    n = int(np.ceil(np.log(50000.0 / 1000.0) / np.log(1.0005))) + 1
    temps = 1000.0 * (1.0005 ** np.arange(n))
    lam_m = lam * 1e-9
    m = _C1 * lam_m[None, :] ** -5 / np.expm1(_C2 / (lam_m[None, :] * temps[:, None]))
    xyz = m @ cmf
    return temps, _xyz_to_uv(xyz / xyz[:, 1:2])


_TEMPS, _LOCUS = _planck_table()


def _uv_to_cct(u: float, v: float):
    d2 = (_LOCUS[:, 0] - u) ** 2 + (_LOCUS[:, 1] - v) ** 2
    m = int(np.clip(np.argmin(d2), 1, len(_TEMPS) - 2))
    dm1, dp1 = np.sqrt(d2[m - 1]), np.sqrt(d2[m + 1])
    l2 = (_LOCUS[m + 1, 0] - _LOCUS[m - 1, 0]) ** 2 + (_LOCUS[m + 1, 1] - _LOCUS[m - 1, 1]) ** 2
    ln = np.sqrt(l2)
    x = (dm1**2 - dp1**2 + l2) / (2.0 * ln)
    cct = _TEMPS[m - 1] + (_TEMPS[m + 1] - _TEMPS[m - 1]) * x / ln
    duv = np.sqrt(max(dm1**2 - x**2, 0.0))
    return float(cct), float(-duv if v < np.interp(cct, _TEMPS, _LOCUS[:, 1]) else duv)


def xyz_to_cct(xyz):
    u, v = _xyz_to_uv(np.asarray(xyz, np.float64))
    return _uv_to_cct(float(u), float(v))


def ideal_duv(t: float) -> float:
    """The Duv of the CIE D series at ``t`` (0 below 4000 K)."""
    if t < 4000.0:
        return 0.0
    t = min(t, 25000.0)
    if t <= 7000.0:
        x = 0.244063 + 0.09911e3 / t + 2.9678e6 / t**2 - 4.6070e9 / t**3
    else:
        x = 0.237040 + 0.24748e3 / t + 1.9018e6 / t**2 - 2.0064e9 / t**3
    y = -3.000 * x**2 + 2.870 * x - 0.275
    d = -2.0 * x + 12.0 * y + 3.0
    return _uv_to_cct(4.0 * x / d, 6.0 * y / d)[1]


# EXIF LightSource -> CIE xy of the standard illuminant
_LIGHTSOURCE_XY = {12: (0.31310, 0.33727), 13: (0.31379, 0.34531), 14: (0.37208, 0.37529),
                   15: (0.40910, 0.39430), 16: (0.44018, 0.40329), 17: (0.44758, 0.40745),
                   18: (0.34842, 0.35161), 19: (0.31006, 0.31616), 20: (0.33242, 0.34743),
                   21: (0.31272, 0.32903), 22: (0.29902, 0.31485), 23: (0.34567, 0.35850)}


def _xy_to_xyz(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)


def white_balance(camera: dict):
    """(XYZ -> camera matrix, scene white XYZ, camera neutral) of ``camera``'s
    tags: the two calibration matrices, sorted by their illuminant's CCT,
    blended at the factor (bisected, at most 30 steps) whose implied white has
    the tint nearest the ideal curve, for the as-shot neutral."""
    # the values as the DNG stores them: rationals over 10000
    def stored(v):
        return np.round(np.asarray(v, np.float64) * 10000) / 10000

    mats = [(stored(camera[f"color_matrix_{k}"]).reshape(3, 3),
             _xy_to_xyz(_LIGHTSOURCE_XY[int(camera[f"illuminant_{k}"])])) for k in (1, 2)]
    neutral = stored(camera["as_shot_neutral"])
    ccts = [xyz_to_cct(xyz)[0] for _, xyz in mats]
    order = np.argsort(ccts)
    ccts = [ccts[i] for i in order]
    mats = [mats[i][0] for i in order]
    errs = [abs(ideal_duv(k) - xyz_to_cct(np.linalg.inv(m) @ neutral)[1])
            for k, m in zip(ccts, mats)]
    first, second = (int(i) for i in np.argsort(errs)[:2])
    m0, m1 = mats[first], mats[second]
    best, best_xyz = min(errs), np.linalg.inv(m0) @ neutral
    lo, hi = 0.0, 1.0
    for _ in range(30):
        if abs(lo - hi) <= 1e-6:
            break
        mid = (hi + lo) / 2
        xyz = np.linalg.inv(m0 * (1 - mid) + m1 * mid) @ neutral
        cct, tint = xyz_to_cct(xyz)
        err = abs(ideal_duv(cct) - tint)
        if err <= best:
            best, best_xyz, lo = err, xyz, mid
        else:
            hi = mid
    return m0 * (1 - lo) + m1 * lo, best_xyz, neutral


# --- camera -> linear sRGB ---------------------------------------------------

_BRADFORD = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]], np.float64)
_D65 = np.array([0.31272 / 0.32903, 1.0, (1 - 0.31272 - 0.32903) / 0.32903])


def _rec709_to_xyz() -> np.ndarray:
    prim = [(0.64, 0.33), (0.3, 0.6), (0.15, 0.06)]
    m = np.array([[p[0] / p[1] for p in prim], [1.0] * 3,
                  [(1 - p[0] - p[1]) / p[1] for p in prim]])
    return m * (np.linalg.inv(m) @ _xy_to_xyz((0.31272, 0.32903)))[None, :]


def cam_to_lin_srgb_matrix(cam_mat: Tensor, cam_white: Tensor) -> Tensor:
    """inv(row-normalised(cam_mat @ Bradford(D65 -> white) @ Rec.709 -> XYZ)),
    in float32 on the tensors' device."""
    f32 = dict(dtype=torch.float32, device=cam_mat.device)
    brad = torch.tensor(_BRADFORD, **f32)
    brad_inv = torch.tensor(np.linalg.inv(_BRADFORD), **f32)
    scale = (brad @ cam_white) / (brad @ torch.tensor(_D65, **f32))
    adapt = brad_inv @ (scale[:, None] * brad)
    m = cam_mat @ (adapt @ torch.tensor(_rec709_to_xyz(), **f32))
    return torch.linalg.inv(m / m.sum(dim=1, keepdim=True))


def div_const(x: Tensor, c: float) -> Tensor:
    """``x / c`` as a true division by the constant rounded to x's dtype."""
    return x / torch.full((), float(np.float32(c)), dtype=x.dtype, device=x.device)


def cbrt(x: Tensor) -> Tensor:
    """Cube root of a positive tensor: pow, then one Newton step."""
    y = x.pow(1.0 / 3.0)
    return y + (x / (y * y) - y) * (1.0 / 3.0)


_CV2_RGB_TO_XYZ = [[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                   [0.019334, 0.119193, 0.950227]]
_CV2_WHITE = [0.950456, 1.0, 1.088754]


def _f32(v: float) -> float:
    return float(np.float32(v))


def rgb_to_lab(r: Tensor, g: Tensor, b: Tensor):
    """cv2's float RGB -> CIELAB on separate channels: clamp, sRGB decode, the
    fixed XYZ matrix, the D65 white and the CIE f() with its linear toe."""
    def decode(x):
        x = torch.clamp(x, 0.0, 1.0)
        p = torch.pow(torch.clamp(div_const(x + 0.055, 1.055), min=1e-12), 2.4)
        return torch.where(x <= 0.04045, div_const(x, 12.92), p)

    r, g, b = decode(r), decode(g), decode(b)
    m = [[_f32(v) for v in row] for row in _CV2_RGB_TO_XYZ]

    def f(t):
        return torch.where(t > 0.008856, cbrt(torch.clamp(t, min=1e-12)), 7.787 * t + 16.0 / 116.0)

    tx = div_const(m[0][0] * r + m[0][1] * g + m[0][2] * b, _CV2_WHITE[0])
    ty = div_const(m[1][0] * r + m[1][1] * g + m[1][2] * b, _CV2_WHITE[1])
    tz = div_const(m[2][0] * r + m[2][1] * g + m[2][2] * b, _CV2_WHITE[2])
    fx, fy, fz = f(tx), f(ty), f(tz)
    lum = torch.where(ty > 0.008856, 116.0 * fy - 16.0, 903.3 * ty)
    return lum, 500.0 * (fx - fy), 200.0 * (fy - fz)


def colour_tail(r: Tensor, g: Tensor, b: Tensor, mat: Tensor, clip: bool, gamma: bool):
    """Clip to [0, 1], the camera -> linear sRGB matrix, the sRGB gamma."""
    if clip:
        r, g, b = (torch.clamp(c, 0.0, 1.0) for c in (r, g, b))
    out = [mat[i, 0] * r + mat[i, 1] * g + mat[i, 2] * b for i in range(3)]
    if gamma:
        def encode(x):
            x = torch.clamp(x, 0.0, 1.0)
            return torch.where(x <= 0.0031308, x * 12.92,
                               1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055)
        out = [encode(c) for c in out]
    return out
