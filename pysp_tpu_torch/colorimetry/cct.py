"""Correlated color temperature math: Ohno (2013) CCT<->chromaticity, CIE D series.

The reference delegates these to colour-science (wb_cct/cam_wb.py:56,98,110,158-160):
``XYZ_to_CCT_Ohno2013``, ``CCT_to_XYZ_Ohno2013``, ``CCT_to_xy_CIE_D``, ``xy_to_UCS_uv``,
``uv_to_CCT_Ohno2013``, ``CCT_to_mired``. colour-science is not available here, so this
module reimplements them:

- CIE 1931 2-deg color matching functions via the multi-lobe Gaussian analytic fits of
  Wyman, Sloan & Shirley (JCGT 2013) — accurate to a few 1e-3, which lands CCT within
  ~10 K and Duv within ~3e-4 of table-based implementations (validated against known
  anchors in tests/test_cct.py).
- Planckian locus table in CIE 1960 (u,v), geometric temperature grid 1000K..50000K,
  with Ohno-style triangular interpolation for the inverse lookup (grid fine enough
  that the parabolic refinement is unnecessary).

Host-side float64 NumPy: these feed the WB solver's scalar optimization, never the
per-pixel path.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

# Planck's law radiation constants (CIE: c2 = 1.4388e-2 m K)
_C1 = 3.741771e-16
_C2 = 1.4388e-2

# Wyman, Sloan, Shirley (2013) multi-lobe Gaussian fits to the CIE 1931 2-deg CMFs.
# Each lobe: (scale, center_nm, inv_sigma_left, inv_sigma_right) with
# g(x) = exp(-0.5 * ((x - center) * inv_sigma_side)^2).
_X_LOBES = (
    (0.362, 442.0, 1 / 16.0, 1 / 26.7),
    (1.056, 599.8, 1 / 37.9, 1 / 31.0),
    (-0.065, 501.1, 1 / 20.4, 1 / 26.2),
)
_Y_LOBES = (
    (0.821, 568.8, 1 / 46.9, 1 / 40.5),
    (0.286, 530.9, 1 / 16.3, 1 / 31.1),
)
_Z_LOBES = (
    (1.217, 437.0, 1 / 11.8, 1 / 36.0),
    (0.681, 459.0, 1 / 26.0, 1 / 13.8),
)


def _lobes(lam_nm: np.ndarray, lobes) -> np.ndarray:
    out = np.zeros_like(lam_nm, dtype=np.float64)
    for scale, center, inv_l, inv_r in lobes:
        inv = np.where(lam_nm < center, inv_l, inv_r)
        out += scale * np.exp(-0.5 * ((lam_nm - center) * inv) ** 2)
    return out


@lru_cache(maxsize=1)
def _cmfs() -> Tuple[np.ndarray, np.ndarray]:
    lam = np.arange(360.0, 831.0, 1.0)
    cmf = np.stack(
        [_lobes(lam, _X_LOBES), _lobes(lam, _Y_LOBES), _lobes(lam, _Z_LOBES)], axis=1
    )
    return lam, cmf


def blackbody_xyz(temperature: float | np.ndarray) -> np.ndarray:
    """XYZ (Y-normalized) of a Planckian radiator at the given temperature(s)."""
    lam_nm, cmf = _cmfs()
    lam_m = lam_nm * 1e-9
    t = np.atleast_1d(np.asarray(temperature, np.float64))[:, None]
    m = _C1 * lam_m[None, :] ** -5 / np.expm1(_C2 / (lam_m[None, :] * t))
    xyz = m @ cmf
    xyz = xyz / xyz[:, 1:2]
    return xyz[0] if np.isscalar(temperature) or np.ndim(temperature) == 0 else xyz


def xyz_to_uv(xyz: np.ndarray) -> np.ndarray:
    """XYZ -> CIE 1960 UCS (u, v)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    denom = x + 15.0 * y + 3.0 * z
    return np.stack([4.0 * x / denom, 6.0 * y / denom], axis=-1)


def xy_to_uv(xy) -> np.ndarray:
    """CIE xy -> CIE 1960 (u, v) (colour.xy_to_UCS_uv equivalent)."""
    x, y = float(xy[0]), float(xy[1])
    denom = -2.0 * x + 12.0 * y + 3.0
    return np.array([4.0 * x / denom, 6.0 * y / denom])


def uv_to_xy(uv) -> np.ndarray:
    """CIE 1960 (u, v) -> CIE xy."""
    u, v = float(uv[0]), float(uv[1])
    denom = 2.0 * u - 8.0 * v + 4.0
    return np.array([3.0 * u / denom, 2.0 * v / denom])


@lru_cache(maxsize=1)
def _planck_table() -> Tuple[np.ndarray, np.ndarray]:
    """Geometric temperature grid + (u, v) locus (ratio 1.0005: ~7800 points)."""
    n = int(np.ceil(np.log(50000.0 / 1000.0) / np.log(1.0005))) + 1
    temps = 1000.0 * (1.0005 ** np.arange(n))
    uv = xyz_to_uv(blackbody_xyz(temps))
    return temps, uv


def uv_to_cct_ohno(uv) -> Tuple[float, float]:
    """(u, v) -> (CCT, Duv) via the Ohno (2013) triangular solution.

    Positive Duv lies above the Planckian locus (toward +v), matching the CIE
    convention and colour-science's output.
    """
    u, v = float(uv[0]), float(uv[1])
    temps, locus = _planck_table()
    d2 = (locus[:, 0] - u) ** 2 + (locus[:, 1] - v) ** 2
    m = int(np.clip(np.argmin(d2), 1, len(temps) - 2))

    tm1, tp1 = temps[m - 1], temps[m + 1]
    dm1, dp1 = np.sqrt(d2[m - 1]), np.sqrt(d2[m + 1])

    # Triangular solution. Ohno's paper pairs a coarse grid with a parabolic
    # refinement; our grid is fine enough (ratio 1.0005, locus locally straight
    # across 3 points) that the triangular solution alone is sub-0.1K accurate,
    # and the 3-point parabola would be numerically degenerate at this density.
    l2 = (locus[m + 1, 0] - locus[m - 1, 0]) ** 2 + (locus[m + 1, 1] - locus[m - 1, 1]) ** 2
    l = np.sqrt(l2)
    x = (dm1**2 - dp1**2 + l2) / (2.0 * l)
    cct = tm1 + (tp1 - tm1) * x / l
    duv = np.sqrt(max(dm1**2 - x**2, 0.0))

    # Sign: positive above the locus. Compare v with the locus v at the solution.
    v_locus = np.interp(cct, temps, locus[:, 1])
    if v < v_locus:
        duv = -abs(duv)
    else:
        duv = abs(duv)
    return float(cct), float(duv)


def xyz_to_cct_ohno(xyz) -> Tuple[float, float]:
    """XYZ -> (CCT, Duv) (colour.temperature.XYZ_to_CCT_Ohno2013 equivalent)."""
    return uv_to_cct_ohno(xyz_to_uv(np.asarray(xyz, np.float64)))


def cct_to_uv_ohno(cct: float, duv: float = 0.0) -> np.ndarray:
    """(CCT, Duv) -> (u, v): locus point offset by duv along the locus normal."""
    temps, locus = _planck_table()
    u0 = np.interp(cct, temps, locus[:, 0])
    v0 = np.interp(cct, temps, locus[:, 1])
    if duv == 0.0:
        return np.array([u0, v0])

    # Tangent by finite difference on the table
    dt = max(cct * 1e-4, 0.1)
    u1 = np.interp(cct + dt, temps, locus[:, 0])
    v1 = np.interp(cct + dt, temps, locus[:, 1])
    du, dv = u1 - u0, v1 - v0
    norm = np.hypot(du, dv)
    # Normal oriented toward +v (above locus)
    nu, nv = -dv / norm, du / norm
    if nv < 0:
        nu, nv = -nu, -nv
    return np.array([u0 + duv * nu, v0 + duv * nv])


def cct_to_xyz_ohno(cct_duv) -> np.ndarray:
    """(CCT, Duv) -> XYZ at Y=1 (colour.temperature.CCT_to_XYZ_Ohno2013 equivalent)."""
    cct, duv = float(cct_duv[0]), float(cct_duv[1])
    xy = uv_to_xy(cct_to_uv_ohno(cct, duv))
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def cct_to_xy_cie_d(cct: float) -> np.ndarray:
    """CIE D-series daylight chromaticity for 4000K <= CCT <= 25000K."""
    t = float(cct)
    if t < 4000.0 or t > 25000.0:
        raise ValueError(f"CIE D series undefined for {t} K")
    if t <= 7000.0:
        x = (
            0.244063
            + 0.09911e3 / t
            + 2.9678e6 / t**2
            - 4.6070e9 / t**3
        )
    else:
        x = (
            0.237040
            + 0.24748e3 / t
            + 1.9018e6 / t**2
            - 2.0064e9 / t**3
        )
    y = -3.000 * x**2 + 2.870 * x - 0.275
    return np.array([x, y])


def cct_to_mired(cct: float) -> float:
    """Temperature (K) -> mired (micro reciprocal degrees)."""
    return 1e6 / float(cct)


def mired_to_cct(mired: float) -> float:
    return 1e6 / float(mired)


def get_ideal_duv(temperature: float) -> float:
    """Desirable Duv for a CCT (reference: wb_cct/cam_wb.py:42-56).

    0 below 4000K (D-series undefined; documented discontinuity), else the Duv of the
    D-series illuminant at that temperature.
    """
    if temperature < 4000.0:
        return 0.0
    uv = xy_to_uv(cct_to_xy_cie_d(min(temperature, 25000.0)))
    return uv_to_cct_ohno(uv)[1]
