"""Camera white-balance controller: DNG calibration-matrix blending.

Reference behavior: /root/reference/wb_cct/cam_wb.py:58-288.

- ``update_by_temperature(cct, duv, allow_cross_blend)``: CCT+Duv -> target XYZ
  (Ohno 2013); calibration matrices sorted by their calibration CCT; blending restricted
  to the daylight series unless cross-blend is allowed; mired-space linear interpolation
  of the two bracketing matrices (cam_wb.py:81-165).
- ``update_by_reference(ref_white)``: pick the two matrices with the lowest tint error
  against the ideal-Duv curve, then bisect (<=30 iters) the blend factor minimizing
  ``|Duv - ideal(CCT)|`` of ``inv(M) @ neutral`` (cam_wb.py:167-234).

Host-side scalar optimization in float64 NumPy — output is a (3,3) matrix + camera
white XYZ + neutral multipliers that feed the device pytrees.

Intended-behavior fixes over the reference (SURVEY.md §7 defect list):
- single-matrix ``update_by_temperature`` used ``targ_xyz`` before assignment
  (cam_wb.py:93-95); here the target XYZ is computed first.
- ``update_by_reference``'s non-adjacent-matrix path returned a value instead of
  setting controller state (cam_wb.py:204-206); here it sets state.
- mired interpolation indexed the unfiltered CCT list with filtered-list indices
  (cam_wb.py:158-160); here the filtered list is used consistently.
- the stray debug print of multipliers (cam_wb.py:79) is dropped.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .cct import (
    cct_to_mired,
    cct_to_xyz_ohno,
    get_ideal_duv,
    xyz_to_cct_ohno,
)
from .illuminants import StandardIlluminantSeries
from .spaces import MatXyzToCamera


class CameraWhiteBalanceController:
    def __init__(self, mats: List[MatXyzToCamera], initial_ref_white: np.ndarray):
        """Create a WB controller from camera calibration profiles.

        Args:
            mats: XYZ->camera calibration matrices (at least one).
            initial_ref_white: camera-space neutral for pre-optimization
                (e.g. DNG AsShotNeutral). Not normalized to G=1.
        """
        if len(mats) == 0:
            raise ValueError("At least one calibration matrix is required")
        self._mats = list(mats)
        self._optimal_multipliers = np.array(initial_ref_white, np.float64, copy=True)
        self._optimal_mat: Optional[MatXyzToCamera] = None
        self.update_by_reference(initial_ref_white)

    # -- internal ---------------------------------------------------------------
    def _set_optimal(self, mat: np.ndarray, xyz: np.ndarray) -> None:
        """Store the optimal matrix and derive neutral multipliers, G-normalized
        (cam_wb.py:75-79)."""
        self._optimal_mat = MatXyzToCamera(mat, xyz)
        mult = self._optimal_mat.mat @ np.asarray(xyz, np.float64)
        self._optimal_multipliers = mult / mult[1]

    def _sorted_by_cct(self):
        mat_k = [xyz_to_cct_ohno(m.xyz)[0] for m in self._mats]
        order = np.argsort(mat_k)
        return [float(mat_k[i]) for i in order], [self._mats[i] for i in order]

    # -- public API -------------------------------------------------------------
    def update_by_temperature(
        self,
        cct: float,
        duv: Optional[float] = None,
        allow_cross_blend: bool = False,
    ) -> None:
        """Re-optimize for a target scene illuminant given by CCT (+ optional Duv)."""
        if duv is None:
            # Temperature conventionally refers to D-series daylight; aim for the
            # D-series tint above 4000K, the Planckian locus below (cam_wb.py:100-107).
            duv = get_ideal_duv(cct)

        targ_xyz = cct_to_xyz_ohno(np.array([cct, duv]))

        if len(self._mats) == 1:
            self._set_optimal(self._mats[0].mat, targ_xyz)
            return

        mat_k, mats_by_k = self._sorted_by_cct()

        # Outside the calibration range: clamp to the edge matrix (cam_wb.py:113-118)
        if cct <= mat_k[0]:
            self._set_optimal(mats_by_k[0].mat, targ_xyz)
            return
        if cct >= mat_k[-1]:
            self._set_optimal(mats_by_k[-1].mat, targ_xyz)
            return

        ref_list_k = mat_k
        ref_list_mats = mats_by_k

        if not allow_cross_blend:
            # Only blend within the daylight series (cam_wb.py:126-146)
            ref_list_k = []
            ref_list_mats = []
            for k, mat in zip(mat_k, mats_by_k):
                if mat.series == StandardIlluminantSeries.SERIES_DAYLIGHT:
                    ref_list_k.append(k)
                    ref_list_mats.append(mat)

            if len(ref_list_mats) == 0:
                raise ValueError(
                    "Could not find any daylight series matrices inside DNG!"
                )
            if len(ref_list_mats) == 1:
                self._set_optimal(ref_list_mats[0].mat, targ_xyz)
                return

        # Find the bracketing pair around the target CCT (cam_wb.py:148-156)
        idx_0 = int(np.searchsorted(np.asarray(ref_list_k), cct)) - 1
        idx_0 = int(np.clip(idx_0, 0, len(ref_list_mats) - 2))
        idx_1 = idx_0 + 1

        mat_0 = ref_list_mats[idx_0]
        mat_1 = ref_list_mats[idx_1]

        # Mired-space linear blend (cam_wb.py:158-163). Reference indexed the
        # unfiltered list here — fixed to the filtered one.
        mired_0 = cct_to_mired(ref_list_k[idx_0])
        mired_1 = cct_to_mired(ref_list_k[idx_1])
        mired_target = cct_to_mired(cct)

        blend_toward_0 = (mired_1 - mired_target) / (mired_1 - mired_0)
        blended = mat_0.interpolate(mat_1, 1.0 - blend_toward_0)

        self._set_optimal(blended, targ_xyz)

    def update_by_reference(
        self,
        ref_white: np.ndarray,
        max_iters: int = 30,
        stop_epsilon: float = 1e-6,
    ) -> None:
        """Re-optimize under a camera neutral point (e.g. AsShotNeutral).

        Bisects the blend factor between the two best-fitting calibration matrices to
        minimize the Duv error against the ideal tint curve (cam_wb.py:167-234).
        """
        self._optimal_multipliers = np.array(ref_white, np.float64, copy=True)

        if len(self._mats) == 1:
            m = self._mats[0]
            self._optimal_mat = MatXyzToCamera(
                m.mat, np.linalg.inv(m.mat) @ self._optimal_multipliers
            )
            return

        mat_k, mats = self._sorted_by_cct()

        # Tint error of each calibration matrix's implied illuminant vs the ideal curve
        mat_t = []
        for k, mat in zip(mat_k, mats):
            tint = xyz_to_cct_ohno(np.linalg.inv(mat.mat) @ self._optimal_multipliers)[1]
            mat_t.append(abs(get_ideal_duv(k) - tint))

        idx_lowest = list(np.argsort(mat_t))

        if abs(idx_lowest[0] - idx_lowest[1]) == 1:
            mat_0 = mats[idx_lowest[0]]
            mat_1 = mats[idx_lowest[1]]
        else:
            # Best two aren't adjacent: use the best alone. (The reference returned a
            # value here without setting state — fixed to set state.)
            mat_0 = mats[idx_lowest[0]]
            self._optimal_mat = MatXyzToCamera(
                mat_0.mat, np.linalg.inv(mat_0.mat) @ self._optimal_multipliers
            )
            return

        best_xyz = np.linalg.inv(mat_0.mat) @ self._optimal_multipliers

        best = min(mat_t)
        best_bf = 0.0
        worst_bf = 1.0

        i = 0
        while i < max_iters and abs(best_bf - worst_bf) > stop_epsilon:
            current = (worst_bf + best_bf) / 2
            current_xyz = (
                np.linalg.inv(mat_0.interpolate(mat_1, current))
                @ self._optimal_multipliers
            )
            cct, tint = xyz_to_cct_ohno(current_xyz)
            err = abs(get_ideal_duv(cct) - tint)

            if err <= best:
                best = err
                best_xyz = current_xyz
                best_bf = current
            else:
                worst_bf = current
            i += 1

        self._optimal_mat = MatXyzToCamera(mat_0.interpolate(mat_1, best_bf), best_xyz)

    def get_reciprocal_multipliers(self) -> np.ndarray:
        """Reciprocal neutral multipliers — multiply channels by these to white
        balance (cam_wb.py:236-243)."""
        return 1.0 / self._optimal_multipliers

    def get_neutral(self) -> np.ndarray:
        """Camera neutral point (the RawFrame.wb_neutral leaf)."""
        return np.copy(self._optimal_multipliers)

    def get_matrix(self) -> MatXyzToCamera:
        """Optimal XYZ->camera matrix under current parameters (cam_wb.py:245-251)."""
        return self._optimal_mat

    def copy(self) -> "CameraWhiteBalanceController":
        out = object.__new__(CameraWhiteBalanceController)
        out._mats = [MatXyzToCamera(m.mat, m.xyz, m.series) for m in self._mats]
        out._optimal_multipliers = np.copy(self._optimal_multipliers)
        out._optimal_mat = MatXyzToCamera(self._optimal_mat.mat, self._optimal_mat.xyz)
        return out


def controller_from_tags(tags: Dict[str, Any]) -> CameraWhiteBalanceController:
    """Build a controller from parsed DNG metadata (CameraWhiteBalanceControllerFromExif
    equivalent, cam_wb.py:266-288). ``tags`` is the dict returned by pysp_tpu.io."""
    from ..io.metadata import exif_get_as_shot_neutral, exif_get_color_mat_sources

    mats = exif_get_color_mat_sources(tags)
    if len(mats) == 0:
        raise KeyError(
            "EXIF ColorMatrix tags or illuminant tags missing, could not create "
            "white balance controller!"
        )
    neutral = exif_get_as_shot_neutral(tags)
    return CameraWhiteBalanceController(mats, neutral)
