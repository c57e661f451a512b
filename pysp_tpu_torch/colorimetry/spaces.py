"""RGB colorspace algebra and chromatic adaptation (host-side, tiny matrices).

Reference behavior: /root/reference/colorize/rgb_space.py (primaries+white -> matrix
:19-52, presets :54-56) and /root/reference/wb_cct/helpers_cam_mat.py (Bradford :7-20,
camera matrix containers :22-38).

These run on the host in float64 NumPy: they produce 3x3 matrices consumed by device
programs, so there is nothing to accelerate.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from .illuminants import (
    StandardIlluminant,
    StandardIlluminantSeries,
    get_chromaticity_from_illuminant,
    xy_to_xyz,
)

BRADFORD_XYZ_TO_LMS = np.array(
    [
        [0.8951000, 0.2664000, -0.1614000],
        [-0.7502000, 1.7135000, 0.0367000],
        [0.0389000, -0.0685000, 1.0296000],
    ]
)


def bradford_adapt_matrix(current_xyz: np.ndarray, target_xyz: np.ndarray) -> np.ndarray:
    """Bradford chromatic adaptation matrix (helpers_cam_mat.py:7-20)."""
    lms_curr = BRADFORD_XYZ_TO_LMS @ np.asarray(current_xyz, np.float64)
    lms_targ = BRADFORD_XYZ_TO_LMS @ np.asarray(target_xyz, np.float64)
    mat_scale = np.diag(lms_targ / lms_curr)
    return np.linalg.inv(BRADFORD_XYZ_TO_LMS) @ mat_scale @ BRADFORD_XYZ_TO_LMS


class ChromaticityMat:
    """Immutable 3x3 matrix + its calibration white (helpers_cam_mat.py:22-28)."""

    def __init__(self, mat: np.ndarray, xyz: np.ndarray):
        self.mat = np.array(mat, np.float64, copy=True)
        self.mat.setflags(write=False)
        self.xyz = np.array(xyz, np.float64, copy=True)
        self.xyz.setflags(write=False)


class MatXyzToCamera(ChromaticityMat):
    """XYZ->camera calibration matrix with its illuminant series (helpers_cam_mat.py:30-38)."""

    def __init__(
        self,
        mat: np.ndarray,
        xyz: np.ndarray,
        series: Optional[StandardIlluminantSeries] = None,
        provenance: Optional[str] = None,
    ):
        super().__init__(mat, xyz)
        self.series = series
        # data lineage, e.g. "exif" (read from the file), "registry" (built-in
        # Adobe table), "estimated-stda" (metamerism estimate — see
        # io/camera_matrices.py), "harvested" (pulled from a sibling DNG).
        self.provenance = provenance

    def interpolate(self, nxt: "MatXyzToCamera", blend: float) -> np.ndarray:
        blend = float(np.clip(blend, 0.0, 1.0))
        return self.mat * (1 - blend) + nxt.mat * blend


class ArbitraryRgbColorspace:
    """RGB colorspace from primaries + whitepoint (rgb_space.py:19-52)."""

    def __init__(
        self,
        primary_xy_r: Tuple[float, float],
        primary_xy_g: Tuple[float, float],
        primary_xy_b: Tuple[float, float],
        whitepoint: StandardIlluminant,
    ):
        self._primary_r = primary_xy_r
        self._primary_g = primary_xy_g
        self._primary_b = primary_xy_b
        self._whitepoint = xy_to_xyz(get_chromaticity_from_illuminant(whitepoint))

    def mat_to_rgb(
        self,
        source_whitepoint: Optional[
            Union[Tuple[float, float, float], StandardIlluminant]
        ] = None,
    ) -> np.ndarray:
        return np.linalg.inv(self.mat_to_xyz(source_whitepoint))

    def mat_to_xyz(
        self,
        destination_whitepoint: Optional[
            Union[Tuple[float, float, float], StandardIlluminant]
        ] = None,
    ) -> np.ndarray:
        def coeff0(p: Tuple[float, float]) -> float:
            return p[0] / p[1]

        def coeff1(p: Tuple[float, float]) -> float:
            return (1 - p[0] - p[1]) / p[1]

        matrix = np.array(
            [
                [coeff0(self._primary_r), coeff0(self._primary_g), coeff0(self._primary_b)],
                [1.0, 1.0, 1.0],
                [coeff1(self._primary_r), coeff1(self._primary_g), coeff1(self._primary_b)],
            ]
        )

        s = np.linalg.inv(matrix) @ self._whitepoint
        matrix = matrix * s[np.newaxis, :]

        if destination_whitepoint is not None:
            if isinstance(destination_whitepoint, StandardIlluminant):
                destination_white = xy_to_xyz(
                    get_chromaticity_from_illuminant(destination_whitepoint)
                )
            else:
                destination_white = np.asarray(destination_whitepoint, np.float64)
            assert destination_white.shape == (3,)
            adapt = bradford_adapt_matrix(self._whitepoint, destination_white)
            return adapt @ matrix

        return matrix


class LinRgbColorspace:
    REC709 = ArbitraryRgbColorspace(
        (0.64, 0.33), (0.3, 0.6), (0.15, 0.06), StandardIlluminant.D65
    )
    REC2020 = ArbitraryRgbColorspace(
        (0.708, 0.292), (0.170, 0.797), (0.131, 0.046), StandardIlluminant.D65
    )
