"""Standard illuminant tables and lookups.

Reference behavior: /root/reference/wb_cct/standard_ill.py (chromaticity table :27-40,
series table :42-55, EXIF LightSource mapping :57-70, lookup helpers :72-117).
"""
from __future__ import annotations

from enum import IntEnum, auto
from typing import Dict, Tuple

import numpy as np


class StandardIlluminantSeries(IntEnum):
    STANDALONE = auto()
    SERIES_DAYLIGHT = auto()
    SERIES_FLUORESCENT = auto()


class StandardIlluminant(IntEnum):
    A = auto()
    B = auto()
    C = auto()
    D50 = auto()
    D55 = auto()
    D65 = auto()
    D75 = auto()
    F1 = auto()
    F2 = auto()
    F3 = auto()
    F4 = auto()
    F5 = auto()


STANDARD_ILLUMINANT_TO_XY: Dict[StandardIlluminant, Tuple[float, float]] = {
    StandardIlluminant.A: (0.44758, 0.40745),
    StandardIlluminant.B: (0.34842, 0.35161),
    StandardIlluminant.C: (0.31006, 0.31616),
    StandardIlluminant.D50: (0.34567, 0.35850),
    StandardIlluminant.D55: (0.33242, 0.34743),
    StandardIlluminant.D65: (0.31272, 0.32903),
    StandardIlluminant.D75: (0.29902, 0.31485),
    StandardIlluminant.F1: (0.31310, 0.33727),
    StandardIlluminant.F2: (0.37208, 0.37529),
    StandardIlluminant.F3: (0.40910, 0.39430),
    StandardIlluminant.F4: (0.44018, 0.40329),
    StandardIlluminant.F5: (0.31379, 0.34531),
}

STANDARD_ILLUMINANT_TO_SERIES: Dict[StandardIlluminant, StandardIlluminantSeries] = {
    StandardIlluminant.A: StandardIlluminantSeries.STANDALONE,
    StandardIlluminant.B: StandardIlluminantSeries.STANDALONE,
    StandardIlluminant.C: StandardIlluminantSeries.STANDALONE,
    StandardIlluminant.D50: StandardIlluminantSeries.SERIES_DAYLIGHT,
    StandardIlluminant.D55: StandardIlluminantSeries.SERIES_DAYLIGHT,
    StandardIlluminant.D65: StandardIlluminantSeries.SERIES_DAYLIGHT,
    StandardIlluminant.D75: StandardIlluminantSeries.SERIES_DAYLIGHT,
    StandardIlluminant.F1: StandardIlluminantSeries.SERIES_FLUORESCENT,
    StandardIlluminant.F2: StandardIlluminantSeries.SERIES_FLUORESCENT,
    StandardIlluminant.F3: StandardIlluminantSeries.SERIES_FLUORESCENT,
    StandardIlluminant.F4: StandardIlluminantSeries.SERIES_FLUORESCENT,
    StandardIlluminant.F5: StandardIlluminantSeries.SERIES_FLUORESCENT,
}

# EXIF LightSource tag id -> standard illuminant (standard_ill.py:57-70)
LIGHTSOURCE_TO_STANDARD_ILLUMINANT: Dict[int, StandardIlluminant] = {
    12: StandardIlluminant.F1,
    13: StandardIlluminant.F5,
    14: StandardIlluminant.F2,
    15: StandardIlluminant.F3,
    16: StandardIlluminant.F4,
    17: StandardIlluminant.A,
    18: StandardIlluminant.B,
    19: StandardIlluminant.C,
    20: StandardIlluminant.D55,
    21: StandardIlluminant.D65,
    22: StandardIlluminant.D75,
    23: StandardIlluminant.D50,
}


def get_series_from_illuminant(ill: StandardIlluminant) -> StandardIlluminantSeries:
    if ill in STANDARD_ILLUMINANT_TO_SERIES:
        return STANDARD_ILLUMINANT_TO_SERIES[ill]
    raise KeyError(f"Illuminant {ill.name} has no defined series!")


def get_chromaticity_from_illuminant(ill: StandardIlluminant) -> Tuple[float, float]:
    if ill in STANDARD_ILLUMINANT_TO_XY:
        return STANDARD_ILLUMINANT_TO_XY[ill]
    raise KeyError(f"Illuminant {ill.name} has no defined chromaticity value!")


def get_illuminant_from_lightsource(light_id: int) -> StandardIlluminant:
    if light_id in LIGHTSOURCE_TO_STANDARD_ILLUMINANT:
        return LIGHTSOURCE_TO_STANDARD_ILLUMINANT[light_id]
    raise KeyError(
        f"LightSource id {light_id} unimplemented or has no standard illuminant."
    )


def xy_to_xyz(xy: Tuple[float, float]) -> np.ndarray:
    """CIE xy chromaticity -> XYZ tristimulus at Y=1."""
    x, y = float(xy[0]), float(xy[1])
    return np.array([x / y, 1.0, (1.0 - x - y) / y], dtype=np.float64)
