"""DNG/EXIF metadata extraction against the minimal TIFF parser.

Equivalents of the reference's exifread/tifftools-based helpers:
- EV computation             image.py:17-73
- ActiveArea / DefaultCrop   image.py:75-141
- ColorMatrix + illuminants  wb_cct/helpers_exif.py:9-62
- AsShotNeutral              wb_cct/helpers_exif.py:64-87
- OpcodeList3 block          dng_warp_corr/chan_distortion_corr.py:123-146
"""
from __future__ import annotations

from math import log2
from typing import List, Optional, Tuple, Union

import numpy as np

from ..colorimetry.illuminants import (
    get_chromaticity_from_illuminant,
    get_illuminant_from_lightsource,
    get_series_from_illuminant,
    xy_to_xyz,
)
from ..colorimetry.spaces import MatXyzToCamera
from . import tiff as T

Source = Union[str, bytes]


def compute_ev(iso: float, exp_time: float, f_stop: float) -> float:
    """EV = log2(100 * N^2 / (ISO * t)) (image.py:17-29)."""
    return log2((100.0 * f_stop * f_stop) / (iso * exp_time))


def _find_exif_scalar(tf: T.TiffFile, tag: int) -> Optional[float]:
    for ifd in tf.ifds:
        for cand in [ifd] + ifd.sub_ifds + ([ifd.exif_ifd] if ifd.exif_ifd else []):
            t = cand.get(tag)
            if t is not None:
                vals = t.as_floats()
                if vals:
                    return vals[0]
    return None


def compute_ev_from_tiff(source: Source) -> float:
    """EV from embedded EXIF; inf if unreadable (image.py:31-73).

    Includes the reference's Panasonic quirk: when ISOSpeedRatings is absent and
    Make is Panasonic, ISO lives in maker tag 0x0017 (image.py:68-70)."""
    try:
        tf = T.read_tiff(source)
    except Exception:
        return float(np.inf)

    exp_time = _find_exif_scalar(tf, T.TAG_EXPOSURE_TIME)
    f_stop = _find_exif_scalar(tf, T.TAG_F_NUMBER)
    iso = _find_exif_scalar(tf, T.TAG_ISO_SPEED)

    if not iso and tf.ifds:
        make_tag = tf.ifds[0].get(T.TAG_MAKE)
        if make_tag is not None and b"Panasonic" in make_tag.as_bytes():
            pana = tf.ifds[0].get(0x0017)
            if pana is not None and pana.as_floats():
                iso = pana.as_floats()[0]

    return compute_ev(
        iso if iso else 100.0,
        exp_time if exp_time else 1.0,
        f_stop if f_stop else 1.0,
    )


def get_image_area_from_tiff(
    source: Source,
) -> Tuple[Optional[List[int]], Optional[Tuple[List[int], List[int]]]]:
    """(ActiveArea, (CropStart, CropLen)) from the raw IFD; Nones when absent
    (image.py:75-141)."""
    try:
        tf = T.read_tiff(source)
    except Exception:
        return (None, None)

    raw = tf.find_raw_ifd()
    if raw is None:
        return (None, None)

    aa = raw.get(T.TAG_ACTIVE_AREA)
    active = aa.as_ints() if aa is not None else None

    co = raw.get(T.TAG_DEFAULT_CROP_ORIGIN)
    cs = raw.get(T.TAG_DEFAULT_CROP_SIZE)
    if co is None or cs is None:
        return (active, None)
    return (active, (co.as_ints(), cs.as_ints()))


def exif_get_color_mat_sources(tf_or_ifd) -> List[MatXyzToCamera]:
    """DNG ColorMatrix1..3 + CalibrationIlluminant1..3 -> camera matrices
    (helpers_exif.py:9-62). Stops at the first missing pair."""
    ifd0 = tf_or_ifd.ifds[0] if isinstance(tf_or_ifd, T.TiffFile) else tf_or_ifd

    out: List[MatXyzToCamera] = []
    for idx in range(3):
        t_mat = ifd0.get(T.TAG_COLOR_MATRIX_1 + idx)
        t_ill = ifd0.get(T.TAG_CALIBRATION_ILLUMINANT_1 + idx)
        if t_mat is None or t_ill is None:
            break
        try:
            ill = get_illuminant_from_lightsource(t_ill.as_ints()[0])
            xy = get_chromaticity_from_illuminant(ill)
            series = get_series_from_illuminant(ill)
        except KeyError:
            break
        mat = np.array(t_mat.as_floats(), np.float64).reshape(3, 3)
        out.append(MatXyzToCamera(mat, xy_to_xyz(xy), series))
    return out


def exif_get_as_shot_neutral(tf_or_ifd) -> np.ndarray:
    """AsShotNeutral multipliers (helpers_exif.py:64-87)."""
    ifd0 = tf_or_ifd.ifds[0] if isinstance(tf_or_ifd, T.TiffFile) else tf_or_ifd
    t = ifd0.get(T.TAG_AS_SHOT_NEUTRAL)
    if t is None:
        raise KeyError("AsShotNeutral missing inside tags!")
    vals = t.as_floats()
    if len(vals) < 3:
        raise KeyError("AsShotNeutral missing inside tags!")
    return np.array(vals[:3], np.float64)


def get_opcode_block(source: Source, which: int = 3) -> Optional[bytes]:
    """OpcodeList{1,2,3} data block from the raw IFD (chan_distortion_corr.py:123-146;
    lists 1/2 are additive — the reference reads only list 3)."""
    tag = {1: T.TAG_OPCODE_LIST_1, 2: T.TAG_OPCODE_LIST_2, 3: T.TAG_OPCODE_LIST_3}[which]
    try:
        tf = T.read_tiff(source)
    except Exception:
        return None
    raw = tf.find_raw_ifd()
    if raw is None:
        return None
    t = raw.get(tag)
    if t is None:
        return None
    return t.as_bytes()


def get_opcode_3_block(source: Source) -> Optional[bytes]:
    """OpcodeList3 data block from the raw IFD (chan_distortion_corr.py:123-146)."""
    return get_opcode_block(source, 3)
