"""Raw file -> RawFrame: the host-side DNG decode path.

Counterpart of ``pysp_tpu/io/raw_loader.py`` for uncompressed DNGs: decode the
CFA data with the built-in TIFF parser, read per-channel black/white levels,
normalize, decode and validate the 2x2 CFA pattern, apply DNG ActiveArea and
DefaultCrop with CFA-alignment checks, build the WB controller from the embedded
calibration matrices, compute EV, and canonicalize the mosaic to RGGB.

The DNG's OpcodeList1 (FixBadPixelsConstant / FixBadPixelsList: the listed
photosites healed) and OpcodeList2 (GainMap / FixVignetteRadial: the shading
gains) apply to the normalized mosaic before the ActiveArea and the crop, on
the load device, as in the JAX package.

``controller_for_source`` rebuilds a decoded frame's WB controller, for WB
from a colour temperature (``frame_from_parts`` then builds the frame anew).

Not ported yet (ROADMAP.md queue A, items A3, A5 and A6): lossless-JPEG DNGs,
the persistent camera-matrix harvest and every non-DNG format.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..colorimetry.wb import CameraWhiteBalanceController
from ..const import BayerPattern
from ..core.bayer import reversible_transform_rggb
from ..core.device import CARD, resolve_device
from ..core.frame import RawFrame
from . import tiff as T
from .metadata import (
    compute_ev_from_tiff,
    exif_get_as_shot_neutral,
    exif_get_color_mat_sources,
    get_image_area_from_tiff,
)

Source = Union[str, bytes]

_CFA_CODE_TO_CHAR = {0: "R", 1: "G", 2: "B"}

_PATTERN_FROM_STRING = {
    "RGGB": BayerPattern.Rggb,
    "BGGR": BayerPattern.Bggr,
    "GRBG": BayerPattern.Grbg,
    "GBRG": BayerPattern.Gbrg,
}


def _normalize_host(
    bayer: np.ndarray, chan_black: np.ndarray, chan_sat: np.ndarray
) -> np.ndarray:
    """Per-CFA-site black subtraction and white scaling to [0, 1] (float32)."""
    out = np.empty(bayer.shape, np.float32)
    for (dy, dx), idx in (((0, 0), 0), ((0, 1), 1), ((1, 1), 2), ((1, 0), 3)):
        plane = bayer[dy::2, dx::2].astype(np.float32)
        out[dy::2, dx::2] = (
            np.clip(plane - chan_black[idx], 0, chan_sat[idx]) / chan_sat[idx]
        )
    return out


def _decode_pattern(cfa_codes) -> BayerPattern:
    try:
        s = "".join(_CFA_CODE_TO_CHAR[int(c)] for c in cfa_codes)
    except KeyError as e:
        raise ValueError(f"Raw has unsupported colors in CFA: {cfa_codes}") from e
    if s not in _PATTERN_FROM_STRING:
        raise NotImplementedError(f"Bayer pattern {s} is not supported!")
    return _PATTERN_FROM_STRING[s]


def _apply_area_and_crop(
    sensor,
    active_area: Optional[list],
    crop: Optional[Tuple[list, list]],
):
    """ActiveArea then DefaultCrop of a mosaic (an array or a tensor), with
    CFA-alignment guards."""
    if active_area is not None:
        # DNG ActiveArea: top, left, bottom, right, treated as inclusive indices
        y_start, x_start = active_area[0], active_area[1]
        y_end, x_end = active_area[2] + 1, active_area[3] + 1
        x_start = int(np.clip(x_start, 0, sensor.shape[1]))
        x_end = int(np.clip(x_end, 0, sensor.shape[1]))
        y_start = int(np.clip(y_start, 0, sensor.shape[0]))
        y_end = int(np.clip(y_end, 0, sensor.shape[0]))
        sensor = sensor[y_start:y_end, x_start:x_end]

    if crop is not None:
        (start_x, start_y), (len_x, len_y) = (
            (crop[0][0], crop[0][1]),
            (crop[1][0], crop[1][1]),
        )
        if start_x % 2 != 0 or start_y % 2 != 0:
            raise NotImplementedError(
                "Sensor crop start would modify CFA pattern order. Not implemented!"
            )
        if len_x % 2 != 0 or len_y % 2 != 0:
            raise NotImplementedError(
                "Sensor crop length would cut the CFA array. Not implemented!"
            )
        r_s_x = int(np.clip(start_x, 0, sensor.shape[1] - 1))
        r_s_y = int(np.clip(start_y, 0, sensor.shape[0] - 1))
        r_e_x = int(np.clip(r_s_x + len_x, r_s_x + 1, sensor.shape[1]))
        r_e_y = int(np.clip(r_s_y + len_y, r_s_y + 1, sensor.shape[0]))
        sensor = sensor[r_s_y:r_e_y, r_s_x:r_e_x]

    return sensor


def _black_white_levels(raw_ifd: T.Ifd, n: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    black_tag = raw_ifd.get(T.TAG_BLACK_LEVEL)
    white_tag = raw_ifd.get(T.TAG_WHITE_LEVEL)
    black = np.zeros(n) if black_tag is None else np.asarray(black_tag.as_floats())
    white = (
        np.full(n, 65535.0) if white_tag is None else np.asarray(white_tag.as_floats())
    )
    if black.size == 1:
        black = np.full(n, float(black.reshape(())))
    if white.size == 1:
        white = np.full(n, float(white.reshape(())))
    return black[:n].astype(np.float64), white[:n].astype(np.float64)


def load_raw_dng(source: Source, apply_gain_opcodes: bool = True, device=CARD) -> RawFrame:
    """Load an uncompressed DNG through the built-in parser onto ``device``
    (the card unless the caller asks for another; see ``core.device``).

    With ``apply_gain_opcodes`` (the JAX package's switch, for both lists) the
    OpcodeList1 bad pixels are healed on the normalized mosaic, matched for
    FixBadPixelsConstant on the stored counts after the linearization table,
    and then the OpcodeList2 gains are applied, both on ``device`` and before
    the ActiveArea and the crop."""
    device = resolve_device(device)
    tf = T.read_tiff(source)
    raw_ifd = tf.find_raw_ifd()
    if raw_ifd is None:
        raise ValueError("Raw couldn't be read! No CFA IFD found")

    cfa = raw_ifd.get(T.TAG_CFA_PATTERN)
    if cfa is None:
        raise ValueError("Raw has no CFA pattern, cannot continue!")
    dims = raw_ifd.get(T.TAG_CFA_REPEAT_PATTERN_DIM)
    if dims is not None and tuple(dims.as_ints()) != (2, 2):
        raise ValueError("Raw has unsupported Bayer pattern, cannot continue!")
    pattern = _decode_pattern(
        list(cfa.as_bytes() if isinstance(cfa.values, bytes) else cfa.as_ints())[:4]
    )

    data = tf.read_strips(raw_ifd)
    lin = raw_ifd.get(T.TAG_LINEARIZATION_TABLE)
    if lin is not None:
        # DNG LinearizationTable: LUT applied to stored values before black/white
        table = np.asarray(lin.as_ints(), np.uint16)
        data = table[np.minimum(data, len(table) - 1)]
    black, white = _black_white_levels(raw_ifd)
    sensor = torch.from_numpy(_normalize_host(data, black, white)).to(device)

    if apply_gain_opcodes:
        t1 = raw_ifd.get(T.TAG_OPCODE_LIST_1)
        if t1 is not None:
            from ..warp.fix_opcodes import heal_bad_pixels_from_opcodes

            sensor = heal_bad_pixels_from_opcodes(sensor, data, t1.as_bytes())
        t2 = raw_ifd.get(T.TAG_OPCODE_LIST_2)
        if t2 is not None:
            from ..warp.gain_opcodes import apply_gain_opcodes as _apply_gains

            sensor = _apply_gains(sensor, t2.as_bytes())

    active_area, crop = get_image_area_from_tiff(source)
    sensor = _apply_area_and_crop(sensor, active_area, crop)

    mats = exif_get_color_mat_sources(tf)
    if len(mats) == 0:
        raise KeyError(
            "EXIF ColorMatrix tags or illuminant tags missing, could not create "
            "white balance controller!"
        )
    neutral = exif_get_as_shot_neutral(tf)
    cam_wb = CameraWhiteBalanceController(mats, neutral)

    ev = compute_ev_from_tiff(source)
    if not np.isfinite(ev):
        raise ValueError("Error reading exposure value from raw!")

    return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)


def frame_from_parts(
    sensor_scaled,
    pattern: BayerPattern,
    cam_wb: CameraWhiteBalanceController,
    ev: float,
    lim_sat: float = 1.0,
    is_hdr: bool = False,
    device=CARD,
) -> RawFrame:
    """Assemble a canonical-RGGB RawFrame on ``device`` (the card unless the
    caller asks for another) from decoded parts; ``sensor_scaled`` is a NumPy
    array or a tensor (the loader's, already on ``device``)."""
    device = resolve_device(device)
    sensor = torch.as_tensor(sensor_scaled, dtype=torch.float32).to(device)
    canonical = reversible_transform_rggb(sensor, pattern)
    mat = cam_wb.get_matrix()
    return RawFrame.from_numpy(
        canonical,
        mat.mat,
        mat.xyz,
        cam_wb.get_neutral(),
        ev,
        lim_sat,
        is_hdr=is_hdr,
        source_pattern=pattern,
        device=device,
    )


def controller_for_source(source: Source, frame: RawFrame) -> CameraWhiteBalanceController:
    """Rebuild a WB controller for a decoded frame so ``update_by_*`` calls work
    (counterpart of ``pysp_tpu/io/raw_loader.py``'s).

    A DNG carries its calibration matrices in EXIF (ColorMatrix1/2/3) and its
    as-shot neutral: the controller is built from them. Without EXIF matrices
    (a non-TIFF container, or a TIFF without them) it falls through to the
    single matrix the frame already holds, with the frame's neutral. The JAX
    package first looks the EXIF model up in its camera-matrix registry there;
    the port has no registry yet (ROADMAP.md queue A, item A5: the
    camera-matrix registry and autoharvest)."""
    import struct

    from ..colorimetry.illuminants import StandardIlluminantSeries
    from ..colorimetry.spaces import MatXyzToCamera

    try:
        tf = T.read_tiff(source)
        mats = exif_get_color_mat_sources(tf)
    except (ValueError, struct.error):
        # non-TIFF containers carry no EXIF color matrices at all
        tf, mats = None, []
    if mats:
        neutral = exif_get_as_shot_neutral(tf)
    else:
        mats = [
            MatXyzToCamera(
                frame.cam_mat.cpu().numpy().astype(np.float64),
                frame.cam_white.cpu().numpy().astype(np.float64),
                StandardIlluminantSeries.SERIES_DAYLIGHT,
            )
        ]
        neutral = frame.wb_neutral.cpu().numpy().astype(np.float64)
    return CameraWhiteBalanceController(mats, neutral)


def _is_dng(source: Source) -> bool:
    if isinstance(source, str):
        with open(source, "rb") as f:
            head = f.read(4)
    else:
        head = bytes(source[:4])
    if head not in (b"II*\x00", b"MM\x00*"):
        return False
    ifds = T.read_tiff(source).ifds
    return bool(ifds) and ifds[0].get(T.TAG_DNG_VERSION) is not None


def load_raw(source: Source, device=CARD) -> RawFrame:
    """Load a raw file onto ``device``: the card unless the caller asks for
    another, such as ``device="cpu"``. Without a GPU the default raises. Only
    DNGs are ported: any other format raises ``NotImplementedError``."""
    device = resolve_device(device)
    if not _is_dng(source):
        raise NotImplementedError(
            "pysp_tpu_torch decodes DNG only; the other raw formats are not "
            "ported yet (ROADMAP.md queue A, item A6: the other-format decoders)"
        )
    return load_raw_dng(source, device=device)
