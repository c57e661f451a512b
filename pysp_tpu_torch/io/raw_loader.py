"""Raw file -> RawFrame: the host-side decode path (L0).

Counterpart of ``pysp_tpu/io/raw_loader.py``: decode the CFA data (DNGs with
the built-in TIFF parser, uncompressed or lossless JPEG; CR2, MRW, RAF, ARW,
ORF, RW2, PEF, SRW and NEF with their modules in ``io/``; anything else through
rawpy/libraw where it imports), read per-channel black/white levels,
normalize, decode and validate the 2x2 CFA pattern, apply DNG ActiveArea and
DefaultCrop with CFA-alignment checks, build the WB controller from the
embedded calibration matrices (or the camera-matrix registry), compute EV, and
canonicalize the mosaic to RGGB on the load device.

The DNG's OpcodeList1 (FixBadPixelsConstant / FixBadPixelsList: the listed
photosites healed) and OpcodeList2 (GainMap / FixVignetteRadial: the shading
gains) apply to the normalized mosaic before the ActiveArea and the crop, on
the load device, as in the JAX package.

``controller_for_source`` rebuilds a decoded frame's WB controller, for WB
from a colour temperature (``frame_from_parts`` then builds the frame anew).

A dual-illuminant DNG's calibration rows are harvested into the persistent
camera-matrix registry as a side effect of its load (``io/camera_matrices.py``),
as in the JAX package.
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
from ..utils.tracing import span
from . import tiff as T
from .tiff import check_decode_dims  # noqa: F401  (format modules import it here)
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
    """Load a DNG through the built-in parser onto ``device``
    (the card unless the caller asks for another; see ``core.device``).

    With ``apply_gain_opcodes`` (the JAX package's switch, for both lists) the
    OpcodeList1 bad pixels are healed on the normalized mosaic, matched for
    FixBadPixelsConstant on the stored counts after the linearization table,
    and then the OpcodeList2 gains are applied, both on ``device`` and before
    the ActiveArea and the crop.

    Its spans: ``io.read`` (each read of the file), ``io.decode_strips``,
    ``io.normalize`` (linearization, black and white levels, the copy to
    ``device``, the opcode lists) and ``io.metadata`` (area and crop, the
    colour matrices, their harvest, the WB controller, the EV and the frame's
    assembly)."""
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
    with span("io.normalize"):
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

    with span("io.metadata"):
        active_area, crop = get_image_area_from_tiff(source)
        sensor = _apply_area_and_crop(sensor, active_area, crop)

        mats = exif_get_color_mat_sources(tf)
        if len(mats) == 0:
            raise KeyError(
                "EXIF ColorMatrix tags or illuminant tags missing, could not create "
                "white balance controller!"
            )
        # first-contact upgrade: any dual-illuminant DNG donates its body's REAL
        # calibration rows to the persistent registry, so native-format loads
        # (CR2/NEF/...) of the same body stop using estimated StdA matrices
        from .camera_matrices import autoharvest_from_tiff

        autoharvest_from_tiff(
            tf, mats, source_name=source if isinstance(source, str) else None
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

    DNGs carry their calibration matrices in EXIF (ColorMatrix1/2/3); MakerNote
    formats (CR2/NEF/ARW/RW2) embed none, so the controller re-resolves the
    per-model registry (dual-illuminant rows when available: estimated StdA +
    D65, or harvested Adobe data) and only then falls back to the single matrix
    the loader already resolved, with the frame's as-shot neutral.
    """
    import struct

    from .camera_matrices import lookup_camera_matrices

    try:
        tf = T.read_tiff(source)
        mats = exif_get_color_mat_sources(tf)
    except (ValueError, struct.error):
        # non-TIFF containers (RAF) carry no EXIF color matrices at all
        tf, mats = None, []
    if mats:
        neutral = exif_get_as_shot_neutral(tf)
    elif tf is not None and tf.ifds:
        # no EXIF matrices: registry by EXIF model (dual rows when known)
        model_tag = tf.ifds[0].get(T.TAG_MODEL)
        if model_tag is not None:
            model = model_tag.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
            mats = lookup_camera_matrices(model) or []
            neutral = _host64(frame.wb_neutral)
    if not mats:
        from ..colorimetry.illuminants import StandardIlluminantSeries
        from ..colorimetry.spaces import MatXyzToCamera

        mats = [
            MatXyzToCamera(
                _host64(frame.cam_mat),
                _host64(frame.cam_white),
                StandardIlluminantSeries.SERIES_DAYLIGHT,
            )
        ]
        neutral = _host64(frame.wb_neutral)
    return CameraWhiteBalanceController(mats, neutral)


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def load_raw(source: Source, device=CARD) -> RawFrame:
    """Load any supported raw onto ``device`` (the card unless the caller asks
    for another, such as ``device="cpu"``; without a GPU the default raises):
    the built-in DNG/CR2/NEF/ARW/RW2/ORF/RAF/PEF/MRW/SRW decoders, then rawpy,
    in the JAX package's order."""
    device = resolve_device(device)
    from .cr2 import is_cr2, load_raw_cr2

    if is_cr2(source):
        return load_raw_cr2(source, device=device)

    from .mrw import is_mrw, load_raw_mrw

    if is_mrw(source):
        return load_raw_mrw(source, device=device)

    from .cr3 import is_cr3, load_raw_cr3_rawpy

    if is_cr3(source):
        # CRX decode has no built-in path: pixels via libraw (the reference's
        # own route), metadata from the container's CMT blocks
        return load_raw_cr3_rawpy(source, device=device)

    from .raf import is_raf, load_raw_raf

    if is_raf(source):
        # X-Trans / Super-CCD layouts fall through to rawpy below
        try:
            return load_raw_raf(source, device=device)
        except ValueError as e:
            if "not supported" not in str(e):
                raise

    from .arw import is_arw, load_raw_arw

    if is_arw(source):
        # Sony lossless (compression 7) falls through to rawpy below
        try:
            return load_raw_arw(source, device=device)
        except ValueError as e:
            if "unsupported compression" not in str(e):
                raise

    from .orf import is_orf, load_raw_orf

    if is_orf(source):
        return load_raw_orf(source, device=device)

    from .rw2 import is_rw2, load_raw_rw2

    if is_rw2(source):
        # v5+ payloads (unsupported RawFormat) fall through to rawpy below
        try:
            return load_raw_rw2(source, device=device)
        except ValueError as e:
            if "unsupported RawFormat" not in str(e):
                raise

    from .pef import is_pef, load_raw_pef

    if is_pef(source):
        return load_raw_pef(source, device=device)

    from .srw import is_srw, load_raw_srw

    if is_srw(source):
        # samsung2/3 generations (other compression values) fall through to rawpy
        try:
            return load_raw_srw(source, device=device)
        except ValueError as e:
            if "unsupported compression" not in str(e):
                raise

    try:
        return load_raw_dng(source, device=device)
    except (ValueError, KeyError, NotImplementedError):
        pass

    from .nef import is_nef, load_raw_nef

    if is_nef(source):
        return load_raw_nef(source, device=device)

    try:
        import rawpy  # type: ignore  # noqa: F401
    except ImportError as e:
        raise ValueError(
            "Raw couldn't be read by the built-in DNG/CR2/NEF/ARW/RW2/ORF/RAF/PEF/"
            "MRW/SRW decoders and rawpy is not installed for other formats."
        ) from e

    return load_raw_rawpy(source, device=device)


def load_raw_rawpy(source: Source, strict: bool = True, device=CARD) -> RawFrame:
    """Decode via rawpy/libraw only: the reference's own decode route,
    bypassing every built-in codec.

    ``strict=True`` (the load_raw fall-through contract) requires EXIF color
    matrices + EV from the TIFF container. ``strict=False`` (the verify-decode
    cross-check path) degrades gracefully for containers libraw reads but the
    TIFF metadata layer cannot: color matrices fall back to the per-model
    registry / Rec.709, the neutral to libraw's camera_whitebalance, EV to 0.
    """
    import rawpy  # type: ignore

    from io import BytesIO

    reader = source if isinstance(source, str) else BytesIO(source)
    with rawpy.imread(reader) as raw:
        chan_sat = np.asarray(raw.camera_white_level_per_channel, np.float64)
        chan_black = np.asarray(raw.black_level_per_channel, np.float64)
        sensor = _normalize_host(raw.raw_image, chan_black, chan_sat)
        if raw.raw_pattern.shape != (2, 2):
            raise ValueError("Raw has unsupported Bayer pattern, cannot continue!")
        desc = raw.color_desc.decode("ascii")
        pattern_str = "".join(desc[i] for i in raw.raw_pattern.flatten())
        pattern = _PATTERN_FROM_STRING[pattern_str.upper()]
        cam_mult = getattr(raw, "camera_whitebalance", None)

    if strict:
        tf_area = get_image_area_from_tiff(source)
        sensor = _apply_area_and_crop(sensor, tf_area[0], tf_area[1])
        tf = T.read_tiff(source)
        mats = exif_get_color_mat_sources(tf)
        neutral = exif_get_as_shot_neutral(tf)
        cam_wb = CameraWhiteBalanceController(mats, neutral)
        ev = compute_ev_from_tiff(source)
        return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)

    import struct as _struct

    try:
        tf_area = get_image_area_from_tiff(source)
        sensor = _apply_area_and_crop(sensor, tf_area[0], tf_area[1])
    except (ValueError, _struct.error):
        pass
    mats, neutral, model = [], None, None
    try:
        tf = T.read_tiff(source)
        mats = exif_get_color_mat_sources(tf)
        if mats:
            neutral = exif_get_as_shot_neutral(tf)
        model_tag = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
        if model_tag is not None:
            model = model_tag.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
    except (ValueError, _struct.error):
        pass
    if not mats:
        from .camera_matrices import resolve_camera_matrices

        mats = resolve_camera_matrices(model)
    if neutral is None:
        if cam_mult is not None and np.all(np.asarray(cam_mult[:3], float) > 0):
            m = np.asarray(cam_mult[:3], np.float64)
            neutral = m[1] / m  # gains -> camera response to neutral, G=1
        else:
            neutral = np.array([0.5, 1.0, 0.5], np.float64)
    cam_wb = CameraWhiteBalanceController(mats, neutral)
    try:
        ev = compute_ev_from_tiff(source)
    except (ValueError, _struct.error):
        ev = float("nan")
    if not np.isfinite(ev):
        ev = 0.0
    return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)


def load_burst(sources, max_workers: int = 8, device=CARD) -> RawFrame:
    """Load a burst of raw files concurrently into one batched RawFrame on
    ``device`` (the card unless the caller asks for another).

    The files decode on the host in a thread pool; all frames must share
    sensor shape and CFA pattern. The burst is stacked on the host and copied
    to ``device`` once, every tensor with a leading frame axis: ready for
    ``develop_burst`` and ``develop_pipeline``."""
    from concurrent.futures import ThreadPoolExecutor

    from ..core.frame import stack_frames

    if len(sources) == 0:
        raise ValueError("load_burst needs at least one source")
    device = resolve_device(device)

    def load_on_host(source):
        return load_raw(source, device="cpu")

    with ThreadPoolExecutor(max_workers=min(max_workers, len(sources))) as pool:
        frames = list(pool.map(load_on_host, sources))

    shapes = {tuple(f.bayer.shape) for f in frames}
    patterns = {f.source_pattern for f in frames}
    if len(shapes) != 1 or len(patterns) != 1:
        raise ValueError(
            f"burst frames disagree: shapes={shapes}, patterns={patterns}"
        )
    return stack_frames(frames, device="cpu").to(device)
