"""Minolta MRW host-side decode — no libraw.

Ninth built-in raw format; the reference opens MRW through libraw
(reference/image.py:224). MRW is the simplest real camera container
still missing here: a big-endian block directory wrapped around an embedded
TIFF (EXIF) and a plain CFA strip. Layout (published MRW format notes
(D. Jelinek's widely-mirrored spec) + dcraw ``parse_minolta`` semantics,
reimplemented; all directory integers BIG-endian):

- 0x00: magic ``\\x00MRM``, u32 header length; the raw strip starts at
  ``8 + header_length``.
- Blocks from 0x08: 4-byte id (``\\x00PRD``, ``\\x00TTW``, ``\\x00WBG``,
  ``\\x00RIF``, ``\\x00PAD``), u32 length, payload.
- PRD (picture raw dimensions): 8-byte version string; u16 ccdSizeY/X
  (the stored strip dims — dcraw reads exactly these two after the 8-byte
  skip); u16 imgSizeY/X (the intended output crop); u8 dataSize (stored
  bits), u8 pixelSize (significant bits, 12), u8 storageMethod
  (0x52 = unpacked, one big-endian u16 per photosite; 0x59 = packed,
  12-bit big-endian MSB-first, 2 photosites per 3 bytes), u8 pad,
  u16 pad, u16 bayerPattern (0x0001 = RGGB, 0x0004 = GBRG).
- WBG (white-balance gains): 4 u8 denominator exponents (denominator =
  ``64 << x``) then 4 u16 gains in CFA reading order (TL, TR, BL, BR) —
  dcraw reads them straight into ``cam_mul[c ^ (c >> 1)]``, i.e. R, G1,
  G2, B for the RGGB bodies.
- TTW ("TIFF the world"?): a complete embedded TIFF holding the EXIF
  block (exposure/F-number/ISO for EV, Make/Model for the color-matrix
  registry). Offsets inside it are relative to the TTW payload start.
- RIF: JPEG-development settings (saturation/contrast/ISO byte); unused
  here — EV comes from the TTW EXIF like every other loader.

Black level: MRW metadata carries none (dcraw uses 0 for these bodies);
stored values normalize against ``2**pixelSize - 1``. DIVERGENCES.md
records the imgSize crop policy (top-left, even-aligned).
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..core.device import CARD
from ..core.frame import RawFrame
from . import tiff as T
from .camera_matrices import resolve_camera_matrices

Source = Union[str, bytes]

MRW_MAGIC = b"\x00MRM"
BLOCK_PRD = b"\x00PRD"
BLOCK_TTW = b"\x00TTW"
BLOCK_WBG = b"\x00WBG"
BLOCK_RIF = b"\x00RIF"

STORAGE_UNPACKED = 0x52
STORAGE_PACKED = 0x59

_PATTERN_CODES = {0x0001: "RGGB", 0x0004: "GBRG"}


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_mrw(source: Source) -> bool:
    """MRW: the 4-byte \\x00MRM magic."""
    if isinstance(source, str):
        # probe only the magic — load_raw calls this on every input
        with open(source, "rb") as f:
            head = f.read(4)
    else:
        head = bytes(source[:4])
    return head == MRW_MAGIC


def _parse_blocks(data: bytes) -> Tuple[Dict[bytes, bytes], int]:
    """Directory blocks -> ({id: payload}, raw data offset)."""
    if data[:4] != MRW_MAGIC or len(data) < 8:
        raise ValueError("MRW: bad magic")
    (hdr_len,) = struct.unpack_from(">L", data, 4)
    raw_off = 8 + hdr_len
    if raw_off > len(data):
        raise ValueError("MRW: header length overruns the file")
    blocks: Dict[bytes, bytes] = {}
    pos = 8
    while pos + 8 <= raw_off:
        bid = data[pos : pos + 4]
        (ln,) = struct.unpack_from(">L", data, pos + 4)
        payload_end = pos + 8 + ln
        if payload_end > raw_off:
            raise ValueError(f"MRW: block {bid!r} overruns the header")
        blocks[bid] = data[pos + 8 : payload_end]
        pos = payload_end
    return blocks, raw_off


class _Prd:
    def __init__(self, payload: bytes):
        if len(payload) < 24:
            raise ValueError("MRW: PRD block too short")
        self.version = payload[:8]
        (self.ccd_h, self.ccd_w, self.img_h, self.img_w) = struct.unpack_from(
            ">4H", payload, 8
        )
        self.data_size = payload[16]
        self.pixel_size = payload[17]
        self.storage = payload[18]
        (self.pattern_code,) = struct.unpack_from(">H", payload, 22)


def _decode_strip(data: bytes, off: int, prd: _Prd) -> np.ndarray:
    n = prd.ccd_h * prd.ccd_w
    if prd.storage == STORAGE_PACKED:
        need = (n * 12 + 7) // 8
        if off + need > len(data):
            raise ValueError("MRW: packed strip truncated")
        vals = T._unpack_bits(data[off : off + need], 12, n)
    elif prd.storage == STORAGE_UNPACKED:
        if off + 2 * n > len(data):
            raise ValueError("MRW: unpacked strip truncated")
        vals = np.frombuffer(data, ">u2", n, off).astype(np.uint16)
    else:
        raise ValueError(f"MRW: unsupported storage method 0x{prd.storage:02x}")
    return np.asarray(vals, np.uint16).reshape(prd.ccd_h, prd.ccd_w)


def _wb_neutral(wbg: Optional[bytes], pattern_str: str) -> np.ndarray:
    """WBG gains (CFA reading order, per-gain denominators) -> RGB neutral."""
    if wbg is None or len(wbg) < 12:
        return np.array([0.5, 1.0, 0.5], np.float64)
    denoms = [float(64 << b) for b in wbg[:4]]
    gains = struct.unpack_from(">4H", wbg, 4)
    by_chan: Dict[str, list] = {"R": [], "G": [], "B": []}
    for ch, g, d in zip(pattern_str, gains, denoms):
        if g > 0:
            by_chan[ch].append(g / d)
    if not (by_chan["R"] and by_chan["G"] and by_chan["B"]):
        return np.array([0.5, 1.0, 0.5], np.float64)
    g_r = float(np.mean(by_chan["R"]))
    g_g = float(np.mean(by_chan["G"]))
    g_b = float(np.mean(by_chan["B"]))
    # gains multiply channels toward neutral, so the as-shot neutral is 1/gain
    return np.array([g_g / g_r, 1.0, g_g / g_b], np.float64)


def load_raw_mrw(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode an MRW into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import (
        _normalize_host,
        _PATTERN_FROM_STRING,
        check_decode_dims,
        frame_from_parts,
    )

    data = _read_source(source)
    blocks, raw_off = _parse_blocks(data)
    prd_blob = blocks.get(BLOCK_PRD)
    if prd_blob is None:
        raise ValueError("MRW: missing PRD block")
    prd = _Prd(prd_blob)

    check_decode_dims(prd.ccd_h, prd.ccd_w)

    pattern_str = _PATTERN_CODES.get(prd.pattern_code)
    if pattern_str is None:
        raise ValueError(f"MRW: unsupported Bayer pattern code 0x{prd.pattern_code:04x}")
    pattern = _PATTERN_FROM_STRING[pattern_str]

    raw = _decode_strip(data, raw_off, prd)

    # Crop to the intended output size (top-left, even-aligned so the CFA
    # phase is preserved; margins beyond imgSize are calibration borders)
    crop_h = min(prd.img_h & ~1 or prd.ccd_h, prd.ccd_h)
    crop_w = min(prd.img_w & ~1 or prd.ccd_w, prd.ccd_w)
    raw = raw[: crop_h & ~1, : crop_w & ~1]

    if not (1 <= prd.pixel_size <= 16):
        raise ValueError(f"MRW: bad pixel size {prd.pixel_size}")
    white = float((1 << prd.pixel_size) - 1)
    sensor = _normalize_host(raw, np.zeros(4), np.full(4, white))

    neutral = _wb_neutral(blocks.get(BLOCK_WBG), pattern_str)

    ttw = blocks.get(BLOCK_TTW)
    if ttw is None:
        raise ValueError("MRW: missing TTW (EXIF) block")
    ev = compute_ev_from_tiff(ttw)
    if not np.isfinite(ev):
        raise ValueError("Error reading exposure value from raw!")

    if color_mats is None:
        model = None
        try:
            tf = T.read_tiff(ttw)
            model_tag = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
            if model_tag is not None:
                model = (
                    model_tag.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
                )
        except (ValueError, struct.error):
            pass
        color_mats = resolve_camera_matrices(model)

    cam_wb = CameraWhiteBalanceController(color_mats, neutral)
    return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)


# --- synthetic fixture writer -----------------------------------------------------------
def write_synthetic_mrw(
    stored: np.ndarray,
    model: bytes = b"DYNAX SYNTH",
    storage: int = STORAGE_PACKED,
    pattern_code: int = 0x0001,
    wb_gains: Tuple[int, int, int, int] = (359, 256, 256, 736),
    wb_denom_exp: Tuple[int, int, int, int] = (2, 2, 2, 2),
    img_dims: Optional[Tuple[int, int]] = None,
    pixel_size: int = 12,
) -> bytes:
    """Assemble a structurally faithful MRW test fixture.

    ``stored`` is the (ccdH, ccdW) uint16 mosaic; ``wb_gains`` are in CFA
    reading order with per-gain denominators ``64 << wb_denom_exp``.
    """
    h, w = stored.shape
    assert h % 2 == 0 and w % 2 == 0
    img_h, img_w = img_dims if img_dims is not None else (h, w)
    E = "<"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    # --- embedded TTW TIFF (own address space) ---
    make_b = b"KONICA MINOLTA\x00"
    model_b = model + b"\x00"
    n0, nexif = 3, 3
    off_ifd0 = 8
    off_exif = off_ifd0 + sz(n0)
    off_heap = off_exif + sz(nexif)
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b + (b"\x00" if len(make_b) % 2 else b"")
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 200)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 28, 10)

    tif = struct.pack(E + "2sHL", b"II", 42, off_ifd0)
    tif += struct.pack(E + "H", n0)
    tif += entry(T.TAG_MAKE, T.TYPE_ASCII, len(make_b), struct.pack(E + "L", off_make))
    tif += entry(
        T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack(E + "L", off_model)
    )
    tif += entry(T.TAG_EXIF_IFD, T.TYPE_LONG, 1, struct.pack(E + "L", off_exif))
    tif += struct.pack(E + "L", 0)
    tif += struct.pack(E + "H", nexif)
    tif += entry(
        T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp)
    )
    tif += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    tif += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 100))
    tif += struct.pack(E + "L", 0)
    tif += heap

    # --- PRD / WBG / RIF blocks (big-endian) ---
    prd = b"21810002"
    prd += struct.pack(">4H", h, w, img_h, img_w)
    data_size = 12 if storage == STORAGE_PACKED else 16
    prd += struct.pack(">4B", data_size, pixel_size, storage, 0)
    prd += struct.pack(">HH", 0, pattern_code)

    wbg = bytes(wb_denom_exp) + struct.pack(">4H", *wb_gains)
    rif = bytes([0, 5, 5, 5, 0, 0, 24, 0])

    if storage == STORAGE_PACKED:
        strip = T._pack_bits(np.asarray(stored, np.uint16).reshape(-1), 12)
    else:
        strip = np.asarray(stored, ">u2").tobytes()

    body = b""
    for bid, payload in (
        (BLOCK_PRD, prd),
        (BLOCK_WBG, wbg),
        (BLOCK_RIF, rif),
        (BLOCK_TTW, tif),
    ):
        body += bid + struct.pack(">L", len(payload)) + payload
    return MRW_MAGIC + struct.pack(">L", len(body)) + body + strip
