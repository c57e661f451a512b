"""Panasonic RW2 host-side decode — no libraw.

Fourth built-in non-DNG format (after io/cr2.py, io/nef.py, io/arw.py); the
reference opens RW2 through libraw (image.py:224) and already special-cases the
Panasonic ISO maker tag 0x0017 for EV (image.py:68-70 — mirrored in
io/metadata.py). Pieces:

- Container: a TIFF with the alternate magic 0x55 (io/tiff.py accepts both);
  all raw metadata lives in IFD0 under Panasonic-private tags — sensor dims
  0x02/0x03, active borders 0x04-0x07, CFA phase 0x09, bits-per-sample 0x0a,
  per-channel black levels 0x1c-0x1e, white-balance levels 0x24-0x26 (legacy
  0x11/0x12 red/blue balance x256), raw format 0x2d, and the raw data offset
  0x118 (the tag numbering documented by exiftool's PanasonicRaw table and
  consumed the same way by dcraw/rawspeed).
- Codec: the classic Panasonic v4 bitstream (dcraw ``panasonic_load_raw``):
  the payload is split into 0x4000-byte sections whose bytes are rotated at
  0x2008; a 17-bit down-counting cursor addresses 16-bit little-endian windows
  inside the section; rows decode as 14-pixel packets of two interleaved CFA
  channels, each packet carrying a shared 2-bit shift code every third site,
  8-bit scaled deltas against a per-channel predictor, and 12-bit (8+4)
  channel (re)initialisers.
- Uncompressed variants keep the raw in standard strips (compression 1 at
  StripOffsets/ByteCounts).

The reader mirrors dcraw's ``pana_bits`` state machine (down-counting 17-bit
cursor over rotated 0x4000-byte sections, 16-bit little-endian windows,
reload only when the cursor hits zero); the window byte is
``vbits >> 3 ^ 0x3ff0`` — the XOR flips the 16-byte-group index so groups are
consumed in increasing file order while bit addressing inside a group counts
down, exactly dcraw's formula (with the fixed-rate 128-bit packet layout no
window ever straddles a physical group, so reads stay gap-free). Predictors and the
shift persist across packet boundaries exactly as the C function state does.
The encoder used for synthetic fixtures emits the fixed-rate layout cameras
produce (two 12-bit initialisers + twelve 8-bit deltas + four shift codes =
exactly 128 bits per packet, so packets never straddle sections) and returns
the decoder-exact values it achieved — delta coding quantises by the shift
step, like the camera's own compressor.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple, Union

import numpy as np

from ..core.device import CARD
from ..core.frame import RawFrame
from . import tiff as T
from .camera_matrices import resolve_camera_matrices

Source = Union[str, bytes]

SECTION = 0x4000  # bytes per bitstream section
SPLIT = 0x2008  # byte rotation point inside a section (dcraw load_flags)

TAG_PANA_VERSION = 0x0001
TAG_SENSOR_WIDTH = 0x0002
TAG_SENSOR_HEIGHT = 0x0003
TAG_BORDER_TOP = 0x0004
TAG_BORDER_LEFT = 0x0005
TAG_BORDER_BOTTOM = 0x0006
TAG_BORDER_RIGHT = 0x0007
TAG_CFA_PHASE = 0x0009
TAG_PANA_BITS = 0x000A
TAG_RED_BALANCE = 0x0011
TAG_BLUE_BALANCE = 0x0012
TAG_PANA_ISO = 0x0017
TAG_BLACK_RED = 0x001C
TAG_BLACK_GREEN = 0x001D
TAG_BLACK_BLUE = 0x001E
TAG_WB_RED = 0x0024
TAG_WB_GREEN = 0x0025
TAG_WB_BLUE = 0x0026
TAG_RAW_FORMAT = 0x002D
TAG_RAW_OFFSET = 0x0118

# tag 0x09 values 1..4 -> Bayer phase of the full sensor grid (exiftool map)
_CFA_PHASE = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_rw2(source: Source) -> bool:
    """RW2: TIFF container with the 0x55 magic whose IFD0 carries the
    Panasonic raw tags (both checks — a classic TIFF/DNG that happens to
    carry colliding private tag numbers must not be misrouted here)."""
    try:
        tf = T.read_tiff(source)
    except (ValueError, struct.error):
        return False
    if not tf.ifds or len(tf.data) < 4:
        return False
    if struct.unpack_from(tf.endian + "H", tf.data, 2)[0] != 0x55:
        return False
    ifd0 = tf.ifds[0]
    if ifd0.get(TAG_RAW_OFFSET) is not None and ifd0.get(TAG_CFA_PHASE) is not None:
        return True
    make = ifd0.get(T.TAG_MAKE)
    return (
        make is not None
        and make.as_bytes().upper().startswith(b"PANASONIC")
        and ifd0.get(TAG_PANA_VERSION) is not None
    )


# --- Panasonic v4 bitstream -------------------------------------------------------------
class _PanaBits:
    """dcraw's ``pana_bits`` reader: rotated 0x4000-byte sections, 17-bit
    down-counting cursor, 16-bit LE windows. Past-the-end sections read as
    zeros (fread at EOF)."""

    def __init__(self, data: bytes):
        pad = (-len(data)) % SECTION
        arr = np.frombuffer(data + b"\x00" * pad, np.uint8)
        if arr.size == 0:
            arr = np.zeros(SECTION, np.uint8)
        self.sections = np.roll(arr.reshape(-1, SECTION), SPLIT, axis=1)
        self.si = -1
        self.vbits = 0
        # one spare zero byte: dcraw reads buf[byte+1] with byte up to 0x3fff
        self.buf = np.zeros(SECTION + 1, np.uint8)

    def get(self, n: int) -> int:
        if self.vbits == 0:
            self.si += 1
            if self.si < len(self.sections):
                self.buf[:SECTION] = self.sections[self.si]
            else:
                self.buf[:SECTION] = 0
        self.vbits = (self.vbits - n) & 0x1FFFF
        byte = self.vbits >> 3 ^ 0x3FF0
        word = int(self.buf[byte]) | int(self.buf[byte + 1]) << 8
        return (word >> (self.vbits & 7)) & ((1 << n) - 1)


def pana_v4_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """Decode the v4 bitstream into (h, w) stored values (dcraw state machine)."""
    bits = _PanaBits(data)
    out = np.zeros((h, w), np.uint16)
    pred = [0, 0]
    nonz = [0, 0]
    sh = 0  # persists across packets and rows, like dcraw's function-scope int
    for row in range(h):
        for col in range(w):
            i = col % 14
            if i == 0:
                pred[0] = pred[1] = nonz[0] = nonz[1] = 0
            if i % 3 == 2:
                sh = 4 >> (3 - bits.get(2))
            j = i & 1
            if nonz[j]:
                d = bits.get(8)
                if d:
                    pred[j] -= 0x80 << sh
                    if pred[j] < 0 or sh == 4:
                        pred[j] &= ~(-1 << sh)
                    pred[j] += d << sh
            else:
                nonz[j] = bits.get(8)
                if nonz[j] or i > 11:
                    pred[j] = nonz[j] << 4 | bits.get(4)
            out[row, col] = pred[col & 1]
    return out


class _PanaBitWriter:
    """Inverse of _PanaBits: place value bits where the reader's window math
    will find them. Asserts each stream bit is written at most once."""

    def __init__(self):
        self.sections = []
        self.buf = None
        self.seen = None
        self.vbits = 0

    def put(self, n: int, value: int) -> None:
        assert 0 <= value < (1 << n)
        if self.vbits == 0:
            self.buf = np.zeros(SECTION + 1, np.uint16)
            self.seen = np.zeros(SECTION + 1, np.uint16)
            self.sections.append((self.buf, self.seen))
        if self.vbits and self.vbits < n:
            raise ValueError("read would straddle a section (fixed-rate layout only)")
        self.vbits = (self.vbits - n) & 0x1FFFF
        byte = self.vbits >> 3 ^ 0x3FF0
        shift = self.vbits & 7
        mask = ((1 << n) - 1) << shift
        word = (value << shift) & 0xFFFF
        if (int(self.seen[byte]) | int(self.seen[byte + 1]) << 8) & mask:
            raise AssertionError("bit written twice")
        self.buf[byte] |= word & 0xFF
        self.buf[byte + 1] |= word >> 8
        self.seen[byte] |= mask & 0xFF
        self.seen[byte + 1] |= mask >> 8

    def tobytes(self) -> bytes:
        out = bytearray()
        for buf, _ in self.sections:
            out += np.roll(buf[:SECTION].astype(np.uint8), -SPLIT).tobytes()
        return bytes(out)


def _delta_step(pred: int, sh: int, j8: int) -> int:
    """Decoder's predictor update for a nonzero 8-bit code (dcraw semantics)."""
    p = pred - (0x80 << sh)
    if p < 0 or sh == 4:
        p &= ~(-1 << sh)
    return p + (j8 << sh)


def _best_delta(pred: int, sh: int, target: int) -> Tuple[int, int]:
    """(code, achieved) minimising |achieved - target| for one delta read."""
    base = pred - (0x80 << sh)
    if base < 0 or sh == 4:
        base = pred & ~(-1 << sh)
    j8 = int(np.clip(round((target - base) / (1 << sh)), 1, 255))
    cand = base + (j8 << sh)
    if abs(pred - target) <= abs(cand - target):
        return 0, pred  # code 0: predictor unchanged
    return j8, cand


def pana_v4_encode(values: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Pack (h, w) 12-bit values into the fixed-rate v4 layout.

    Returns (payload, achieved): ``pana_v4_decode(payload) == achieved``
    bit-exactly. Packet leaders (sites 0 and 1) are coded with full 12-bit
    initialisers and are exact for values in [16, 4095]; the remaining twelve
    sites are 8-bit deltas under the best of the four shift codes, exact for
    smooth content and quantised by the shift step on hard jumps.
    """
    h, w = values.shape
    if w % 14:
        raise ValueError("v4 encode requires width % 14 == 0")
    if values.min(initial=0) < 0 or values.max(initial=0) > 0xFFF:
        raise ValueError("v4 stores 12-bit values")
    wr = _PanaBitWriter()
    out = np.zeros((h, w), np.uint16)
    v = values.astype(np.int64)
    for row in range(h):
        for g0 in range(0, w, 14):
            pred = [0, 0]
            # leaders: 12-bit init per channel (nonz must end up nonzero)
            for i in (0, 1):
                t = int(np.clip(v[row, g0 + i], 16, 0xFFF))
                wr.put(8, t >> 4)
                wr.put(4, t & 0xF)
                pred[i] = t
                out[row, g0 + i] = t
            for i in range(2, 14):
                if i % 3 == 2:
                    # choose the shift for sites i..min(i+2,13) greedily
                    best = None
                    upto = min(i + 3, 14)
                    for code, sh in ((0, 0), (1, 1), (2, 2), (3, 4)):
                        p = list(pred)
                        err = 0
                        for k in range(i, upto):
                            jj = k & 1
                            _, ach = _best_delta(p[jj], sh, int(v[row, g0 + k]))
                            err += abs(ach - int(v[row, g0 + k]))
                            p[jj] = ach
                        if best is None or err < best[0]:
                            best = (err, code, sh)
                    _, code, sh = best
                    wr.put(2, code)
                j = i & 1
                j8, ach = _best_delta(pred[j], sh, int(v[row, g0 + i]))
                wr.put(8, j8)
                pred[j] = ach
                out[row, g0 + i] = ach
    return wr.tobytes(), out


# --- container --------------------------------------------------------------------------
def _tag_int(ifd: T.Ifd, tag: int, default: Optional[int] = None) -> Optional[int]:
    e = ifd.get(tag)
    if e is None:
        return default
    vals = e.as_ints()
    return vals[0] if vals else default


def load_raw_rw2(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode an RW2 into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import (
        _PATTERN_FROM_STRING,
        _normalize_host,
        frame_from_parts,
    )

    tf = T.read_tiff(source)
    if not tf.ifds:
        raise ValueError("RW2: no IFDs")
    ifd0 = tf.ifds[0]

    width = _tag_int(ifd0, TAG_SENSOR_WIDTH)
    height = _tag_int(ifd0, TAG_SENSOR_HEIGHT)
    from .raw_loader import check_decode_dims

    check_decode_dims(height, width)
    if width is None or height is None:
        raise ValueError("RW2: missing sensor dimensions")
    bits = _tag_int(ifd0, TAG_PANA_BITS, 12)
    phase = _tag_int(ifd0, TAG_CFA_PHASE)
    if phase not in _CFA_PHASE:
        raise ValueError(f"RW2: unsupported CFA phase {phase}")

    raw_off = _tag_int(ifd0, TAG_RAW_OFFSET)
    if raw_off is not None:
        raw_format = _tag_int(ifd0, TAG_RAW_FORMAT, 4)
        if raw_format > 4:
            # 5 = packed uncompressed variant, 6/7 = newer compressors — not
            # the v4 bitstream; decoding them as v4 would yield garbage
            raise ValueError(f"RW2: unsupported RawFormat {raw_format}")
        from . import native

        if native.has_rw2():
            stored = native.rw2_decode(bytes(tf.data[raw_off:]), height, width)
        else:
            stored = pana_v4_decode(bytes(tf.data[raw_off:]), height, width)
    else:
        o = _tag_int(ifd0, T.TAG_STRIP_OFFSETS)
        c = _tag_int(ifd0, T.TAG_STRIP_BYTE_COUNTS)
        if o is None or c is None:
            raise ValueError("RW2: no raw data offset")
        stored = (
            np.frombuffer(bytes(tf.data[o : o + c]), tf.endian + "u2", height * width)
            .reshape(height, width)
            .astype(np.uint16)
        )

    top = _tag_int(ifd0, TAG_BORDER_TOP, 0)
    left = _tag_int(ifd0, TAG_BORDER_LEFT, 0)
    bottom = _tag_int(ifd0, TAG_BORDER_BOTTOM, height)
    right = _tag_int(ifd0, TAG_BORDER_RIGHT, width)
    stored = stored[top:bottom, left:right]
    stored = stored[: stored.shape[0] & ~1, : stored.shape[1] & ~1]
    if stored.size == 0:
        raise ValueError("RW2: empty active area")

    # borders may start at odd sensor coordinates: the CFA phase tag describes
    # the full grid, so shift it by the crop parity
    grid = _CFA_PHASE[phase]
    g = [[grid[0], grid[1]], [grid[2], grid[3]]]
    shifted = "".join(g[(y + top) % 2][(x + left) % 2] for y in (0, 1) for x in (0, 1))
    pattern = _PATTERN_FROM_STRING[shifted]

    black = {
        "R": float(_tag_int(ifd0, TAG_BLACK_RED, 0)),
        "G": float(_tag_int(ifd0, TAG_BLACK_GREEN, 0)),
        "B": float(_tag_int(ifd0, TAG_BLACK_BLUE, 0)),
    }
    # _normalize_host indexes blacks by grid position TL, TR, BR, BL
    chan_black = np.array(
        [black[shifted[0]], black[shifted[1]], black[shifted[3]], black[shifted[2]]],
        np.float64,
    )
    white = float((1 << bits) - 1)
    sensor = _normalize_host(stored, chan_black, np.full(4, white))

    neutral = np.array([0.5, 1.0, 0.5], np.float64)
    wb_r = _tag_int(ifd0, TAG_WB_RED)
    wb_g = _tag_int(ifd0, TAG_WB_GREEN)
    wb_b = _tag_int(ifd0, TAG_WB_BLUE)
    if wb_r and wb_g and wb_b:
        neutral = np.array([wb_g / wb_r, 1.0, wb_g / wb_b], np.float64)
    else:
        rb = _tag_int(ifd0, TAG_RED_BALANCE)
        bb = _tag_int(ifd0, TAG_BLUE_BALANCE)
        if rb and bb:
            neutral = np.array([256.0 / rb, 1.0, 256.0 / bb], np.float64)

    if color_mats is None:
        model_tag = ifd0.get(T.TAG_MODEL)
        model = (
            model_tag.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
            if model_tag is not None
            else None
        )
        color_mats = resolve_camera_matrices(model)

    cam_wb = CameraWhiteBalanceController(color_mats, neutral)
    ev = compute_ev_from_tiff(source)  # hits the Panasonic 0x0017 ISO quirk
    if not np.isfinite(ev):
        raise ValueError("Error reading exposure value from raw!")
    return frame_from_parts(sensor, pattern, cam_wb, ev, device=device)


# --- synthetic fixture writer -----------------------------------------------------------
def write_synthetic_rw2(
    stored12: np.ndarray,
    model: bytes = b"DMC-SYNTH",
    cfa_phase: int = 1,
    wb_rgb: Tuple[int, int, int] = (580, 263, 410),
    black_rgb: Tuple[int, int, int] = (143, 142, 143),
    borders: Optional[Tuple[int, int, int, int]] = None,
    iso: int = 200,
    uncompressed: bool = False,
) -> Tuple[bytes, np.ndarray]:
    """Assemble a structurally faithful RW2 (magic 0x55) test fixture.

    Returns (file bytes, stored values as the decoder will see them) — the v4
    codec quantises hard jumps, so tests compare against the achieved array.
    ``borders`` is (top, left, bottom, right) in sensor coordinates.
    """
    h, w = stored12.shape
    if borders is None:
        borders = (0, 0, h, w)
    if uncompressed:
        blob = stored12.astype("<u2").tobytes()
        achieved = stored12.astype(np.uint16)
    else:
        from . import native

        if native.has_rw2():  # bit-identical to the Python encoder (tested)
            blob, achieved = native.rw2_encode(np.ascontiguousarray(stored12))
        else:
            blob, achieved = pana_v4_encode(np.ascontiguousarray(stored12))

    E = "<"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    HDR = 8
    ifd0_n = 22 if uncompressed else 21
    exif_n = 2
    off_ifd0 = HDR
    off_exif = off_ifd0 + sz(ifd0_n)
    off_heap = off_exif + sz(exif_n)

    make_b = b"Panasonic\x00"
    model_b = model + b"\x00"
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b + (b"\x00" if len(make_b) % 2 else b"")
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 125)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 28, 10)
    off_blob = off_heap + len(heap)

    top, left, bottom, right = borders
    out = struct.pack(E + "2sHL", b"II", 0x55, off_ifd0)
    out += struct.pack(E + "H", ifd0_n)
    out += entry(TAG_PANA_VERSION, T.TYPE_UNDEFINED, 4, b"0400")
    out += entry(TAG_SENSOR_WIDTH, T.TYPE_SHORT, 1, inline("H", w))
    out += entry(TAG_SENSOR_HEIGHT, T.TYPE_SHORT, 1, inline("H", h))
    out += entry(TAG_BORDER_TOP, T.TYPE_SHORT, 1, inline("H", top))
    out += entry(TAG_BORDER_LEFT, T.TYPE_SHORT, 1, inline("H", left))
    out += entry(TAG_BORDER_BOTTOM, T.TYPE_SHORT, 1, inline("H", bottom))
    out += entry(TAG_BORDER_RIGHT, T.TYPE_SHORT, 1, inline("H", right))
    out += entry(TAG_CFA_PHASE, T.TYPE_SHORT, 1, inline("H", cfa_phase))
    out += entry(TAG_PANA_BITS, T.TYPE_SHORT, 1, inline("H", 12))
    out += entry(TAG_PANA_ISO, T.TYPE_SHORT, 1, inline("H", iso))
    out += entry(TAG_BLACK_RED, T.TYPE_SHORT, 1, inline("H", black_rgb[0]))
    out += entry(TAG_BLACK_GREEN, T.TYPE_SHORT, 1, inline("H", black_rgb[1]))
    out += entry(TAG_BLACK_BLUE, T.TYPE_SHORT, 1, inline("H", black_rgb[2]))
    out += entry(TAG_WB_RED, T.TYPE_SHORT, 1, inline("H", wb_rgb[0]))
    out += entry(TAG_WB_GREEN, T.TYPE_SHORT, 1, inline("H", wb_rgb[1]))
    out += entry(TAG_WB_BLUE, T.TYPE_SHORT, 1, inline("H", wb_rgb[2]))
    out += entry(TAG_RAW_FORMAT, T.TYPE_SHORT, 1, inline("H", 4))
    out += entry(T.TAG_MAKE, T.TYPE_ASCII, len(make_b), struct.pack(E + "L", off_make))
    out += entry(
        T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack(E + "L", off_model)
    )
    if uncompressed:
        out += entry(
            T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 1, struct.pack(E + "L", off_blob)
        )
        out += entry(
            T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 1, struct.pack(E + "L", len(blob))
        )
    else:
        out += entry(TAG_RAW_OFFSET, T.TYPE_LONG, 1, struct.pack(E + "L", off_blob))
    out += entry(T.TAG_EXIF_IFD, T.TYPE_LONG, 1, struct.pack(E + "L", off_exif))
    out += struct.pack(E + "L", 0)

    # EXIF: exposure + f-number only — ISO stays in maker tag 0x17 so loads
    # exercise the reference's Panasonic EV quirk (image.py:68-70)
    out += struct.pack(E + "H", exif_n)
    out += entry(
        T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp)
    )
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out, achieved
