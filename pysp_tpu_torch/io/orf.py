"""Olympus ORF host-side decode — no libraw.

Sixth built-in raw format (after DNG/CR2/NEF/ARW/RW2); the reference opens ORF
through libraw (image.py:224). Pieces:

- Container: a TIFF with the alternate magic 0x4F52 ("IIRO") or 0x5352
  ("IIRS"); IFD0 carries standard dimension/strip tags. Olympus writes
  Compression=1 even for compressed payloads — compressed is detected by the
  strip being shorter than height*width*2 bytes (the dcraw/rawspeed rule).
- Codec (dcraw ``olympus_load_raw`` semantics): an MSB-first bitstream
  starting 7 bytes into the strip. Each photosite reads a 3-bit sign+low
  field, a unary-coded magnitude class (k zeros + a one for class k, twelve
  zeros as an escape to an explicit (16-nbits)-bit field), and ``nbits``
  residual bits, where ``nbits`` derives from the column-parity carry state.
  Two carry chains (even/odd columns) smooth the magnitude estimate; the
  spatial predictor is W/N/NW gradient selection over same-color neighbors
  two photosites away. The codec is fully lossless — the fixture encoder
  reproduces any 12-bit mosaic exactly.
- MakerNote: "OLYMPUS\\x00II\\x03\\x00" header + an IFD whose value offsets are
  relative to the MakerNote start (the Olympus quirk); WB lives in the
  ImageProcessing sub-IFD (0x2040) tag 0x0100 (WB_RBLevels x256), black level
  in its tag 0x0600 (per-channel BlackLevel2).
- No CFA tags exist in real ORFs: the pattern defaults to RGGB (the Olympus
  fleet's layout per dcraw) unless an explicit CFAPattern tag is present.
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

ORF_MAGIC_RO = 0x4F52
ORF_MAGIC_RS = 0x5352

TAG_MAKER_NOTE = 0x927C
MN_IMAGE_PROCESSING = 0x2040
IP_WB_RB_LEVELS = 0x0100
IP_BLACK_LEVEL2 = 0x0600


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_orf(source: Source) -> bool:
    """ORF: TIFF container with the Olympus alternate magic."""
    if isinstance(source, str):
        # probe only the 4-byte magic — load_raw calls this on every input
        with open(source, "rb") as f:
            data = f.read(4)
    else:
        data = bytes(source[:4])
    if len(data) < 4 or data[:2] != b"II":
        return False
    (magic,) = struct.unpack_from("<H", data, 2)
    return magic in (ORF_MAGIC_RO, ORF_MAGIC_RS)


# --- Olympus codec ----------------------------------------------------------------------
class _MsbBits:
    """MSB-first bit reader (dcraw getbits without marker stuffing)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        out = 0
        p = self.pos
        d = self.data
        for _ in range(n):
            byte = p >> 3
            bit = (d[byte] >> (7 - (p & 7))) & 1 if byte < len(d) else 0
            out = (out << 1) | bit
            p += 1
        self.pos = p
        return out

    def zeros_then_one(self, limit: int = 12) -> int:
        """Count leading zeros, consuming them plus the terminating one (or
        exactly ``limit`` zeros for the escape)."""
        k = 0
        while k < limit:
            if self.get(1):
                return k
            k += 1
        return limit


class _MsbWriter:
    def __init__(self):
        self.bits: list = []

    def put(self, n: int, value: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def tobytes(self) -> bytes:
        pad = (-len(self.bits)) % 8
        bits = self.bits + [0] * pad
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


def _olympus_pred(raw: np.ndarray, row: int, col: int) -> int:
    """W/N/NW gradient predictor over same-color (distance-2) neighbors."""
    if row < 2 and col < 2:
        return 0
    if row < 2:
        return int(raw[row, col - 2])
    if col < 2:
        return int(raw[row - 2, col])
    w = int(raw[row, col - 2])
    n = int(raw[row - 2, col])
    nw = int(raw[row - 2, col - 2])
    if (w < nw < n) or (n < nw < w):
        if abs(w - nw) > 32 or abs(n - nw) > 32:
            return w + n - nw
        return (w + n) >> 1
    return w if abs(w - nw) > abs(n - nw) else n


def _nbits_for(carry) -> Tuple[int, int]:
    """(i, nbits) from the parity's carry state (dcraw's loop, ushort cast)."""
    i = 2 * (carry[2] < 3)
    nbits = 2 + i
    while ((carry[0] & 0xFFFF) >> (nbits + i)) and nbits < 16:
        nbits += 1
    return i, nbits


def olympus_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """Decode an Olympus compressed strip -> (h, w) uint16 stored values."""
    bits = _MsbBits(data[7:])  # dcraw: fseek(ifp, 7, SEEK_CUR)
    raw = np.zeros((h, w), np.uint16)
    for row in range(h):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(w):
            carry = acarry[col & 1]
            _, nbits = _nbits_for(carry)
            field = bits.get(3)
            low = field & 3
            sign = -1 if field & 4 else 0
            high = bits.zeros_then_one()
            if high == 12:
                high = bits.get(16 - nbits) >> 1
            carry[0] = (high << nbits) | bits.get(nbits)
            diff = (carry[0] ^ sign) + carry[1]
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if carry[0] > 16 else carry[2] + 1
            pred = _olympus_pred(raw, row, col)
            raw[row, col] = (pred + ((diff << 2) | low)) & 0xFFFF
    return raw


def olympus_encode(values: np.ndarray) -> bytes:
    """Pack (h, w) stored values as an Olympus compressed strip (lossless:
    ``olympus_decode(olympus_encode(v)) == v`` for any uint16 mosaic whose
    residuals keep carry magnitudes under 2^15, which 12-bit data always does).
    """
    h, w = values.shape
    v = values.astype(np.int64)
    wr = _MsbWriter()
    raw = np.zeros((h, w), np.uint16)
    for row in range(h):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(w):
            carry = acarry[col & 1]
            _, nbits = _nbits_for(carry)
            pred = _olympus_pred(raw, row, col)
            r = int(v[row, col]) - pred
            # decoder reconstructs r = (diff << 2) | low
            low = r & 3
            diff = r >> 2
            d = diff - carry[1]
            if d >= 0:
                sign = 0
                c0 = d
            else:
                sign = -1
                c0 = -d - 1
            if c0 >= (1 << 15):
                raise ValueError("residual too large for the Olympus code")
            wr.put(3, (4 if sign else 0) | low)
            high = c0 >> nbits
            if high < 12:
                wr.put(high + 1, 1)  # 'high' zeros then a one
            else:
                wr.put(12, 0)  # escape
                wr.put(16 - nbits, high << 1)
            wr.put(nbits, c0 & ((1 << nbits) - 1))
            carry[0] = c0
            dd = (c0 ^ sign) + carry[1]
            assert dd == diff
            carry[1] = (dd * 3 + carry[1]) >> 5
            carry[2] = 0 if c0 > 16 else carry[2] + 1
            raw[row, col] = (pred + ((dd << 2) | low)) & 0xFFFF
            assert raw[row, col] == values[row, col]
    return b"\x00" * 7 + wr.tobytes()


# --- container --------------------------------------------------------------------------
def _parse_olympus_makernote(tf: T.TiffFile) -> Optional[T.Ifd]:
    """Olympus MakerNote: "OLYMPUS\\x00II\\x03\\x00" + IFD with offsets relative
    to the MakerNote start. Returns the ImageProcessing sub-IFD."""
    for ifd in tf.ifds:
        exif = ifd.exif_ifd
        if exif is None:
            continue
        mn = exif.get(TAG_MAKER_NOTE)
        if mn is None or mn.value_offset is None:
            continue
        base = mn.value_offset
        payload = mn.as_bytes()
        if not payload.startswith(b"OLYMPUS\x00"):
            return None
        try:
            # rebase: entry offsets are relative to `base`
            sub = tf.data[base:]
            parsed, _ = T._parse_ifd(sub, "<", 12)
            ip = parsed.get(MN_IMAGE_PROCESSING)
            if ip is None:
                return None
            ip_ifd, _ = T._parse_ifd(sub, "<", ip.as_ints()[0])
            return ip_ifd
        except (struct.error, IndexError, ValueError):
            return None
    return None


def load_raw_orf(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode an ORF into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import (
        _PATTERN_FROM_STRING,
        _decode_pattern,
        _normalize_host,
        frame_from_parts,
    )

    tf = T.read_tiff(source)
    if not tf.ifds:
        raise ValueError("ORF: no IFDs")
    ifd0 = tf.ifds[0]
    wtag = ifd0.get(T.TAG_IMAGE_WIDTH)
    htag = ifd0.get(T.TAG_IMAGE_LENGTH)
    otag = ifd0.get(T.TAG_STRIP_OFFSETS)
    ctag = ifd0.get(T.TAG_STRIP_BYTE_COUNTS)
    if None in (wtag, htag, otag):
        raise ValueError("ORF: missing raw dimensions or strip")
    width = wtag.as_ints()[0]
    height = htag.as_ints()[0]
    from .raw_loader import check_decode_dims

    check_decode_dims(height, width)
    o = otag.as_ints()[0]
    c = ctag.as_ints()[0] if ctag is not None else len(tf.data) - o

    blob = bytes(tf.data[o : o + c])
    if c < height * width * 2:
        # Olympus writes Compression=1 regardless; short strip => compressed
        from . import native

        if native.has_orf():
            stored = native.orf_decode(blob, height, width)
        else:
            stored = olympus_decode(blob, height, width)
    else:
        stored = (
            np.frombuffer(blob, "<u2", height * width)
            .reshape(height, width)
            .astype(np.uint16)
        )

    cfa = ifd0.get(T.TAG_CFA_PATTERN)
    if cfa is not None:
        pattern = _decode_pattern(
            list(cfa.as_bytes() if isinstance(cfa.values, bytes) else cfa.as_ints())[:4]
        )
    else:
        pattern = _PATTERN_FROM_STRING["RGGB"]  # the Olympus fleet default

    ip = _parse_olympus_makernote(tf)
    black = np.zeros(4)
    neutral = np.array([0.5, 1.0, 0.5], np.float64)
    if ip is not None:
        bl = ip.get(IP_BLACK_LEVEL2)
        if bl is not None and len(bl.as_ints()) >= 4:
            black = np.array(bl.as_ints()[:4], np.float64)
        wb = ip.get(IP_WB_RB_LEVELS)
        if wb is not None and len(wb.as_ints()) >= 2:
            r_mul, b_mul = [x / 256.0 for x in wb.as_ints()[:2]]
            if r_mul > 0 and b_mul > 0:
                neutral = np.array([1.0 / r_mul, 1.0, 1.0 / b_mul], np.float64)

    # black tag values are per channel in (R, G1, G2, B) reading order; map
    # them onto grid positions by walking the pattern string (TL, TR, BL, BR)
    pat = {v: k for k, v in _PATTERN_FROM_STRING.items()}[pattern]
    by_pos = []
    g_seen = False
    for ch in pat:
        if ch == "G":
            by_pos.append(black[2] if g_seen else black[1])
            g_seen = True
        else:
            by_pos.append(black[0] if ch == "R" else black[3])
    # _normalize_host wants positions TL, TR, BR, BL
    chan_black = np.array([by_pos[0], by_pos[1], by_pos[3], by_pos[2]], np.float64)
    white = 4095.0
    sensor = _normalize_host(stored, chan_black, np.full(4, white))
    sensor = sensor[: sensor.shape[0] & ~1, : sensor.shape[1] & ~1]

    if color_mats is None:
        model_tag = ifd0.get(T.TAG_MODEL)
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


# --- synthetic fixture writer -----------------------------------------------------------
def write_synthetic_orf(
    stored12: np.ndarray,
    model: bytes = b"E-M SYNTH",
    wb_rb: Tuple[int, int] = (568, 412),
    black_rggb: Tuple[int, int, int, int] = (255, 254, 253, 252),
    uncompressed: bool = False,
) -> bytes:
    """Assemble a structurally faithful ORF ("IIRO" magic) test fixture.

    ``black_rggb`` is (R, G1, G2, B). The compressed payload is lossless, so
    loads always see ``stored12`` exactly.
    """
    h, w = stored12.shape
    if uncompressed:
        blob = stored12.astype("<u2").tobytes()
    else:
        from . import native

        if native.has_orf():  # bit-identical to the Python encoder (tested)
            blob = native.orf_encode(np.ascontiguousarray(stored12, np.uint16))
        else:
            blob = olympus_encode(np.ascontiguousarray(stored12, np.uint16))

    E = "<"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    HDR = 8
    ifd0_n, exif_n = 9, 4
    off_ifd0 = HDR
    off_exif = off_ifd0 + sz(ifd0_n)
    off_heap = off_exif + sz(exif_n)

    make_b = b"OLYMPUS CORPORATION\x00"
    model_b = model + b"\x00"
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 200)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 4, 1)

    # MakerNote: OLYMPUS header, one IFD pointing at the ImageProcessing
    # sub-IFD; ALL offsets relative to the MakerNote start
    off_mn = off_heap + len(heap)
    mn_hdr = b"OLYMPUS\x00II\x03\x00"
    mn_ifd_off = len(mn_hdr)
    ip_off = mn_ifd_off + sz(1)
    ip_vals_off = ip_off + sz(2)
    mn = mn_hdr
    mn += struct.pack(E + "H", 1)
    mn += entry(MN_IMAGE_PROCESSING, T.TYPE_LONG, 1, struct.pack(E + "L", ip_off))
    mn += struct.pack(E + "L", 0)
    mn += struct.pack(E + "H", 2)
    mn += entry(IP_WB_RB_LEVELS, T.TYPE_SHORT, 2, inline("HH", *wb_rb))
    mn += entry(IP_BLACK_LEVEL2, T.TYPE_SHORT, 4, struct.pack(E + "L", ip_vals_off))
    mn += struct.pack(E + "L", 0)
    mn += struct.pack(E + "4H", *black_rggb)
    heap += mn + (b"\x00" if len(mn) % 2 else b"")
    off_blob = off_heap + len(heap)

    out = struct.pack(E + "2sHL", b"II", ORF_MAGIC_RO, off_ifd0)
    out += struct.pack(E + "H", ifd0_n)
    out += entry(T.TAG_IMAGE_WIDTH, T.TYPE_LONG, 1, struct.pack(E + "L", w))
    out += entry(T.TAG_IMAGE_LENGTH, T.TYPE_LONG, 1, struct.pack(E + "L", h))
    out += entry(T.TAG_BITS_PER_SAMPLE, T.TYPE_SHORT, 1, inline("H", 12))
    out += entry(T.TAG_COMPRESSION, T.TYPE_SHORT, 1, inline("H", 1))  # the quirk
    out += entry(T.TAG_MAKE, T.TYPE_ASCII, len(make_b), struct.pack(E + "L", off_make))
    out += entry(
        T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack(E + "L", off_model)
    )
    out += entry(T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 1, struct.pack(E + "L", off_blob))
    out += entry(
        T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 1, struct.pack(E + "L", len(blob))
    )
    out += entry(T.TAG_EXIF_IFD, T.TYPE_LONG, 1, struct.pack(E + "L", off_exif))
    out += struct.pack(E + "L", 0)

    out += struct.pack(E + "H", exif_n)
    out += entry(
        T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp)
    )
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    out += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 200))
    out += entry(TAG_MAKER_NOTE, T.TYPE_UNDEFINED, len(mn), struct.pack(E + "L", off_mn))
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out
