"""Pentax PEF host-side decode — no libraw.

Eighth built-in format; the reference opens PEF through libraw
(reference/image.py:224). Pieces (published dcraw/libraw
``pentax_load_raw`` semantics, reimplemented):

- Container: a standard TIFF (either endianness) whose IFD0 carries
  Make = PENTAX/RICOH; the raw IFD is photometric CFA with compression 65535
  (Pentax Huffman) or 1 (plain 16-bit strips). DNGs from the same bodies are
  excluded by the DNGVersion tag.
- Compressed payload: a plain MSB-first bitstream (no JPEG byte stuffing) of
  Huffman-coded prediction residuals. The Huffman spec is NOT canonical-JPEG:
  the MakerNote tag 0x0220 value holds, after a 2-byte depth word
  (``dep = (v + 12) & 15``) and 12 skipped bytes, ``dep`` 12-bit left-aligned
  code prefixes (u16 each) then ``dep`` code lengths (u8 each). Decoding peeks
  12 bits and looks the value up in a 4096-entry table mapping
  ``prefix[c] .. prefix[c] + (4096 >> len[c]) - 1`` -> (len, symbol).
- Residuals: JPEG-lossless style — symbol = bit length L, then L raw bits,
  negative values stored as ``v + (1 << L) - 1`` (sign-extend when the top bit
  is clear). Predictor: two vertical seeds per row parity for the first two
  columns (``vpred[row & 1][col] += diff``), then horizontal DPCM per column
  parity (``hpred[col & 1] += diff``).
- MakerNote: "AOC\\x00" + 2-byte order marker + a standard IFD whose value
  offsets are relative to the TIFF base. Tag 0x0200 = per-channel black
  levels (R, G1, G2, B order), 0x0201 = white balance (R, G1, G2, B levels),
  0x0220 = the Huffman spec block.
- Color matrices: io/camera_matrices registry by model, Rec.709 fallback
  (same divergence note as CR2/NEF, DIVERGENCES.md).

Divergence from dcraw: out-of-range predictions are clamped to
``[0, 2^bits - 1]`` instead of aborting the decode (DIVERGENCES.md).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from ..core.device import CARD
from ..core.frame import RawFrame
from . import tiff as T
from .camera_matrices import resolve_camera_matrices

Source = Union[str, bytes]

TAG_MAKER_NOTE = 0x927C
TAG_DNG_VERSION = 0xC612
PEF_COMPRESSION = 65535
MN_BLACK_POINT = 0x0200
MN_WHITE_POINT = 0x0201
MN_HUFF_TABLE = 0x0220


def _read_head(source: Source, n: int) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read(n)
    return bytes(source[:n])


def is_pef(source: Source) -> bool:
    """PEF: TIFF with a PENTAX/RICOH Make, a CFA raw IFD, and no DNGVersion."""
    head = _read_head(source, 4)
    if len(head) < 4 or head[:2] not in (b"II", b"MM"):
        return False
    endian = "<" if head[:2] == b"II" else ">"
    if struct.unpack_from(endian + "H", head, 2)[0] != 42:
        return False
    try:
        tf = T.read_tiff(source)
    except (ValueError, struct.error):
        return False
    if not tf.ifds:
        return False
    make = tf.ifds[0].get(T.TAG_MAKE)
    if make is None:
        return False
    up = make.as_bytes().upper()
    if not (up.startswith(b"PENTAX") or up.startswith(b"RICOH")):
        return False
    if tf.ifds[0].get(TAG_DNG_VERSION) is not None:
        return False
    return tf.find_raw_ifd() is not None


# --- Huffman spec + bitstream codec (pure-Python twin of native pef_decode) ------------
def parse_huff_spec(blob: bytes, endian: str) -> Tuple[np.ndarray, np.ndarray]:
    """(prefixes u16[dep], lengths u8[dep]) from the MakerNote 0x0220 value."""
    if len(blob) < 2:
        raise ValueError("PEF: Huffman spec too short")
    (v0,) = struct.unpack_from(endian + "H", blob, 0)
    dep = (v0 + 12) & 15
    need = 2 + 12 + 2 * dep + dep
    if dep == 0 or len(blob) < need:
        raise ValueError("PEF: truncated Huffman spec")
    prefixes = np.array(
        struct.unpack_from(endian + "%dH" % dep, blob, 14), np.uint16
    )
    lengths = np.frombuffer(blob, np.uint8, dep, 14 + 2 * dep).copy()
    return prefixes, lengths


def _build_lut(prefixes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """4096-entry peek-12 table: lut[v] = (len << 8) | symbol."""
    lut = np.zeros(4096, np.uint16)
    for c, (p, ln) in enumerate(zip(prefixes.tolist(), lengths.tolist())):
        if not 1 <= ln <= 12:
            raise ValueError(f"PEF: bad code length {ln}")
        n = 4096 >> ln
        if p + n > 4096:
            raise ValueError("PEF: Huffman prefix overruns the 12-bit space")
        lut[p : p + n] = (ln << 8) | c
    return lut


class _PefBits:
    """Plain MSB-first bit reader (no JPEG stuffing); zero-fill past the end."""

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def peek12(self) -> int:
        v = 0
        for k in range(12):
            p = self.bitpos + k
            byte = self.data[p >> 3] if (p >> 3) < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
        return v

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            p = self.bitpos
            byte = self.data[p >> 3] if (p >> 3) < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
            self.bitpos += 1
        return v


def pef_decode(
    data: bytes, height: int, width: int, spec: Tuple[np.ndarray, np.ndarray],
    bits: int = 12,
) -> np.ndarray:
    """Decode the compressed strip to (height, width) uint16 stored values."""
    lut = _build_lut(*spec)
    br = _PefBits(data)
    out = np.zeros((height, width), np.uint16)
    vpred = [[0, 0], [0, 0]]
    hpred = [0, 0]
    lim = (1 << bits) - 1
    for row in range(height):
        for col in range(width):
            entry = int(lut[br.peek12()])
            ln = entry >> 8
            if ln == 0:
                raise ValueError("PEF: invalid Huffman code in stream")
            br.bitpos += ln
            sym = entry & 0xFF
            if sym == 0:
                diff = 0
            else:
                v = br.get(sym)
                diff = v if v >= (1 << (sym - 1)) else v - (1 << sym) + 1
            if col < 2:
                vpred[row & 1][col] += diff
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] += diff
            out[row, col] = min(max(hpred[col & 1], 0), lim)
    return out


# Fixture/default code: symbols 0..12 (residual bit lengths), Kraft-complete.
_FIXTURE_LENGTHS = (2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11)


def make_huff_spec(
    lengths: Tuple[int, ...] = _FIXTURE_LENGTHS, endian: str = "<"
) -> Tuple[bytes, Tuple[np.ndarray, np.ndarray]]:
    """Canonical code assignment -> (0x0220 blob, parsed spec)."""
    dep = len(lengths)
    order = sorted(range(dep), key=lambda c: (lengths[c], c))
    code = 0
    prev = 0
    prefixes = np.zeros(dep, np.uint16)
    for c in order:
        ln = lengths[c]
        code <<= ln - prev
        prev = ln
        prefixes[c] = code << (12 - ln)
        code += 1
    lens = np.array(lengths, np.uint8)
    blob = struct.pack(endian + "H", (dep - 12) & 15) + b"\x00" * 12
    blob += struct.pack(endian + "%dH" % dep, *prefixes.tolist())
    blob += lens.tobytes()
    return blob, (prefixes, lens)


class _PefBitWriter:
    def __init__(self):
        self.bytes_ = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        for k in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> k) & 1)
            self.n += 1
            if self.n == 8:
                self.bytes_.append(self.acc)
                self.acc = 0
                self.n = 0

    def done(self) -> bytes:
        if self.n:
            self.bytes_.append(self.acc << (8 - self.n))
        return bytes(self.bytes_)


def pef_encode(
    values: np.ndarray, spec: Tuple[np.ndarray, np.ndarray]
) -> bytes:
    """Inverse of pef_decode (test fixtures): Huffman-code the DPCM residuals."""
    prefixes, lengths = spec
    h, w = values.shape
    bw = _PefBitWriter()
    vpred = [[0, 0], [0, 0]]
    hpred = [0, 0]
    max_sym = len(lengths) - 1
    for row in range(h):
        for col in range(w):
            target = int(values[row, col])
            pred = vpred[row & 1][col] if col < 2 else hpred[col & 1]
            diff = target - pred
            sym = diff.bit_length() if diff >= 0 else (-diff).bit_length()
            if sym > max_sym:
                raise ValueError(f"PEF encode: residual {diff} needs symbol {sym}")
            code = int(prefixes[sym]) >> (12 - int(lengths[sym]))
            bw.put(code, int(lengths[sym]))
            if sym:
                v = diff if diff >= 0 else diff + (1 << sym) - 1
                bw.put(v, sym)
            if col < 2:
                vpred[row & 1][col] = target
                hpred[col] = target
            else:
                hpred[col & 1] = target
    return bw.done()


# --- MakerNote ---------------------------------------------------------------------------
def _parse_pentax_makernote(tf: T.TiffFile) -> Optional[T.Ifd]:
    """AOC-style MakerNote: 'AOC\\x00' + order marker + IFD with TIFF-base
    offsets (offsets are absolute within the file, per the Pentax convention)."""
    for ifd in tf.ifds:
        exif = ifd.exif_ifd
        if exif is None:
            continue
        mn = exif.get(TAG_MAKER_NOTE)
        if mn is None or mn.value_offset is None:
            continue
        payload = mn.as_bytes()
        if not payload.startswith(b"AOC\x00"):
            return None
        try:
            parsed, _ = T._parse_ifd(tf.data, tf.endian, mn.value_offset + 6)
        except (struct.error, IndexError, ValueError):
            return None
        return parsed
    return None


def _mn_shorts(mn: Optional[T.Ifd], tag: int, n: int) -> Optional[List[int]]:
    if mn is None:
        return None
    e = mn.get(tag)
    if e is None:
        return None
    vals = e.as_ints()
    return list(vals[:n]) if len(vals) >= n else None


def load_raw_pef(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode a PEF into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import _decode_pattern, _normalize_host, frame_from_parts

    tf = T.read_tiff(source)
    raw_ifd = tf.find_raw_ifd()
    if raw_ifd is None:
        raise ValueError("PEF: no CFA raw IFD found")

    cfa = raw_ifd.get(T.TAG_CFA_PATTERN)
    if cfa is None:
        raise ValueError("PEF: raw IFD has no CFA pattern")
    cfa_codes = list(
        cfa.as_bytes() if isinstance(cfa.values, bytes) else cfa.as_ints()
    )[:4]
    pattern = _decode_pattern(cfa_codes)

    width = raw_ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    height = raw_ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    from .raw_loader import check_decode_dims

    check_decode_dims(height, width)
    bits = raw_ifd.require(T.TAG_BITS_PER_SAMPLE).as_ints()[0]
    comp_tag = raw_ifd.get(T.TAG_COMPRESSION)
    compression = comp_tag.as_ints()[0] if comp_tag is not None else 1

    mn = _parse_pentax_makernote(tf)

    if compression == PEF_COMPRESSION:
        if mn is None:
            raise ValueError("PEF: compressed file without an AOC MakerNote")
        huff = mn.get(MN_HUFF_TABLE)
        if huff is None:
            raise ValueError("PEF: missing Huffman spec (MakerNote 0x0220)")
        spec_blob = huff.as_bytes()
        o = raw_ifd.require(T.TAG_STRIP_OFFSETS).as_ints()[0]
        c = raw_ifd.require(T.TAG_STRIP_BYTE_COUNTS).as_ints()[0]
        payload = bytes(tf.data[o : o + c])
        from . import native

        if native.has_pef():
            raw = native.pef_decode(payload, height, width, spec_blob, tf.endian, bits)
        else:
            raw = pef_decode(
                payload, height, width, parse_huff_spec(spec_blob, tf.endian), bits
            )
    elif compression == 1:
        raw = tf.read_strips(raw_ifd)
    else:
        raise ValueError(f"PEF: unsupported compression {compression}")

    # MakerNote blacks arrive in (R, G1, G2, B) order; _normalize_host wants
    # grid positions TL, TR, BR, BL. Map through the CFA codes (0=R,1=G,2=B;
    # the first G in reading order takes G1's level, the second G2's).
    blacks_rggb = _mn_shorts(mn, MN_BLACK_POINT, 4) or [0, 0, 0, 0]
    per_color = {0: [blacks_rggb[0]], 1: [blacks_rggb[1], blacks_rggb[2]],
                 2: [blacks_rggb[3]]}
    grid = []  # reading order TL, TR, BL, BR
    for code in cfa_codes:
        pool = per_color[int(code)]
        grid.append(pool.pop(0) if len(pool) > 1 else pool[0])
    chan_black = np.array([grid[0], grid[1], grid[3], grid[2]], np.float64)

    white = float((1 << bits) - 1)
    sensor = _normalize_host(raw, chan_black, np.full(4, white))
    sensor = sensor[: sensor.shape[0] & ~1, : sensor.shape[1] & ~1]

    neutral = np.array([0.5, 1.0, 0.5], np.float64)
    wb = _mn_shorts(mn, MN_WHITE_POINT, 4)
    if wb and wb[0] > 0 and wb[3] > 0:
        g = (wb[1] + wb[2]) / 2.0 or 1.0
        neutral = np.array([g / wb[0], 1.0, g / wb[3]], np.float64)

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


# --- synthetic fixture writer ------------------------------------------------------------
def write_synthetic_pef(
    bayer_u16: np.ndarray,
    bits: int = 12,
    model: bytes = b"PENTAX SYNTH",
    wb_rggb: Tuple[int, int, int, int] = (18000, 8192, 8192, 11000),
    black_rggb: Tuple[int, int, int, int] = (32, 33, 34, 35),
    cfa: Tuple[int, int, int, int] = (0, 1, 1, 2),
    uncompressed: bool = False,
) -> bytes:
    """Assemble a structurally faithful little-endian PEF test fixture.

    Raw IFD with compression 65535 (or 1), AOC MakerNote carrying black point
    0x0200, white point 0x0201 and the Huffman spec 0x0220; EXIF triplet for EV.
    """
    h, w = bayer_u16.shape
    assert h % 2 == 0 and w % 2 == 0
    E = "<"

    if uncompressed:
        # 12-bit samples are stored as a packed big-endian bitstream (the TIFF
        # reader's convention for bits < 16)
        blob = T._pack_bits(np.asarray(bayer_u16, np.uint16).reshape(-1), bits)
        spec_blob, _ = make_huff_spec(endian=E)
        compression = 1
    else:
        spec_blob, spec = make_huff_spec(endian=E)
        blob = pef_encode(np.ascontiguousarray(bayer_u16, np.uint16), spec)
        compression = PEF_COMPRESSION

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    HDR = 8
    ifd0_n, sub_n, exif_n, mn_n = 4, 9, 4, 3
    off_ifd0 = HDR
    off_sub = off_ifd0 + sz(ifd0_n)
    off_exif = off_sub + sz(sub_n)
    off_heap = off_exif + sz(exif_n)

    make_b = b"PENTAX Corporation\x00"
    model_b = model + b"\x00"
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b + (b"\x00" if len(make_b) % 2 else b"")
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 160)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 40, 10)

    # MakerNote: AOC + order marker + IFD (offsets relative to TIFF base)
    off_mn = off_heap + len(heap)
    mn_ifd_off = off_mn + 6
    mn_heap = mn_ifd_off + sz(mn_n)
    off_black = mn_heap
    off_wb = off_black + 8
    off_spec = off_wb + 8
    mn = b"AOC\x00" + (b"II" if E == "<" else b"MM")
    mn += struct.pack(E + "H", mn_n)
    mn += entry(MN_BLACK_POINT, T.TYPE_SHORT, 4, struct.pack(E + "L", off_black))
    mn += entry(MN_WHITE_POINT, T.TYPE_SHORT, 4, struct.pack(E + "L", off_wb))
    mn += entry(
        MN_HUFF_TABLE, T.TYPE_UNDEFINED, len(spec_blob), struct.pack(E + "L", off_spec)
    )
    mn += struct.pack(E + "L", 0)
    mn += struct.pack(E + "4H", *black_rggb)
    mn += struct.pack(E + "4H", *wb_rggb)
    mn += spec_blob
    heap += mn + (b"\x00" if len(mn) % 2 else b"")
    off_blob = off_heap + len(heap)

    out = struct.pack(E + "2sHL", b"II", 42, off_ifd0)
    out += struct.pack(E + "H", ifd0_n)
    out += entry(T.TAG_MAKE, T.TYPE_ASCII, len(make_b), struct.pack(E + "L", off_make))
    out += entry(T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack(E + "L", off_model))
    out += entry(T.TAG_SUB_IFD, T.TYPE_LONG, 1, struct.pack(E + "L", off_sub))
    out += entry(T.TAG_EXIF_IFD, T.TYPE_LONG, 1, struct.pack(E + "L", off_exif))
    out += struct.pack(E + "L", 0)

    out += struct.pack(E + "H", sub_n)
    out += entry(T.TAG_IMAGE_WIDTH, T.TYPE_LONG, 1, struct.pack(E + "L", w))
    out += entry(T.TAG_IMAGE_LENGTH, T.TYPE_LONG, 1, struct.pack(E + "L", h))
    out += entry(T.TAG_BITS_PER_SAMPLE, T.TYPE_SHORT, 1, inline("H", bits))
    out += entry(T.TAG_COMPRESSION, T.TYPE_SHORT, 1, inline("H", compression))
    out += entry(T.TAG_PHOTOMETRIC, T.TYPE_SHORT, 1, inline("H", T.PHOTOMETRIC_CFA))
    out += entry(T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 1, struct.pack(E + "L", off_blob))
    out += entry(
        T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 1, struct.pack(E + "L", len(blob))
    )
    out += entry(T.TAG_CFA_REPEAT_PATTERN_DIM, T.TYPE_SHORT, 2, inline("HH", 2, 2))
    out += entry(T.TAG_CFA_PATTERN, T.TYPE_BYTE, 4, bytes(cfa))
    out += struct.pack(E + "L", 0)

    out += struct.pack(E + "H", exif_n)
    out += entry(T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp))
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    out += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 200))
    out += entry(
        TAG_MAKER_NOTE, T.TYPE_UNDEFINED, len(mn), struct.pack(E + "L", off_mn)
    )
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out
