"""Samsung SRW host-side decode — no libraw.

Tenth built-in raw format; the reference opens SRW through libraw
(reference/image.py:224). Pieces (published dcraw/libraw
``samsung_load_raw`` semantics — the NX mirrorless generation,
compression 32770 — reimplemented):

- Container: a standard TIFF whose IFD0 carries Make = SAMSUNG; the raw
  IFD is photometric CFA with Compression 32770. Tag 0xA010 holds the
  absolute file offset of a per-row u32 table; each entry is the row's
  bitstream offset relative to the raw IFD's StripOffsets (dcraw's
  ``fseek(data_offset + get4())``). Tags 0xA021 / 0xA028 hold the WB
  multipliers / per-channel black levels as 4 u32 in R, G1, G2, B order
  (dcraw's ``cam_mul[c ^ (c >> 1)]`` / ``cblack[c ^ (c >> 1)]`` reads).
- Bitstream: dcraw's ph1_bits with order 0x4949 — the stream is a
  sequence of little-endian u32 words consumed MSB-first within each
  word. Rows are independent (fresh reader per row offset).
- Row coding: 16-pixel blocks. Each block: 1 dir bit (0 = predict from
  the same-parity pixel two columns left, 128 at the first block; 1 =
  predict from two rows up), then four 2-bit opcodes adjusting four
  residual bit-lengths (one per (parity, half) group: evens of cols
  0-7, evens of 8-15, odds of 0-7, odds of 8-15), opcode 3 followed by
  a 4-bit replacement length per flagged group (in group order). The 16
  residuals follow — even columns first, then odd — as sign-extended
  ``len``-bit values. Lengths start at 7 for the first two rows, 4
  after.
- Post-pass: dcraw swaps RAW(r, c+1) <-> RAW(r+1, c) over even (r, c) —
  the stream stores each 2x2's TR/BL photosites exchanged.

Divergences from dcraw (DIVERGENCES.md): dir=1 on rows 0-1 predicts 128
instead of reading out of bounds; decoded values clamp to
``[0, 2^bits - 1]``; a group length driven outside [0, 16] raises a
clean ValueError. Like the other built-in codecs, validation is against
our own encoder plus hand-built bitstream vectors (no real SRW files
exist in this environment).
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

SRW_COMPRESSION = 32770
TAG_STRIP_TABLE = 0xA010
TAG_WB_RGGB = 0xA021
TAG_BLACK_RGGB = 0xA028
TAG_DNG_VERSION = 0xC612


def _read_head(source: Source, n: int) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read(n)
    return bytes(source[:n])


def is_srw(source: Source) -> bool:
    """SRW: TIFF with a SAMSUNG Make, a raw IFD, and no DNGVersion."""
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
    if make is None or not make.as_bytes().upper().startswith(b"SAMSUNG"):
        return False
    if tf.ifds[0].get(TAG_DNG_VERSION) is not None:
        return False
    return _find_raw_ifd(tf) is not None


def _find_raw_ifd(tf: T.TiffFile) -> Optional[T.Ifd]:
    ifd = tf.find_raw_ifd()
    if ifd is not None:
        return ifd
    # real SRWs may omit the CFA photometric tag: fall back to compression
    for cand in tf.ifds:
        comp = cand.get(T.TAG_COMPRESSION)
        if comp is not None and comp.as_ints()[0] == SRW_COMPRESSION:
            return cand
        sub = getattr(cand, "sub_ifds", None) or []
        for s in sub:
            comp = s.get(T.TAG_COMPRESSION)
            if comp is not None and comp.as_ints()[0] == SRW_COMPRESSION:
                return s
    return None


# --- ph1-style bitstream (LE u32 words, MSB-first within each word) ---------------------
class _SamsungBits:
    """dcraw ph1_bits(order 0x4949): 64-bit window over little-endian u32
    words, bits taken MSB-first; zero-fill past the end of the payload."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.vbits = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        while self.vbits < n:
            chunk = self.data[self.pos : self.pos + 4]
            if len(chunk) < 4:
                chunk = chunk + b"\x00" * (4 - len(chunk))
            (word,) = struct.unpack("<L", chunk)
            self.pos += 4
            self.bitbuf = ((self.bitbuf << 32) | word) & 0xFFFFFFFFFFFFFFFF
            self.vbits += 32
        v = (self.bitbuf >> (self.vbits - n)) & ((1 << n) - 1)
        self.vbits -= n
        return v


def _group_index(c: int) -> int:
    """(parity, half) group of in-block pixel c: evens 0-7 / evens 8-15 /
    odds 0-7 / odds 8-15 (dcraw's ``((c & 1) << 1) | (c >> 3)``)."""
    return ((c & 1) << 1) | (c >> 3)


def srw_decode(
    data: bytes, row_offsets: np.ndarray, data_offset: int,
    height: int, width: int, bits: int = 12,
) -> np.ndarray:
    """Decode the compressed rows to (height, width) uint16 STORED values
    (pre-swap; apply samsung_swap for the mosaic)."""
    if width % 16:
        raise ValueError("SRW: width must be a multiple of 16")
    out = np.zeros((height, width), np.int32)
    lim = (1 << bits) - 1
    for row in range(height):
        br = _SamsungBits(data, data_offset + int(row_offsets[row]))
        lens = [7 if row < 2 else 4] * 4
        for col in range(0, width, 16):
            dir_ = br.get(1)
            ops = [br.get(2) for _ in range(4)]
            for g, op in enumerate(ops):
                if op == 3:
                    lens[g] = br.get(4)
                elif op == 2:
                    lens[g] -= 1
                elif op == 1:
                    lens[g] += 1
                if not 0 <= lens[g] <= 16:
                    raise ValueError(f"SRW: group bit-length {lens[g]} out of range")
            c = 0
            while c < 16:
                i = lens[_group_index(c)]
                v = br.get(i)
                diff = v - (1 << i) if i and (v >> (i - 1)) & 1 else v
                if dir_:
                    pred = int(out[row - 2, col + c]) if row >= 2 else 128
                else:
                    pred = int(out[row, col + c - 2]) if col else 128
                out[row, col + c] = min(max(pred + diff, 0), lim)
                if c == 14:
                    c = -1
                c += 2
    return out.astype(np.uint16)


def samsung_swap(raw: np.ndarray) -> np.ndarray:
    """dcraw's post-pass: exchange each 2x2's TR/BL photosites (involution)."""
    out = raw.copy()
    tr = out[0::2, 1::2].copy()
    out[0::2, 1::2] = out[1::2, 0::2]
    out[1::2, 0::2] = tr
    return out


# --- encoder (test fixtures) -------------------------------------------------------------
class _SamsungBitWriter:
    def __init__(self):
        self.acc = 0
        self.n = 0
        self.words: List[int] = []

    def put(self, value: int, nbits: int):
        for k in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> k) & 1)
            self.n += 1
            if self.n == 32:
                self.words.append(self.acc)
                self.acc = 0
                self.n = 0

    def done(self) -> bytes:
        if self.n:
            self.words.append(self.acc << (32 - self.n))
            self.acc = 0
            self.n = 0
        return b"".join(struct.pack("<L", w) for w in self.words)


def _need_bits(diff: int) -> int:
    """Smallest i with -2^(i-1) <= diff <= 2^(i-1) - 1."""
    if diff == 0:
        return 0
    return (diff.bit_length() if diff > 0 else (-diff - 1).bit_length()) + 1


def srw_encode(stored: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Inverse of srw_decode: (payload, per-row u32 offsets). ``stored`` is
    the pre-swap array (samsung_swap of the desired mosaic)."""
    h, w = stored.shape
    if w % 16:
        raise ValueError("SRW encode: width must be a multiple of 16")
    vals = stored.astype(np.int64)
    payload = bytearray()
    offsets = np.zeros(h, np.uint32)
    for row in range(h):
        offsets[row] = len(payload)
        bw = _SamsungBitWriter()
        lens = [7 if row < 2 else 4] * 4
        for col in range(0, w, 16):
            # per-pixel residuals for both predictors
            def diffs(dir_):
                out = []
                c = 0
                while c < 16:
                    t = int(vals[row, col + c])
                    if dir_:
                        pred = int(vals[row - 2, col + c]) if row >= 2 else 128
                    else:
                        pred = int(vals[row, col + c - 2]) if col else 128
                    out.append((c, t - pred))
                    if c == 14:
                        c = -1
                    c += 2
                return out

            cands = []
            for dir_ in (0, 1):
                ds = diffs(dir_)
                needs = [0, 0, 0, 0]
                for c, d in ds:
                    g = _group_index(c)
                    needs[g] = max(needs[g], _need_bits(d))
                cost = sum(
                    needs[_group_index(c)] for c, _ in ds
                )
                cands.append((cost, dir_, ds, needs))
            cands.sort(key=lambda t: (t[0], t[1]))
            _, dir_, ds, needs = cands[0]

            ops = []
            new_lens = list(lens)
            for g in range(4):
                need, cur = needs[g], lens[g]
                if need == cur:
                    ops.append((0, None))
                elif need == cur + 1:
                    ops.append((1, None))
                    new_lens[g] = cur + 1
                elif need == cur - 1:
                    ops.append((2, None))
                    new_lens[g] = cur - 1
                else:
                    ops.append((3, need))
                    new_lens[g] = need
            bw.put(dir_, 1)
            for op, _arg in ops:
                bw.put(op, 2)
            for op, arg in ops:
                if op == 3:
                    bw.put(arg, 4)
            lens = new_lens
            for c, d in ds:
                i = lens[_group_index(c)]
                bw.put(d & ((1 << i) - 1), i)
        payload += bw.done()
    return bytes(payload), offsets


# --- loader ------------------------------------------------------------------------------
def load_raw_srw(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode an SRW into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import _decode_pattern, _normalize_host, frame_from_parts

    tf = T.read_tiff(source)
    raw_ifd = _find_raw_ifd(tf)
    if raw_ifd is None:
        raise ValueError("SRW: no raw IFD found")

    width = raw_ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    height = raw_ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    from .raw_loader import check_decode_dims

    check_decode_dims(height, width)
    bits_tag = raw_ifd.get(T.TAG_BITS_PER_SAMPLE)
    bits = bits_tag.as_ints()[0] if bits_tag is not None else 12
    comp_tag = raw_ifd.get(T.TAG_COMPRESSION)
    compression = comp_tag.as_ints()[0] if comp_tag is not None else 1

    cfa = raw_ifd.get(T.TAG_CFA_PATTERN)
    if cfa is not None:
        cfa_codes = list(
            cfa.as_bytes() if isinstance(cfa.values, bytes) else cfa.as_ints()
        )[:4]
    else:
        # dcraw hard-codes the NX pattern when the tag is absent
        cfa_codes = [1, 0, 2, 1]  # GRBG
    pattern = _decode_pattern(cfa_codes)

    if compression == SRW_COMPRESSION:
        table_tag = _tag_in_any_ifd(tf, TAG_STRIP_TABLE)
        if table_tag is None:
            raise ValueError("SRW: missing strip-offset table tag 0xA010")
        table_off = table_tag.as_ints()[0]
        data_offset = raw_ifd.require(T.TAG_STRIP_OFFSETS).as_ints()[0]
        if table_off + 4 * height > len(tf.data):
            raise ValueError("SRW: strip-offset table overruns the file")
        row_offsets = np.frombuffer(tf.data, "<u4" if tf.endian == "<" else ">u4",
                                    height, table_off)
        from . import native

        if native.has_srw():
            raw = native.srw_decode(
                bytes(tf.data), row_offsets.astype(np.uint32), data_offset,
                height, width, bits,
            )
        else:
            raw = srw_decode(
                bytes(tf.data), row_offsets, data_offset, height, width, bits
            )
        raw = samsung_swap(raw)
    elif compression == 1:
        raw = tf.read_strips(raw_ifd)
    else:
        raise ValueError(f"SRW: unsupported compression {compression}")

    blacks_rggb = _tag_ints(tf, TAG_BLACK_RGGB, 4) or [0, 0, 0, 0]
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
    wb = _tag_ints(tf, TAG_WB_RGGB, 4)
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


def _tag_in_any_ifd(tf: T.TiffFile, tag: int) -> Optional[T.TiffTag]:
    for ifd in tf.ifds:
        e = ifd.get(tag)
        if e is not None:
            return e
        for s in getattr(ifd, "sub_ifds", None) or []:
            e = s.get(tag)
            if e is not None:
                return e
    return None


def _tag_ints(tf: T.TiffFile, tag: int, n: int) -> Optional[List[int]]:
    e = _tag_in_any_ifd(tf, tag)
    if e is None:
        return None
    vals = e.as_ints()
    return list(vals[:n]) if len(vals) >= n else None


# --- synthetic fixture writer ------------------------------------------------------------
def write_synthetic_srw(
    mosaic_u16: np.ndarray,
    bits: int = 12,
    model: bytes = b"NX SYNTH",
    wb_rggb: Tuple[int, int, int, int] = (580, 302, 302, 388),
    black_rggb: Tuple[int, int, int, int] = (60, 61, 62, 63),
    cfa: Tuple[int, int, int, int] = (1, 0, 2, 1),
    uncompressed: bool = False,
) -> bytes:
    """Assemble a structurally faithful little-endian SRW test fixture.

    ``mosaic_u16`` is the FINAL mosaic; the writer applies the TR/BL swap
    before encoding so load_raw_srw round-trips it exactly.
    """
    h, w = mosaic_u16.shape
    assert h % 2 == 0 and w % 16 == 0
    E = "<"

    if uncompressed:
        # bits < 16 strips follow the TIFF big-endian packed-bit convention
        blob = T._pack_bits(np.asarray(mosaic_u16, np.uint16).reshape(-1), bits)
        table = b""
        compression = 1
    else:
        stored = samsung_swap(np.ascontiguousarray(mosaic_u16, np.uint16))
        blob, offsets = srw_encode(stored)
        table = offsets.astype("<u4").tobytes()
        compression = SRW_COMPRESSION

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    HDR = 8
    ifd0_n, exif_n = 4, 3
    sub_n = 9 + (0 if uncompressed else 1) + 2  # +0xA010, +WB +blacks
    off_ifd0 = HDR
    off_sub = off_ifd0 + sz(ifd0_n)
    off_exif = off_sub + sz(sub_n)
    off_heap = off_exif + sz(exif_n)

    make_b = b"SAMSUNG\x00"
    model_b = model + b"\x00"
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b + (b"\x00" if len(make_b) % 2 else b"")
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 180)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 28, 10)
    off_wb = off_heap + len(heap)
    heap += struct.pack(E + "4L", *wb_rggb)
    off_black = off_heap + len(heap)
    heap += struct.pack(E + "4L", *black_rggb)
    off_table = off_heap + len(heap)
    heap += table
    off_blob = off_heap + len(heap)

    out = struct.pack(E + "2sHL", b"II", 42, off_ifd0)
    out += struct.pack(E + "H", ifd0_n)
    out += entry(T.TAG_MAKE, T.TYPE_ASCII, len(make_b), struct.pack(E + "L", off_make))
    out += entry(
        T.TAG_MODEL, T.TYPE_ASCII, len(model_b), struct.pack(E + "L", off_model)
    )
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
    if not uncompressed:
        out += entry(TAG_STRIP_TABLE, T.TYPE_LONG, 1, struct.pack(E + "L", off_table))
    out += entry(TAG_WB_RGGB, T.TYPE_LONG, 4, struct.pack(E + "L", off_wb))
    out += entry(TAG_BLACK_RGGB, T.TYPE_LONG, 4, struct.pack(E + "L", off_black))
    out += entry(T.TAG_CFA_REPEAT_PATTERN_DIM, T.TYPE_SHORT, 2, inline("HH", 2, 2))
    out += entry(T.TAG_CFA_PATTERN, T.TYPE_BYTE, 4, bytes(cfa))
    out += struct.pack(E + "L", 0)

    out += struct.pack(E + "H", exif_n)
    out += entry(T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp))
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    out += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 200))
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out
