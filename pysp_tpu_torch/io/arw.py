"""Sony ARW host-side decode — no libraw.

Third native non-DNG format (after io/cr2.py and io/nef.py); the reference opens
ARW through libraw (image.py:224). Pieces:

- TIFF container (little-endian): the raw lives in the IFD marked photometric
  CFA, with compression 1 (uncompressed 16-bit strips) or 32767 (Sony "ARW2"
  delta blocks).
- ARW2 payload: 1 byte/pixel — each 16-byte little-endian block carries 16
  photosites of one column parity across a 32-column span: an 11-bit max and
  min, their 4-bit positions, and fourteen 7-bit deltas starting at bit 30,
  scaled by a shift derived from (max - min). Blocks alternate even/odd column
  parity. Decoded 11-bit values are linearized through the Sony tone curve
  (MakerNote tag 0x7010: four knot points; slope doubles per segment, indexed
  at value<<1 — the dcraw/rawspeed-documented construction).
- MakerNote: "SONY DSC \\x00\\x00\\x00" header + a plain IFD whose offsets are
  file-absolute (unlike Nikon's embedded-TIFF scheme).
- WB: MakerNote 0x7313 WB_RGGBLevels (R, G, G, B channel multipliers).
- Black level: MakerNote 0x7310 (per-channel, typically 512).
- Color matrices: io/camera_matrices registry by model, Rec.709 fallback
  (same divergence note as CR2/NEF, DIVERGENCES.md).

Sony's newest lossless-compressed ARW (compression 7) is not handled here;
those files fall through to the optional rawpy path in raw_loader.
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

TAG_MAKER_NOTE = 0x927C
ARW2_COMPRESSION = 32767
MN_SONY_CURVE = 0x7010
MN_BLACK_LEVEL = 0x7310
MN_WB_RGGB_LEVELS = 0x7313


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_arw(source: Source) -> bool:
    """ARW: TIFF whose IFD0 Make starts with SONY and that has a CFA raw IFD."""
    try:
        tf = T.read_tiff(source)
    except (ValueError, struct.error):
        return False
    if not tf.ifds:
        return False
    make = tf.ifds[0].get(T.TAG_MAKE)
    if make is None or not make.as_bytes().upper().startswith(b"SONY"):
        return False
    return tf.find_raw_ifd() is not None


# --- ARW2 block codec -----------------------------------------------------------------
def _block_interleave(w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Column indices covered by (even-parity, odd-parity) blocks of a 32-col span."""
    base = 2 * np.arange(16)
    return base, base + 1


def arw2_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """Unpack ARW2 delta blocks into (h, w) uint16 stored values (11-bit).

    Vectorized over all blocks: one 16-byte block -> 16 photosites of one column
    parity in a 32-column span; blocks alternate parity along the row.
    """
    if w % 32:
        raise ValueError("ARW2 decode requires width % 32 == 0")
    need = h * w
    buf = np.frombuffer(data, np.uint8)
    if buf.size < need:
        raise ValueError("ARW2 strip shorter than height*width bytes")
    blocks = buf[:need].reshape(h, w // 16, 16)

    b32 = blocks.astype(np.uint32)
    w0 = b32[..., 0] | b32[..., 1] << 8 | b32[..., 2] << 16 | b32[..., 3] << 24
    mx = w0 & 0x7FF
    mn = (w0 >> 11) & 0x7FF
    imax = (w0 >> 22) & 0xF
    imin = (w0 >> 26) & 0xF
    diff = mx - mn
    sh = (
        (diff >= 0x80).astype(np.uint32)
        + (diff >= 0x100)
        + (diff >= 0x200)
        + (diff >= 0x400)
    )

    # 7-bit deltas, LSB-first bit positions 30 + 7*j within the block. dcraw
    # skips the max position and, ONLY when distinct, the min position — so an
    # imax == imin block carries FIFTEEN deltas and the 15th read (bits
    # 128-134) crosses into the next block's first two bytes (dcraw keeps
    # walking dp+16; for the last block of a row it reads unwritten malloc
    # memory — defined here as zeros).
    nxt = np.zeros((h, w // 16, 2), np.uint8)
    nxt[:, :-1] = blocks[:, 1:, :2]
    padded = np.concatenate([blocks, nxt], axis=-1).astype(np.uint16)
    starts = 30 + 7 * np.arange(15)
    byte_i = starts >> 3
    bit_i = starts & 7
    lo = padded[..., byte_i]
    hi = padded[..., byte_i + 1]
    deltas = ((lo | hi << 8) >> bit_i) & 0x7F  # (h, nb, 15)

    # slot rank of index i among the delta-coded positions
    idx = np.arange(16)
    rank = (
        idx[None, None, :]
        - (imax[..., None] < idx[None, None, :])
        - (
            (imin[..., None] < idx[None, None, :])
            & (imax[..., None] != imin[..., None])
        )
    )
    rank = np.clip(rank, 0, 14)
    coded = mn[..., None] + (
        np.take_along_axis(deltas.astype(np.uint32), rank, axis=-1) << sh[..., None]
    )
    coded = np.minimum(coded, 0x7FF)
    pix = np.where(
        idx[None, None, :] == imax[..., None],
        mx[..., None],
        np.where(idx[None, None, :] == imin[..., None], mn[..., None], coded),
    ).astype(np.uint16)

    # re-interleave: even-parity block, then odd-parity block, per 32-col span
    out = np.empty((h, w // 32, 32), np.uint16)
    even, odd = _block_interleave(w)
    out[:, :, even] = pix[:, 0::2]
    out[:, :, odd] = pix[:, 1::2]
    return out.reshape(h, w)


def arw2_encode(values: np.ndarray) -> bytes:
    """Pack (h, w) 11-bit stored values into ARW2 blocks (synthetic fixtures).

    Encoding is lossy when a block's spread needs a shift: deltas keep the top
    7 bits of (v - min). max/min themselves are always exact.
    """
    h, w = values.shape
    if w % 32:
        raise ValueError("ARW2 encode requires width % 32 == 0")
    if values.max(initial=0) > 0x7FF:
        raise ValueError("ARW2 stores 11-bit values")
    v = values.reshape(h, w // 32, 32)
    even, odd = _block_interleave(w)
    blocks = np.empty((h, w // 16, 16), np.uint16)
    blocks[:, 0::2] = v[:, :, even]
    blocks[:, 1::2] = v[:, :, odd]

    out = bytearray()
    for blk in blocks.reshape(-1, 16):
        mx, mn = int(blk.max()), int(blk.min())
        imax = int(blk.argmax())
        rest = np.where(np.arange(16) == imax, 0x7FF + 1, blk.astype(np.int32))
        imin = int(rest.argmin())
        sh = 0
        while sh < 4 and (0x80 << sh) <= mx - mn:
            sh += 1
        word = mx | mn << 11 | imax << 22 | imin << 26
        acc = word
        bit = 30
        for i in range(16):
            if i == imax or i == imin:
                continue
            d = min(0x7F, (int(blk[i]) - mn) >> sh)
            acc |= d << bit
            bit += 7
        out += acc.to_bytes(16, "little")
    return bytes(out)


def sony_curve_table(knots4: Optional[np.ndarray]) -> np.ndarray:
    """Linearization LUT over 12-bit indices from MakerNote 0x7010 knot points.

    Segment slope doubles at each knot (1, 2, 4, 8, 16) — the construction
    dcraw/rawspeed document for the Sony tone curve. Stored 11-bit values index
    the table at value << 1.
    """
    bounds = [0, 0, 0, 0, 0, 0xFFF]
    if knots4 is not None and len(knots4) >= 4:
        for i in range(4):
            bounds[i + 1] = (int(knots4[i]) >> 2) & 0xFFF
    table = np.zeros(0x1000, np.uint32)
    for seg in range(5):
        j0, j1 = bounds[seg], bounds[seg + 1]
        if j1 <= j0:
            continue
        js = np.arange(j0 + 1, j1 + 1)
        table[js] = table[j0] + (js - j0) * (1 << seg)
    # flat tail beyond the last knot keeps the table monotone-complete
    if bounds[5] < 0xFFF:
        table[bounds[5] + 1 :] = table[bounds[5]]
    return table


# --- container ------------------------------------------------------------------------
def _parse_sony_makernote(tf: T.TiffFile) -> Optional[T.Ifd]:
    """Sony MakerNote: 12-byte "SONY DSC" header + plain IFD with file-absolute
    offsets."""
    for ifd in tf.ifds:
        exif = ifd.exif_ifd
        if exif is None:
            continue
        mn = exif.get(TAG_MAKER_NOTE)
        if mn is None or mn.value_offset is None:
            continue
        payload = mn.as_bytes()
        if not payload.startswith(b"SONY DSC"):
            return None
        try:
            parsed, _ = T._parse_ifd(tf.data, tf.endian, mn.value_offset + 12)
        except (struct.error, IndexError, ValueError):
            return None
        return parsed
    return None


def load_raw_arw(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode an ARW into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import _decode_pattern, _normalize_host, frame_from_parts

    tf = T.read_tiff(source)
    raw_ifd = tf.find_raw_ifd()
    if raw_ifd is None:
        raise ValueError("ARW: no CFA raw IFD found")

    cfa = raw_ifd.get(T.TAG_CFA_PATTERN)
    if cfa is None:
        raise ValueError("ARW: raw IFD has no CFA pattern")
    pattern = _decode_pattern(
        list(cfa.as_bytes() if isinstance(cfa.values, bytes) else cfa.as_ints())[:4]
    )

    width = raw_ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    height = raw_ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    from .raw_loader import check_decode_dims

    check_decode_dims(height, width)
    bits = raw_ifd.require(T.TAG_BITS_PER_SAMPLE).as_ints()[0]
    comp_tag = raw_ifd.get(T.TAG_COMPRESSION)
    compression = comp_tag.as_ints()[0] if comp_tag is not None else 1

    mn_ifd = _parse_sony_makernote(tf)

    black = np.zeros(4)
    if mn_ifd is not None:
        bl = mn_ifd.get(MN_BLACK_LEVEL)
        if bl is not None and len(bl.as_ints()) >= 4:
            black = np.array(bl.as_ints()[:4], np.float64)

    if compression == ARW2_COMPRESSION:
        o = raw_ifd.require(T.TAG_STRIP_OFFSETS).as_ints()[0]
        c = raw_ifd.require(T.TAG_STRIP_BYTE_COUNTS).as_ints()[0]
        from . import native

        if native.has_arw2():
            stored = native.arw2_decode(bytes(tf.data[o : o + c]), height, width)
        else:
            stored = arw2_decode(bytes(tf.data[o : o + c]), height, width)
        knots = None
        if mn_ifd is not None:
            k = mn_ifd.get(MN_SONY_CURVE)
            if k is not None and len(k.as_ints()) >= 4:
                knots = np.array(k.as_ints()[:4], np.uint16)
        table = sony_curve_table(knots)
        raw = table[stored.astype(np.int64) << 1].astype(np.float64)
        white = float(table[0x7FF << 1])
        # ARW2 stores post-black-subtraction values; black was consumed on-camera
        black = np.zeros(4)
    elif compression == 1:
        raw = tf.read_strips(raw_ifd)
        white = float((1 << bits) - 1)
    else:
        raise ValueError(
            f"ARW: unsupported compression {compression} "
            "(Sony lossless needs the rawpy path)"
        )

    sensor = _normalize_host(raw, black, np.full(4, white))
    sensor = sensor[: sensor.shape[0] & ~1, : sensor.shape[1] & ~1]

    neutral = np.array([0.5, 1.0, 0.5], np.float64)
    if mn_ifd is not None:
        wb_tag = mn_ifd.get(MN_WB_RGGB_LEVELS)
        if wb_tag is not None and len(wb_tag.as_ints()) >= 4:
            r_lev, g_lev1, g_lev2, b_lev = [float(x) for x in wb_tag.as_ints()[:4]]
            g_lev = (g_lev1 + g_lev2) / 2.0 or 1.0
            if r_lev > 0 and b_lev > 0:
                neutral = np.array([g_lev / r_lev, 1.0, g_lev / b_lev], np.float64)

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
def write_synthetic_arw(
    stored11: np.ndarray,
    model: bytes = b"SONY SYNTH",
    wb_rggb: Tuple[int, int, int, int] = (2048, 1024, 1024, 1433),
    cfa: Tuple[int, int, int, int] = (0, 1, 1, 2),
    curve_knots: Optional[Tuple[int, int, int, int]] = None,
    black: Tuple[int, int, int, int] = (0, 0, 0, 0),
) -> bytes:
    """Assemble a structurally faithful little-endian ARW (test fixture).

    Raw SubIFD with compression 32767 holding ``stored11`` (11-bit pre-curve
    values) as ARW2 blocks, Sony MakerNote with WB_RGGBLevels/BlackLevel and an
    optional 0x7010 curve, and the EXIF triplet for EV.
    """
    h, w = stored11.shape
    assert h % 2 == 0 and w % 32 == 0
    blob = arw2_encode(np.ascontiguousarray(stored11, np.uint16))

    E = "<"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    HDR = 8
    ifd0_n, sub_n, exif_n = 4, 9, 4
    mn_n = 3 if curve_knots is not None else 2
    off_ifd0 = HDR
    off_sub = off_ifd0 + sz(ifd0_n)
    off_exif = off_sub + sz(sub_n)
    off_heap = off_exif + sz(exif_n)

    make_b = b"SONY\x00"
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
    off_mn = off_heap + len(heap)
    # MakerNote: header + IFD with FILE-absolute value offsets; the 4xSHORT
    # values (8 bytes each, too big for the inline field) live in a value heap
    # directly after the MakerNote IFD
    mn_tags = [(MN_BLACK_LEVEL, black)]
    if curve_knots is not None:
        mn_tags.append((MN_SONY_CURVE, curve_knots))
    mn_tags.append((MN_WB_RGGB_LEVELS, wb_rggb))
    mn_vals_off = off_mn + 12 + sz(mn_n)
    mn = struct.pack(E + "H", mn_n)
    for i, (tag, vals) in enumerate(mn_tags):
        mn += entry(
            tag, T.TYPE_SHORT, 4, struct.pack(E + "L", mn_vals_off + 8 * i)
        )
    mn += struct.pack(E + "L", 0)
    for _, vals in mn_tags:
        mn += struct.pack(E + "4H", *vals)
    makernote = b"SONY DSC \x00\x00\x00" + mn
    assert len(makernote) == 12 + sz(mn_n) + 8 * mn_n
    heap += makernote + (b"\x00" if len(makernote) % 2 else b"")
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
    out += entry(T.TAG_BITS_PER_SAMPLE, T.TYPE_SHORT, 1, inline("H", 12))
    out += entry(T.TAG_COMPRESSION, T.TYPE_SHORT, 1, inline("H", ARW2_COMPRESSION))
    out += entry(T.TAG_PHOTOMETRIC, T.TYPE_SHORT, 1, inline("H", T.PHOTOMETRIC_CFA))
    out += entry(T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 1, struct.pack(E + "L", off_blob))
    out += entry(
        T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 1, struct.pack(E + "L", len(blob))
    )
    out += entry(T.TAG_CFA_REPEAT_PATTERN_DIM, T.TYPE_SHORT, 2, inline("HH", 2, 2))
    out += entry(T.TAG_CFA_PATTERN, T.TYPE_BYTE, 4, bytes(cfa))
    out += struct.pack(E + "L", 0)

    out += struct.pack(E + "H", exif_n)
    out += entry(
        T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_exp)
    )
    out += entry(T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "L", off_fnum))
    out += entry(T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 200))
    out += entry(
        TAG_MAKER_NOTE, T.TYPE_UNDEFINED, len(makernote), struct.pack(E + "L", off_mn)
    )
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out
