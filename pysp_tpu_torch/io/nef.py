"""Nikon NEF host-side decode — no libraw.

Second native non-DNG format (after io/cr2.py); the reference opens NEF through
libraw (image.py:224). Pieces:

- TIFF container (usually big-endian): the raw lives in a SubIFD marked
  photometric CFA with compression 34713 (Nikon compressed) or 1.
- Compressed payload: per-pixel Huffman prediction residuals decoded by the
  native codec (native/dng_fast.cc nef_decode); which of the six canonical
  trees applies is keyed by the MakerNote metadata blob (tag 0x0096): version
  bytes select lossy/lossless, BitsPerSample selects 12/14-bit, and lossy
  type-2 files switch trees at a split row. The blob also carries the two-row
  vertical predictor seeds and the linearization curve.
- MakerNote: "Nikon\\x00" header + an embedded TIFF whose entry offsets are
  relative to that embedded header — parsed by slicing the file at the base.
- WB: MakerNote 0x000C WB_RBLevels (R, B, G1, G2 multipliers).
- Color matrices: io/camera_matrices registry by model, Rec.709 fallback
  (same divergence note as CR2, DIVERGENCES.md).

Black level 0 and white level = the linearization curve's last entry (Nikon
bodies clamp black on-sensor for the formats handled here) — DIVERGENCES.md.
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
NEF_COMPRESSION = 34713
MN_WB_RB_LEVELS = 0x000C
MN_NEF_META = 0x0096


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_nef(source: Source) -> bool:
    """NEF: TIFF whose IFD0 Make starts with NIKON and that has a CFA SubIFD."""
    try:
        tf = T.read_tiff(source)
    except (ValueError, struct.error):
        return False
    if not tf.ifds:
        return False
    make = tf.ifds[0].get(T.TAG_MAKE)
    if make is None or not make.as_bytes().upper().startswith(b"NIKON"):
        return False
    return tf.find_raw_ifd() is not None


def _parse_nikon_makernote(
    tf: T.TiffFile,
) -> Optional[Tuple[T.Ifd, bytes, str]]:
    """(ifd, base_data, endian): the embedded TIFF starts 10 bytes into the
    MakerNote value; internal offsets are relative to that base."""
    for ifd in tf.ifds:
        exif = ifd.exif_ifd
        if exif is None:
            continue
        mn = exif.get(TAG_MAKER_NOTE)
        if mn is None or mn.value_offset is None:
            continue
        payload = mn.as_bytes()
        if not payload.startswith(b"Nikon\x00"):
            return None
        base = mn.value_offset + 10
        data = tf.data[base:]
        if data[:2] == b"II":
            endian = "<"
        elif data[:2] == b"MM":
            endian = ">"
        else:
            return None
        (off,) = struct.unpack_from(endian + "L", data, 4)
        try:
            parsed, _ = T._parse_ifd(data, endian, off)
        except (struct.error, IndexError, ValueError):
            return None
        return parsed, data, endian
    return None


def _parse_nef_meta(
    blob: bytes, endian: str, bits: int
) -> Tuple[int, np.ndarray, int, np.ndarray]:
    """(tree_idx, vpred[4], split_row, curve) from the 0x0096 metadata blob."""
    ver0, ver1 = blob[0], blob[1]
    tree = 0
    if ver0 == 0x46:
        tree = 2
    if bits == 14:
        tree += 3

    vpred = np.array(struct.unpack_from(endian + "4H", blob, 2), np.uint16)
    (csize,) = struct.unpack_from(endian + "H", blob, 10)

    max_v = min(1 << bits, 0x4000)
    curve = np.arange(max_v, dtype=np.uint16)
    split = 0
    if ver0 == 0x44 and ver1 in (0x20, 0x40) and csize > 1:
        # lossy type 2: sparse curve at a fixed step + tree split row
        step = max_v // (csize - 1)
        if step > 0:
            pts = np.frombuffer(blob, dtype=np.dtype(endian + "u2"),
                                count=csize, offset=12).astype(np.float64)
            xs = np.arange(csize) * step
            curve = np.interp(
                np.arange(max_v), xs, pts
            ).astype(np.uint16)
        if len(blob) >= 564:
            (split,) = struct.unpack_from(endian + "H", blob, 562)
    elif ver0 != 0x46 and 1 < csize <= 0x4001:
        curve = np.frombuffer(
            blob, dtype=np.dtype(endian + "u2"), count=csize, offset=12
        ).copy()
    return tree, vpred, split, curve


def load_raw_nef(source: Source, color_mats=None, device=CARD) -> RawFrame:
    """Decode a NEF into a canonical RawFrame."""
    from ..colorimetry.wb import CameraWhiteBalanceController
    from .metadata import compute_ev_from_tiff
    from .raw_loader import _decode_pattern, _normalize_host, frame_from_parts

    tf = T.read_tiff(source)
    raw_ifd = tf.find_raw_ifd()
    if raw_ifd is None:
        raise ValueError("NEF: no CFA raw IFD found")

    cfa = raw_ifd.get(T.TAG_CFA_PATTERN)
    if cfa is None:
        raise ValueError("NEF: raw IFD has no CFA pattern")
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

    mn = _parse_nikon_makernote(tf)

    if compression == NEF_COMPRESSION:
        if mn is None:
            raise ValueError("NEF: compressed file without a Nikon MakerNote")
        mn_ifd, _, mn_endian = mn
        meta = mn_ifd.get(MN_NEF_META)
        if meta is None or len(meta.as_bytes()) < 12:
            raise ValueError("NEF: missing compression metadata (tag 0x0096)")
        tree, vpred, split, curve = _parse_nef_meta(
            meta.as_bytes(), mn_endian, bits
        )
        from . import native

        if not native.available():
            raise ValueError(
                "NEF decode needs the native codec, which did not build (see the warning)"
            )
        o = raw_ifd.require(T.TAG_STRIP_OFFSETS).as_ints()[0]
        c = raw_ifd.require(T.TAG_STRIP_BYTE_COUNTS).as_ints()[0]
        raw = native.nef_decode(
            bytes(tf.data[o : o + c]), height, width, tree, vpred, split, curve
        )
        white = float(curve.max())
    else:
        raw = tf.read_strips(raw_ifd)
        white = float((1 << bits) - 1)

    sensor = _normalize_host(raw, np.zeros(4), np.full(4, white))
    sensor = sensor[: sensor.shape[0] & ~1, : sensor.shape[1] & ~1]

    neutral = np.array([0.5, 1.0, 0.5], np.float64)
    if mn is not None:
        wb_tag = mn[0].get(MN_WB_RB_LEVELS)
        if wb_tag is not None and len(wb_tag.as_floats()) >= 4:
            r_mul, b_mul, g1, g2 = wb_tag.as_floats()[:4]
            g = (g1 + g2) / 2.0 or 1.0
            if r_mul > 0 and b_mul > 0:
                neutral = np.array([g / r_mul, 1.0, g / b_mul], np.float64)

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
def write_synthetic_nef(
    bayer_u16: np.ndarray,
    bits: int = 14,
    model: bytes = b"NIKON SYNTH",
    wb_rb: Tuple[float, float] = (2.0, 1.4),
    cfa: Tuple[int, int, int, int] = (0, 1, 1, 2),
    curve: Optional[np.ndarray] = None,
) -> bytes:
    """Assemble a structurally faithful big-endian NEF (test fixture).

    Raw SubIFD with compression 34713, Nikon MakerNote with the 0x0096 metadata
    blob (lossless tree version 0x46) and 0x000C WB levels. ``curve`` (optional
    u16 LUT) exercises the non-identity linearization path: stored values index
    it, so ``bayer_u16`` must hold the *stored* (pre-curve) values then.
    """
    from . import native

    if not native.available():
        raise RuntimeError("write_synthetic_nef needs the native codec")
    h, w = bayer_u16.shape
    assert h % 2 == 0 and w % 2 == 0
    # versions and trees must agree with the reader's selection: 0x46 -> lossless
    # trees (2/5, identity curve); 0x44 -> lossy trees (0/3) + explicit curve
    if curve is None:
        tree = 5 if bits == 14 else 2
    else:
        tree = 3 if bits == 14 else 0
    vpred = np.array([1 << (bits - 1)] * 4, np.uint16)
    blob = native.nef_encode(np.ascontiguousarray(bayer_u16, np.uint16), tree, vpred)

    E = ">"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    # ---- MakerNote block (self-contained; offsets relative to embedded TIFF) ----
    mn_n = 2
    emb_ifd_off = 8
    emb_heap = emb_ifd_off + sz(mn_n)
    # heap: WB rationals (4x8), meta blob
    wb_off = emb_heap
    if curve is None:
        csize = 1
        meta_blob = struct.pack(E + "BB4HH", 0x46, 0x30, *vpred.tolist(), csize)
    else:
        curve = np.ascontiguousarray(curve, np.uint16)
        csize = curve.size
        meta_blob = struct.pack(
            E + "BB4HH", 0x44, 0x10, *vpred.tolist(), csize
        ) + struct.pack(E + "%dH" % csize, *curve.tolist())
    meta_off = wb_off + 32
    emb = struct.pack(E + "2sHL", b"MM", 42, emb_ifd_off)
    emb += struct.pack(E + "H", mn_n)
    emb += entry(MN_WB_RB_LEVELS, T.TYPE_RATIONAL, 4, struct.pack(E + "L", wb_off))
    emb += entry(
        MN_NEF_META, T.TYPE_UNDEFINED, len(meta_blob), struct.pack(E + "L", meta_off)
    )
    emb += struct.pack(E + "L", 0)
    r, b_ = wb_rb
    emb += struct.pack(
        E + "8L", int(r * 1000), 1000, int(b_ * 1000), 1000, 1, 1, 1, 1
    )
    emb += meta_blob
    makernote = b"Nikon\x00\x02\x10\x00\x00" + emb

    # ---- main container ----
    HDR = 8
    ifd0_n, sub_n, exif_n = 4, 9, 4
    off_ifd0 = HDR
    off_sub = off_ifd0 + sz(ifd0_n)
    off_exif = off_sub + sz(sub_n)
    off_heap = off_exif + sz(exif_n)

    model_b = model + b"\x00"
    make_b = b"NIKON CORPORATION\x00"
    heap = b""
    off_make = off_heap + len(heap)
    heap += make_b
    off_model = off_heap + len(heap)
    heap += model_b + (b"\x00" if len(model_b) % 2 else b"")
    off_exp = off_heap + len(heap)
    heap += struct.pack(E + "LL", 1, 125)
    off_fnum = off_heap + len(heap)
    heap += struct.pack(E + "LL", 28, 10)
    off_mn = off_heap + len(heap)
    heap += makernote + (b"\x00" if len(makernote) % 2 else b"")
    off_blob = off_heap + len(heap)

    out = struct.pack(E + "2sHL", b"MM", 42, off_ifd0)
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
    out += entry(T.TAG_COMPRESSION, T.TYPE_SHORT, 1, inline("H", NEF_COMPRESSION))
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
        TAG_MAKER_NOTE, T.TYPE_UNDEFINED, len(makernote), struct.pack(E + "L", off_mn)
    )
    out += struct.pack(E + "L", 0)

    out += heap
    assert len(out) == off_blob, (len(out), off_blob)
    out += blob
    return out
