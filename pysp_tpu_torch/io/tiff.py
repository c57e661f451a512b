"""Minimal TIFF/DNG container parser and writer (pure Python, host-side).

The reference leans on tifftools + exifread + libraw for metadata and decode
(image.py:75-141, wb_cct/helpers_exif.py, dng_warp_corr/chan_distortion_corr.py:123-146).
None of those ship in this environment, so this module implements the slice of TIFF 6.0
+ DNG 1.4 the framework needs:

- IFD chain walking with SubIFD recursion, both endians
- all scalar tag types incl. RATIONAL/SRATIONAL (decoded to Fraction-like floats)
- uncompressed strip reading (8/16-bit) for CFA data
- a writer that emits valid little-endian DNGs — used to build synthetic camera
  files for tests (SURVEY.md §4 metadata fixtures)

This layer is metadata plumbing, not performance-relevant; it stays pure Python.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from io import BytesIO
from typing import Any, BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from ..utils.tracing import count, span

# TIFF data types: id -> (struct fmt, size bytes)
_TYPES = {
    1: ("B", 1),   # BYTE
    2: ("c", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("L", 4),   # LONG
    5: ("LL", 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    7: ("B", 1),   # UNDEFINED
    8: ("h", 2),   # SSHORT
    9: ("l", 4),   # SLONG
    10: ("ll", 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
}

TYPE_BYTE = 1
TYPE_ASCII = 2
TYPE_SHORT = 3
TYPE_LONG = 4
TYPE_RATIONAL = 5
TYPE_UNDEFINED = 7
TYPE_SRATIONAL = 10
TYPE_DOUBLE = 12

# Tag ids used across the framework
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_MAKE = 271
TAG_MODEL = 272
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_SUB_IFD = 330
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_CFA_REPEAT_PATTERN_DIM = 33421
TAG_CFA_PATTERN = 33422
TAG_EXPOSURE_TIME = 33434
TAG_F_NUMBER = 33437
TAG_EXIF_IFD = 34665
TAG_ISO_SPEED = 34855
TAG_DNG_VERSION = 50706
TAG_LINEARIZATION_TABLE = 50712
TAG_BLACK_LEVEL_REPEAT_DIM = 50713
TAG_BLACK_LEVEL = 50714
TAG_WHITE_LEVEL = 50717
TAG_DEFAULT_CROP_ORIGIN = 50719
TAG_DEFAULT_CROP_SIZE = 50720
TAG_COLOR_MATRIX_1 = 50721
TAG_COLOR_MATRIX_2 = 50722
TAG_AS_SHOT_NEUTRAL = 50728
TAG_CALIBRATION_ILLUMINANT_1 = 50778
TAG_CALIBRATION_ILLUMINANT_2 = 50779
TAG_ACTIVE_AREA = 50829
TAG_OPCODE_LIST_1 = 51008
TAG_OPCODE_LIST_2 = 51009
TAG_OPCODE_LIST_3 = 51022

PHOTOMETRIC_CFA = 32803

# Decode-dimension sanity caps: a corrupted dimension field in a raw container
# must raise a clean ValueError, never trigger a multi-gigapixel allocation
# (mutation-fuzz flips header bytes across every built-in format). The largest
# real sensors are ~15k px/axis and ~150 MP; the caps leave generous headroom.
MAX_DECODE_DIM = 65_535
MAX_DECODE_PIXELS = 512 * 1024 * 1024  # 512 MP


def check_decode_dims(height, width) -> None:
    """Validate decoded sensor dimensions before any buffer allocation."""
    if height is None or width is None:
        raise ValueError("raw decode: missing dimension field")
    h, w = int(height), int(width)
    if h <= 0 or w <= 0:
        raise ValueError(f"raw decode: non-positive dimensions {h}x{w}")
    if h > MAX_DECODE_DIM or w > MAX_DECODE_DIM or h * w > MAX_DECODE_PIXELS:
        raise ValueError(
            f"raw decode: implausible dimensions {h}x{w} (corrupt header?)"
        )


def _unpack_bits(raw: bytes, bits: int, count: int) -> "np.ndarray":
    """Unpack ``count`` big-endian MSB-first ``bits``-wide samples to uint16."""
    if bits == 12:
        # fast path: 3 bytes -> 2 samples
        b = np.frombuffer(raw, np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.uint16)
        s0 = (b[:, 0] << 4) | (b[:, 1] >> 4)
        s1 = ((b[:, 1] & 0xF) << 8) | b[:, 2]
        out = np.stack([s0, s1], axis=1).reshape(-1)
        return out[:count]
    bits_arr = np.unpackbits(np.frombuffer(raw, np.uint8))
    usable = (len(bits_arr) // bits) * bits
    vals = bits_arr[:usable].reshape(-1, bits).astype(np.uint16)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (vals * weights).sum(axis=1, dtype=np.uint16)[:count]


def _pack_bits(vals: "np.ndarray", bits: int) -> bytes:
    """Inverse of _unpack_bits: pack uint16 samples into a big-endian bitstream."""
    vals = np.asarray(vals, np.uint16)
    bit_rows = ((vals[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
    flat = bit_rows.reshape(-1)
    pad = (-len(flat)) % 8
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return np.packbits(flat).tobytes()


def _assemble_tiles(flat, height, width, tile_h, tile_w, n_tiles):
    """Reassemble row-major fixed-size tiles into an (H, W) image."""
    out = np.zeros((height, width), flat.dtype)
    tiles_x = max(1, -(-width // tile_w))
    per_tile = tile_h * tile_w
    for idx in range(n_tiles):
        ty, tx = divmod(idx, tiles_x)
        y0, x0 = ty * tile_h, tx * tile_w
        piece = flat[idx * per_tile : (idx + 1) * per_tile].reshape(tile_h, tile_w)
        h_eff = min(tile_h, height - y0)
        w_eff = min(tile_w, width - x0)
        out[y0 : y0 + h_eff, x0 : x0 + w_eff] = piece[:h_eff, :w_eff]
    return out


@dataclass
class TiffTag:
    tag: int
    dtype: int
    count: int
    values: Any  # list of ints/floats/bytes; rationals as (num, den) tuples
    # absolute file offset of an out-of-line value (None when inlined in the
    # entry) — needed by blobs whose internal pointers are file-absolute
    # (Canon MakerNote IFDs, cr2.py)
    value_offset: Optional[int] = None

    def as_floats(self) -> List[float]:
        out = []
        for v in self.values:
            if isinstance(v, tuple):
                out.append(v[0] / v[1] if v[1] != 0 else float("inf"))
            else:
                out.append(float(v))
        return out

    def as_ints(self) -> List[int]:
        return [int(round(f)) for f in self.as_floats()]

    def as_bytes(self) -> bytes:
        if isinstance(self.values, (bytes, bytearray)):
            return bytes(self.values)
        return bytes(self.values)


@dataclass
class Ifd:
    tags: Dict[int, TiffTag] = field(default_factory=dict)
    sub_ifds: List["Ifd"] = field(default_factory=list)
    exif_ifd: Optional["Ifd"] = None

    def get(self, tag: int) -> Optional[TiffTag]:
        return self.tags.get(tag)

    def require(self, tag: int) -> TiffTag:
        """Like get(), but a missing tag raises ValueError (not AttributeError
        downstream) — required-tag reads on possibly-corrupt files use this."""
        t = self.tags.get(tag)
        if t is None:
            raise ValueError(f"missing required TIFF tag {tag}")
        return t


@dataclass
class TiffFile:
    ifds: List[Ifd]
    endian: str  # '<' or '>'
    data: bytes

    def find_raw_ifd(self) -> Optional[Ifd]:
        """Locate the CFA raw IFD: first IFD (or SubIFD) with photometric == CFA."""
        for ifd in self.ifds:
            for cand in [ifd] + ifd.sub_ifds:
                p = cand.get(TAG_PHOTOMETRIC)
                if p is not None and p.as_ints()[0] == PHOTOMETRIC_CFA:
                    return cand
        # fall back: DNG convention of SubIFD 0 under IFD0
        if self.ifds and self.ifds[0].sub_ifds:
            return self.ifds[0].sub_ifds[0]
        return None

    def read_strips(self, ifd: Ifd) -> np.ndarray:
        """Decode image data from an IFD into (H, W) uint8/uint16.

        Supports uncompressed (1) and lossless-JPEG (7, the DNG standard raw
        compression — decoded by the native library) data, in both strip and tile
        organizations. The span ``io.decode_strips``.
        """
        with span("io.decode_strips"):
            return self._read_strips(ifd)

    def _read_strips(self, ifd: Ifd) -> np.ndarray:
        comp_tag = ifd.get(TAG_COMPRESSION)
        compression = comp_tag.as_ints()[0] if comp_tag is not None else 1
        width = ifd.require(TAG_IMAGE_WIDTH).as_ints()[0]
        height = ifd.require(TAG_IMAGE_LENGTH).as_ints()[0]
        check_decode_dims(height, width)
        bits = ifd.require(TAG_BITS_PER_SAMPLE).as_ints()[0]

        tiled = ifd.get(TAG_TILE_OFFSETS) is not None
        if tiled:
            offsets = ifd.require(TAG_TILE_OFFSETS).as_ints()
            counts = ifd.require(TAG_TILE_BYTE_COUNTS).as_ints()
            tile_w = ifd.require(TAG_TILE_WIDTH).as_ints()[0]
            tile_h = ifd.require(TAG_TILE_LENGTH).as_ints()[0]
        else:
            offsets = ifd.require(TAG_STRIP_OFFSETS).as_ints()
            counts = ifd.require(TAG_STRIP_BYTE_COUNTS).as_ints()
            rps_tag = ifd.get(TAG_ROWS_PER_STRIP)
            tile_w = width
            tile_h = rps_tag.as_ints()[0] if rps_tag is not None else height

        if compression == 1:
            raw = b"".join(self.data[o : o + c] for o, c in zip(offsets, counts))
            if bits == 16:
                arr = np.frombuffer(raw, dtype=np.dtype(self.endian + "u2"))
            elif bits == 8:
                arr = np.frombuffer(raw, dtype=np.uint8)
            elif bits in (10, 12, 14):
                # DNG packed CFA: big-endian bitstream, MSB first, each strip/tile
                # byte-aligned. Unpack per piece so per-strip padding can't shear rows.
                pieces = []
                for o, c in zip(offsets, counts):
                    n = (c * 8) // bits
                    pieces.append(_unpack_bits(self.data[o : o + c], bits, n))
                arr = np.concatenate(pieces)
            else:
                raise ValueError(f"Unsupported bit depth {bits}")
            if not tiled:
                return arr[: height * width].reshape(height, width)
            if bits in (10, 12, 14):
                per_tile = tile_h * tile_w
                arr = np.concatenate(
                    [arr[i * per_tile : (i + 1) * per_tile] for i in range(len(offsets))]
                )
            return _assemble_tiles(arr, height, width, tile_h, tile_w, len(offsets))

        if compression == 7:  # lossless JPEG (DNG)
            from . import native

            if not native.available():
                raise ValueError(
                    "Lossless-JPEG DNG needs the native decoder, which did not build "
                    "(see the warning)"
                )
            if len(offsets) > 1 and native.has_ljpeg_tiles():
                # independent entropy streams -> host-thread-parallel decode in
                # ONE native call (byte-identical to the loop below, which
                # remains as the single-stream / old-library path)
                return native.ljpeg_decode_tiles(
                    bytes(self.data), offsets, counts, height, width,
                    tile_h, tile_w,
                )
            out = np.zeros((height, width), np.uint16)
            tiles_x = max(1, -(-width // tile_w))
            for idx, (o, c) in enumerate(zip(offsets, counts)):
                piece = native.ljpeg_decode(bytes(self.data[o : o + c]))
                if piece.ndim == 3:
                    # N-component scan spans N adjacent columns per sample
                    ph, pw, pc = piece.shape
                    piece = piece.reshape(ph, pw * pc)
                ty, tx = divmod(idx, tiles_x)
                y0, x0 = ty * tile_h, tx * tile_w
                h_eff = min(tile_h, height - y0)
                w_eff = min(tile_w, width - x0)
                out[y0 : y0 + h_eff, x0 : x0 + w_eff] = piece[:h_eff, :w_eff]
            return out

        raise ValueError(f"Unsupported TIFF compression {compression}")


def _read_value(
    data: bytes, endian: str, dtype: int, count: int, raw: bytes
) -> Tuple[Any, Optional[int]]:
    fmt, size = _TYPES[dtype]
    total = size * count
    if total > len(data):
        # corrupt count field: the value cannot fit in the file at all — raise
        # before building an unpack format string proportional to `count`
        raise ValueError(f"TIFF tag value out of bounds (count={count})")
    value_offset = None
    if total > 4:
        (offset,) = struct.unpack(endian + "L", raw)
        payload = data[offset : offset + total]
        value_offset = offset
        if len(payload) < total:
            raise ValueError("TIFF tag value offset out of bounds")
    else:
        payload = raw[:total]

    if dtype in (TYPE_ASCII, TYPE_UNDEFINED):
        return payload, value_offset
    if dtype in (TYPE_RATIONAL, TYPE_SRATIONAL):
        flat = struct.unpack(endian + _TYPES[dtype][0][0] * 2 * count, payload)
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(count)], value_offset
    return list(struct.unpack(endian + fmt * count, payload)), value_offset


def _parse_ifd(data: bytes, endian: str, offset: int, depth: int = 0) -> Tuple[Ifd, int]:
    ifd = Ifd()
    (n_entries,) = struct.unpack_from(endian + "H", data, offset)
    pos = offset + 2
    for _ in range(n_entries):
        tag, dtype, count = struct.unpack_from(endian + "HHL", data, pos)
        raw = data[pos + 8 : pos + 12]
        pos += 12
        if dtype not in _TYPES:
            continue
        values, value_offset = _read_value(data, endian, dtype, count, raw)
        ifd.tags[tag] = TiffTag(tag, dtype, count, values, value_offset)

    (next_off,) = struct.unpack_from(endian + "L", data, pos)

    if depth < 4:
        sub = ifd.get(TAG_SUB_IFD)
        if sub is not None:
            for sub_off in sub.as_ints():
                child, _ = _parse_ifd(data, endian, sub_off, depth + 1)
                ifd.sub_ifds.append(child)
        exif = ifd.get(TAG_EXIF_IFD)
        if exif is not None:
            child, _ = _parse_ifd(data, endian, exif.as_ints()[0], depth + 1)
            ifd.exif_ifd = child

    return ifd, next_off


def read_tiff(source: Union[str, bytes, BinaryIO]) -> TiffFile:
    """The file read whole and its IFDs parsed: the span ``io.read``; the
    bytes read from a file count in ``io.bytes_read``."""
    with span("io.read"):
        if isinstance(source, (bytes, bytearray)):
            return _parse_tiff(bytes(source))
        if isinstance(source, str):
            with open(source, "rb") as f:
                data = f.read()
        else:
            data = source.read()
        count("io.bytes_read", len(data))
        return _parse_tiff(data)


def _parse_tiff(data: bytes) -> TiffFile:
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError("Not a TIFF file")
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic not in (42, 0x55, 0x4F52, 0x5352):
        # alternates: 0x55 Panasonic RW2, 0x4F52/0x5352 Olympus ORF ("RO"/"SR")
        # — TIFFs in every other respect (rawspeed's TiffParser equally).
        raise ValueError("Bad TIFF magic")

    (off,) = struct.unpack_from(endian + "L", data, 4)
    ifds = []
    seen = set()
    while off and off not in seen and len(ifds) < 16:
        seen.add(off)
        ifd, off = _parse_ifd(data, endian, off)
        ifds.append(ifd)
    return TiffFile(ifds=ifds, endian=endian, data=data)


# --- writer --------------------------------------------------------------------------
class TiffWriter:
    """Builds a little-endian TIFF/DNG with one IFD chain (IFD0 [+SubIFD] [+ExifIFD])."""

    def __init__(self) -> None:
        self._blobs: List[bytes] = []

    @staticmethod
    def _pack_values(dtype: int, values: Any) -> Tuple[bytes, int]:
        fmt, size = _TYPES[dtype]
        if dtype in (TYPE_ASCII, TYPE_UNDEFINED):
            payload = bytes(values)
            return payload, len(payload)
        if dtype in (TYPE_RATIONAL, TYPE_SRATIONAL):
            flat = []
            for num, den in values:
                flat += [int(num), int(den)]
            return struct.pack("<" + fmt[0] * len(flat), *flat), len(values)
        if not isinstance(values, (list, tuple)):
            values = [values]
        return struct.pack("<" + fmt * len(values), *values), len(values)

    def write(
        self,
        ifd0_tags: Dict[int, Tuple[int, Any]],
        sub_ifd_tags: Optional[Dict[int, Tuple[int, Any]]] = None,
        exif_tags: Optional[Dict[int, Tuple[int, Any]]] = None,
        strip_data: Optional[bytes] = None,
        strip_in_sub: bool = True,
        magic: int = 42,
    ) -> bytes:
        """Assemble the file. Tag dicts map tag -> (dtype, values).

        If ``strip_data`` is given, StripOffsets/ByteCounts are patched into the raw
        IFD (the SubIFD when ``strip_in_sub``). A list of byte strings emits a
        MULTI-STRIP organization (one offset/count per piece; the caller sets
        RowsPerStrip); a single bytes object stays single-strip. ``magic``
        defaults to classic TIFF (42); Panasonic RW2 fixtures pass 0x55.
        """
        # Layout: header(8) | IFD0 | SubIFD | ExifIFD | heap (out-of-line values + strip)
        out = BytesIO()
        out.write(b"II" + struct.pack("<HL", magic, 8))

        def ifd_size(tags: Dict[int, Tuple[int, Any]]) -> int:
            return 2 + 12 * len(tags) + 4

        ifd0 = dict(ifd0_tags)
        sub = dict(sub_ifd_tags) if sub_ifd_tags is not None else None
        exif = dict(exif_tags) if exif_tags is not None else None

        raw_ifd = sub if (strip_in_sub and sub is not None) else ifd0
        pieces = None
        if strip_data is not None:
            pieces = (
                list(strip_data)
                if isinstance(strip_data, (list, tuple))
                else [strip_data]
            )
            raw_ifd[TAG_STRIP_OFFSETS] = (TYPE_LONG, [0] * len(pieces))  # patched below
            raw_ifd[TAG_STRIP_BYTE_COUNTS] = (TYPE_LONG, [len(p) for p in pieces])

        # Pointer tags must exist before sizing the IFDs
        if sub is not None:
            ifd0[TAG_SUB_IFD] = (TYPE_LONG, [0])
        if exif is not None:
            ifd0[TAG_EXIF_IFD] = (TYPE_LONG, [0])

        off_ifd0 = 8
        off_sub = off_ifd0 + ifd_size(ifd0)
        off_exif = off_sub + (ifd_size(sub) if sub is not None else 0)
        heap_start = off_exif + (ifd_size(exif) if exif is not None else 0)

        if sub is not None:
            ifd0[TAG_SUB_IFD] = (TYPE_LONG, [off_sub])
        if exif is not None:
            ifd0[TAG_EXIF_IFD] = (TYPE_LONG, [off_exif])

        heap = BytesIO()

        def build_ifd(tags: Dict[int, Tuple[int, Any]], ifd_offset: int) -> bytes:
            entries = []
            for tag in sorted(tags):
                dtype, values = tags[tag]
                payload, count = self._pack_values(dtype, values)
                if len(payload) <= 4:
                    inline = payload + b"\x00" * (4 - len(payload))
                    entries.append(struct.pack("<HHL4s", tag, dtype, count, inline))
                else:
                    pos = heap_start + heap.tell()
                    heap.write(payload)
                    if heap.tell() % 2:
                        heap.write(b"\x00")
                    entries.append(struct.pack("<HHLL", tag, dtype, count, pos))
            return (
                struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<L", 0)
            )

        # Build in two passes: first to fill the heap in a stable order, second after
        # the strip offset is known.
        def assemble() -> bytes:
            heap.seek(0)
            heap.truncate()
            blobs = []
            blobs.append(build_ifd(ifd0, off_ifd0))
            if sub is not None:
                blobs.append(build_ifd(sub, off_sub))
            if exif is not None:
                blobs.append(build_ifd(exif, off_exif))
            return b"".join(blobs)

        body = assemble()
        if pieces is not None:
            base = heap_start + heap.tell()
            offs, cur = [], base
            for p in pieces:
                offs.append(cur)
                cur += len(p)
            raw_ifd[TAG_STRIP_OFFSETS] = (TYPE_LONG, offs)
            body = assemble()  # heap identical size; only offsets changed
            for p in pieces:
                heap.write(p)

        out.write(body)
        out.write(heap.getvalue())
        blob = out.getvalue()
        assert len(blob) >= heap_start
        return blob


def write_synthetic_dng(
    bayer_u16: np.ndarray,
    black_level: int = 256,
    white_level: int = 4095,
    compression: int = 1,
    cfa_pattern: Tuple[int, int, int, int] = (0, 1, 1, 2),  # RGGB (0=R,1=G,2=B)
    color_matrix_1: Optional[np.ndarray] = None,
    color_matrix_2: Optional[np.ndarray] = None,
    illuminant_1: int = 17,  # EXIF LightSource: StdA
    illuminant_2: int = 21,  # D65
    as_shot_neutral: Tuple[float, float, float] = (0.5, 1.0, 0.6),
    active_area: Optional[Tuple[int, int, int, int]] = None,
    crop_origin: Optional[Tuple[int, int]] = None,
    crop_size: Optional[Tuple[int, int]] = None,
    linearization_table: Optional[np.ndarray] = None,
    opcode_list_1: Optional[bytes] = None,
    opcode_list_2: Optional[bytes] = None,
    opcode_list_3: Optional[bytes] = None,
    bits_per_sample: int = 16,
    exposure_time: Tuple[int, int] = (1, 100),
    f_number: Tuple[int, int] = (28, 10),
    iso: int = 200,
    rows_per_strip: Optional[int] = None,
) -> bytes:
    """Emit a minimal valid DNG carrying the metadata the pipeline consumes.

    This is the synthetic-camera-file generator for tests (SURVEY.md §4): ColorMatrix1/2
    + CalibrationIlluminant1/2 + AsShotNeutral exercise the WB path, ActiveArea/
    DefaultCrop the geometry path, OpcodeList3 the warp path, and the EXIF triplet the
    EV computation.
    """
    h, w = bayer_u16.shape
    if color_matrix_1 is None:
        color_matrix_1 = np.array(
            [[0.77, -0.11, -0.055], [-0.22, 1.21, 0.11], [0.022, -0.22, 1.32]]
        )
    if color_matrix_2 is None:
        color_matrix_2 = np.array(
            [[0.63, -0.09, -0.045], [-0.18, 0.99, 0.09], [0.018, -0.18, 1.08]]
        )

    def srat(mat: np.ndarray) -> List[Tuple[int, int]]:
        return [(int(round(v * 10000)), 10000) for v in np.asarray(mat).flatten()]

    sub: Dict[int, Tuple[int, Any]] = {
        TAG_IMAGE_WIDTH: (TYPE_LONG, [w]),
        TAG_IMAGE_LENGTH: (TYPE_LONG, [h]),
        TAG_BITS_PER_SAMPLE: (TYPE_SHORT, [bits_per_sample]),
        TAG_COMPRESSION: (TYPE_SHORT, [compression]),
        TAG_PHOTOMETRIC: (TYPE_SHORT, [PHOTOMETRIC_CFA]),
        TAG_SAMPLES_PER_PIXEL: (TYPE_SHORT, [1]),
        TAG_ROWS_PER_STRIP: (TYPE_LONG, [h]),
        TAG_CFA_REPEAT_PATTERN_DIM: (TYPE_SHORT, [2, 2]),
        TAG_CFA_PATTERN: (TYPE_BYTE, list(cfa_pattern)),
        TAG_BLACK_LEVEL: (TYPE_SHORT, [black_level] * 4),
        TAG_BLACK_LEVEL_REPEAT_DIM: (TYPE_SHORT, [2, 2]),
        TAG_WHITE_LEVEL: (TYPE_LONG, [white_level]),
    }
    if active_area is not None:
        sub[TAG_ACTIVE_AREA] = (TYPE_LONG, list(active_area))
    if crop_origin is not None:
        sub[TAG_DEFAULT_CROP_ORIGIN] = (TYPE_LONG, list(crop_origin))
    if crop_size is not None:
        sub[TAG_DEFAULT_CROP_SIZE] = (TYPE_LONG, list(crop_size))
    if linearization_table is not None:
        sub[TAG_LINEARIZATION_TABLE] = (
            TYPE_SHORT, [int(v) for v in np.asarray(linearization_table).ravel()]
        )
    if opcode_list_1 is not None:
        sub[TAG_OPCODE_LIST_1] = (TYPE_UNDEFINED, opcode_list_1)
    if opcode_list_2 is not None:
        sub[TAG_OPCODE_LIST_2] = (TYPE_UNDEFINED, opcode_list_2)
    if opcode_list_3 is not None:
        sub[TAG_OPCODE_LIST_3] = (TYPE_UNDEFINED, opcode_list_3)

    ifd0: Dict[int, Tuple[int, Any]] = {
        TAG_MAKE: (TYPE_ASCII, b"pysp_tpu\x00"),
        TAG_MODEL: (TYPE_ASCII, b"synthetic\x00"),
        TAG_DNG_VERSION: (TYPE_BYTE, [1, 4, 0, 0]),
        TAG_COLOR_MATRIX_1: (TYPE_SRATIONAL, srat(color_matrix_1)),
        TAG_COLOR_MATRIX_2: (TYPE_SRATIONAL, srat(color_matrix_2)),
        TAG_CALIBRATION_ILLUMINANT_1: (TYPE_SHORT, [illuminant_1]),
        TAG_CALIBRATION_ILLUMINANT_2: (TYPE_SHORT, [illuminant_2]),
        TAG_AS_SHOT_NEUTRAL: (
            TYPE_RATIONAL,
            [(int(round(v * 10000)), 10000) for v in as_shot_neutral],
        ),
        TAG_ISO_SPEED: (TYPE_SHORT, [iso]),
    }

    exif: Dict[int, Tuple[int, Any]] = {
        TAG_EXPOSURE_TIME: (TYPE_RATIONAL, [exposure_time]),
        TAG_F_NUMBER: (TYPE_RATIONAL, [f_number]),
        TAG_ISO_SPEED: (TYPE_SHORT, [iso]),
    }

    rps = h if rows_per_strip is None else int(rows_per_strip)
    sub[TAG_ROWS_PER_STRIP] = (TYPE_LONG, [rps])
    bands = [bayer_u16[y : y + rps] for y in range(0, h, rps)]

    def encode_band(band: np.ndarray) -> bytes:
        if compression == 7:
            from . import native

            return native.ljpeg_encode(band.astype(np.uint16), precision=16)
        if bits_per_sample == 16:
            return np.ascontiguousarray(band.astype("<u2")).tobytes()
        if bits_per_sample in (10, 12, 14):
            return _pack_bits(band.astype(np.uint16).reshape(-1), bits_per_sample)
        raise ValueError(f"Unsupported writer bit depth {bits_per_sample}")

    pieces = [encode_band(b) for b in bands]
    strip = pieces if len(pieces) > 1 else pieces[0]
    return TiffWriter().write(ifd0, sub, exif, strip_data=strip)
