"""ctypes bindings for the native decode library (native/dng_fast.cc).

Counterpart of ``pysp_tpu/io/native.py``. The native library plays libraw's
role in the reference (SURVEY.md §2.9 item 3): fast host-side decode feeding
device tensors. At first use the source is compiled with ``g++`` and
``native/Makefile``'s flags into ``pysp_tpu_torch/_build/``, named by a hash of
the source and the flags (an edited source rebuilds); the build writes a
temporary file and renames it into place, so processes that build at the same
moment do not see a half-written library. ``available()`` returns False when
the build fails, with a warning that carries the compiler's output, and
pure-Python fallbacks take over where a format has one (slower, same results).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dng_fast.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# Decode threads (``load_burst``, ``develop_stream``) may make the first call
# at once: one builds and binds, the others wait for its result.
_LOAD_LOCK = threading.Lock()
# Path of the library this process loaded (None until a load succeeded), and
# the seconds its build took in this process (0.0 if it was built before).
loaded_path: Optional[str] = None
build_seconds = 0.0


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libdng_fast_{key.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the native source unless its build exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=path.stem + ".", suffix=".tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return path


def _load() -> Optional[ctypes.CDLL]:
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, loaded_path
    if _TRIED:
        return _LIB
    try:
        path = str(build_library())
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError) as e:
        warnings.warn(
            f"pysp_tpu_torch: the native decode library did not build or load, "
            f"so the formats that need it are unavailable: {e}",
            RuntimeWarning,
            stacklevel=3,
        )
        _TRIED = True
        return None
    loaded_path = path

    lib.dng_ljpeg_decode.restype = ctypes.c_int
    lib.dng_ljpeg_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    if hasattr(lib, "dng_ljpeg_decode_tiles"):
        lib.dng_ljpeg_decode_tiles.restype = ctypes.c_int
        lib.dng_ljpeg_decode_tiles.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
    lib.dng_ljpeg_encode.restype = ctypes.c_int64
    lib.dng_ljpeg_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.dng_normalize_mosaic.restype = None
    lib.dng_normalize_mosaic.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.nef_decode.restype = ctypes.c_int
    lib.nef_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
    ]
    lib.nef_encode.restype = ctypes.c_int64
    lib.nef_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.dng_swap16.restype = None
    lib.dng_swap16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
    ]
    # RW2 entry points are absent in stale builds of the .so — degrade
    try:
        lib.rw2_decode.restype = ctypes.c_int
        lib.rw2_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.rw2_encode.restype = ctypes.c_int64
        lib.rw2_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.orf_decode.restype = ctypes.c_int
        lib.orf_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.orf_encode.restype = ctypes.c_int64
        lib.orf_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.pef_decode.restype = ctypes.c_int
        lib.pef_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.srw_decode.restype = ctypes.c_int
        lib.srw_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.arw2_decode.restype = ctypes.c_int
        lib.arw2_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
    except AttributeError:
        pass
    try:
        lib.png_encode_fast_bound.restype = ctypes.c_int64
        lib.png_encode_fast_bound.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.png_encode_fast.restype = ctypes.c_int64
        lib.png_encode_fast.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
    except AttributeError:
        pass
    # _TRIED last: a caller outside the lock that sees it finds _LIB bound
    _LIB = lib
    _TRIED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def ljpeg_decode(blob: bytes, max_pixels: int = 1 << 28) -> np.ndarray:
    """Decode a lossless-JPEG (SOF3) blob -> (H, W, C) uint16 (C squeezed if 1)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    out = np.empty(max_pixels, np.uint16)
    dims = (ctypes.c_int32 * 3)()
    rc = lib.dng_ljpeg_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size,
        dims,
    )
    if rc != 0:
        raise ValueError(f"lossless JPEG decode failed (code {rc})")
    h, w, c = dims[0], dims[1], dims[2]
    arr = out[: h * w * c].reshape(h, w, c).copy()
    return arr[..., 0] if c == 1 else arr


def has_ljpeg_tiles() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "dng_ljpeg_decode_tiles")


def ljpeg_decode_tiles(
    data: bytes,
    offsets,
    counts,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
) -> np.ndarray:
    """Decode independent LJ92 tiles/strips ACROSS HOST THREADS in one call.

    One ctypes crossing for the whole mosaic; the native side decodes every
    tile in parallel (std::thread — the reference's own native kernels are
    OpenMP-parallel, reference/setup.py:9-19) and assembles windows.
    Byte-identical to the serial per-tile loop (gated in tests/test_io.py).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "dng_ljpeg_decode_tiles"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    offs = np.ascontiguousarray(offsets, np.int64)
    cnts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((height, width), np.uint16)
    rc = lib.dng_ljpeg_decode_tiles(
        data,
        len(data),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
        tile_h,
        tile_w,
    )
    if rc != 0:
        raise ValueError(f"lossless JPEG tile decode failed (code {rc})")
    return out


def ljpeg_encode(img: np.ndarray, precision: int = 16) -> bytes:
    """Encode (H, W) or (H, W, C) uint16 as lossless JPEG SOF3, predictor 1."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    flat = np.ascontiguousarray(img, np.uint16)
    cap = flat.size * 4 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.dng_ljpeg_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h,
        w,
        c,
        precision,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        raise ValueError(f"lossless JPEG encode failed (code {n})")
    return out[:n].tobytes()


def normalize_mosaic(
    mosaic_u16: np.ndarray, black4: np.ndarray, sat4: np.ndarray
) -> np.ndarray:
    """Multithreaded u16 mosaic -> normalized f32 (RGGB plane levels)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    h, w = mosaic_u16.shape
    src = np.ascontiguousarray(mosaic_u16, np.uint16)
    out = np.empty((h, w), np.float32)
    b = np.ascontiguousarray(black4, np.float32)
    s = np.ascontiguousarray(sat4, np.float32)
    lib.dng_normalize_mosaic(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h,
        w,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def swap16(data: bytes) -> np.ndarray:
    """Big-endian byte pairs -> native uint16 array (multithreaded)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    count = len(data) // 2
    out = np.empty(count, np.uint16)
    lib.dng_swap16(data, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), count)
    return out


def nef_decode(
    blob: bytes,
    height: int,
    width: int,
    tree_idx: int,
    vpred: np.ndarray,
    split_row: int,
    curve: np.ndarray,
) -> np.ndarray:
    """Decode a Nikon NEF compressed CFA strip -> (H, W) uint16."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    out = np.empty((height, width), np.uint16)
    vp = np.ascontiguousarray(vpred, np.uint16)
    cv = np.ascontiguousarray(curve, np.uint16)
    rc = lib.nef_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
        tree_idx,
        vp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        split_row,
        cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cv.size,
    )
    if rc != 0:
        raise ValueError(f"NEF decode failed (code {rc})")
    return out


def has_rw2() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "rw2_decode")


def rw2_decode(blob: bytes, height: int, width: int) -> np.ndarray:
    """Decode a Panasonic v4 bitstream -> (H, W) uint16 (io/rw2.py fast path)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rw2_decode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    out = np.empty((height, width), np.uint16)
    rc = lib.rw2_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
    )
    if rc != 0:
        raise ValueError(f"RW2 decode failed (code {rc})")
    return out


def rw2_encode(values: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Encode (H, W) 12-bit values as a fixed-rate v4 payload; returns
    (payload, achieved) bit-identical to io/rw2.py::pana_v4_encode."""
    lib = _load()
    if lib is None or not hasattr(lib, "rw2_encode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    h, w = values.shape
    flat = np.ascontiguousarray(values, np.uint16)
    # fixed rate: 16 bytes per 14 pixels, whole 0x4000 sections
    cap = ((h * w * 16) // 14 + 0x4000) // 0x4000 * 0x4000 + 0x4000
    out = np.empty(cap, np.uint8)
    achieved = np.empty((h, w), np.uint16)
    n = lib.rw2_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
        achieved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if n < 0:
        raise ValueError(f"RW2 encode failed (code {n})")
    return out[:n].tobytes(), achieved


def has_orf() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "orf_decode")


def orf_decode(blob: bytes, height: int, width: int) -> np.ndarray:
    """Decode an Olympus compressed strip -> (H, W) uint16 (io/orf.py fast path)."""
    lib = _load()
    if lib is None or not hasattr(lib, "orf_decode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    out = np.empty((height, width), np.uint16)
    rc = lib.orf_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
    )
    if rc != 0:
        raise ValueError(f"ORF decode failed (code {rc})")
    return out


def orf_encode(values: np.ndarray) -> bytes:
    """Encode (H, W) uint16 as an Olympus compressed strip, bit-identical to
    io/orf.py::olympus_encode."""
    lib = _load()
    if lib is None or not hasattr(lib, "orf_encode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    h, w = values.shape
    flat = np.ascontiguousarray(values, np.uint16)
    cap = flat.size * 5 + 4096  # worst case ~34 bits/site
    out = np.empty(cap, np.uint8)
    n = lib.orf_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        raise ValueError(f"ORF encode failed (code {n})")
    return out[:n].tobytes()


def has_pef() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "pef_decode")


def has_srw() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "srw_decode")


def has_arw2() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "arw2_decode")


def arw2_decode(blob: bytes, height: int, width: int) -> np.ndarray:
    """Unpack ARW2 delta blocks -> (H, W) uint16 (io/arw.py fast path)."""
    lib = _load()
    if lib is None or not hasattr(lib, "arw2_decode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    out = np.empty((height, width), np.uint16)
    rc = lib.arw2_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
    )
    if rc != 0:
        raise ValueError(f"ARW2 decode failed (code {rc})")
    return out


def srw_decode(
    data: bytes, row_offsets: np.ndarray, data_offset: int,
    height: int, width: int, bits: int = 12,
) -> np.ndarray:
    """Decode Samsung compressed rows -> (H, W) uint16 STORED values
    (io/srw.py fast path; caller applies samsung_swap)."""
    lib = _load()
    if lib is None or not hasattr(lib, "srw_decode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    offs = np.ascontiguousarray(row_offsets, np.uint32)
    out = np.empty((height, width), np.uint16)
    rc = lib.srw_decode(
        data,
        len(data),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        data_offset,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
        bits,
    )
    if rc != 0:
        raise ValueError(f"SRW decode failed (code {rc})")
    return out


def pef_decode(
    blob: bytes, height: int, width: int, spec_blob: bytes, endian: str,
    bits: int = 12,
) -> np.ndarray:
    """Decode a Pentax compressed strip -> (H, W) uint16 (io/pef.py fast path).

    ``spec_blob`` is the MakerNote 0x0220 value; it is parsed host-side (the
    container's endianness applies) and handed to the native LUT decoder."""
    from .pef import parse_huff_spec

    lib = _load()
    if lib is None or not hasattr(lib, "pef_decode"):
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    prefixes, lengths = parse_huff_spec(spec_blob, endian)
    pre = np.ascontiguousarray(prefixes, np.uint16)
    lens = np.ascontiguousarray(lengths, np.uint8)
    out = np.empty((height, width), np.uint16)
    rc = lib.pef_decode(
        blob,
        len(blob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        height,
        width,
        pre.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(lens),
        bits,
    )
    if rc != 0:
        raise ValueError(f"PEF decode failed (code {rc})")
    return out


def nef_encode(img: np.ndarray, tree_idx: int, vpred: np.ndarray) -> bytes:
    """Encode (H, W) uint16 (<= 14 bit) as a NEF compressed strip (fixtures)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (its build failed; see the warning)")
    h, w = img.shape
    flat = np.ascontiguousarray(img, np.uint16)
    vp = np.ascontiguousarray(vpred, np.uint16)
    cap = flat.size * 4 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.nef_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h,
        w,
        tree_idx,
        vp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        raise ValueError(f"NEF encode failed (code {n})")
    return out[:n].tobytes()


def has_png() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "png_encode_fast")


def png_encode(img: np.ndarray) -> bytes:
    """Encode (H, W, 3) or (H, W) pixels as a valid PNG — stored-deflate
    blocks, no compression pass (~12x faster than zlib at ~12% larger files;
    BASELINE.md round-4 PNG ledger). uint8 input writes an 8-bit PNG; uint16
    a 16-bit PNG (a mode PIL cannot even write for RGB). The output reads
    back identically through any PNG decoder."""
    lib = _load()
    if lib is None or not hasattr(lib, "png_encode_fast"):
        raise RuntimeError("native png_encode_fast unavailable (its build failed; see the warning)")
    img = np.asarray(img)
    if img.dtype == np.uint16:
        sample_bytes = 2
        raw = np.ascontiguousarray(img.astype(">u2")).view(np.uint8)
    else:
        sample_bytes = 1
        raw = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape[0], img.shape[1], (img.shape[2] if img.ndim == 3 else 1)
    if c not in (1, 3):
        raise ValueError(f"png_encode supports 1 or 3 channels, got {c}")
    cap = lib.png_encode_fast_bound(h, w, c, sample_bytes)
    out = np.empty(int(cap), np.uint8)
    n = lib.png_encode_fast(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        c,
        sample_bytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
    )
    if n <= 0:
        raise ValueError(f"fast PNG encode failed (code {n})")
    return out[:n].tobytes()
