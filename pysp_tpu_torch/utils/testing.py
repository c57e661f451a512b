"""Synthetic-scene and fidelity helpers (NumPy, host only).

Copied from ``pysp_tpu/utils/testing.py`` (the functions the port's smoke run
and tests use, ``ring_chart`` the CA scene among them), so that they import
without JAX, plus the test cases of the heal, postprocess, multisection and
EAG resample kernels, which the smoke run, ``tools/time_kernels.py`` and the tests share, and the synthetic raw files of every format the loaders
read (``raw_format_case``) with a reader for the PNGs the port writes
(``read_png``).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def psnr(a, b, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays."""
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float(np.inf)
    return float(10 * np.log10(peak**2 / mse))


def make_scene(h: int = 64, w: int = 80, seed: int = 0) -> np.ndarray:
    """Synthetic RGB scene: smooth gradients + edges + texture + mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.3 + 0.4 * np.sin(xx / 9) * np.cos(yy / 13) + 0.2 * (xx > w / 2)
    g = 0.4 + 0.3 * np.cos(xx / 7) + 0.15 * (yy > h / 3)
    b = 0.5 - 0.3 * np.sin(yy / 11) + 0.1 * ((xx + yy) % 17 > 8)
    rgb = np.clip(np.dstack([r, g, b]) + rng.normal(0, 0.01, (h, w, 3)), 0.02, 0.98)
    return rgb.astype(np.float32)


def mosaic_rggb(rgb: np.ndarray) -> np.ndarray:
    """Sample an RGB image through an RGGB CFA."""
    h, w, _ = rgb.shape
    bayer = np.zeros((h, w), np.float32)
    bayer[0::2, 0::2] = rgb[0::2, 0::2, 0]
    bayer[0::2, 1::2] = rgb[0::2, 1::2, 1]
    bayer[1::2, 0::2] = rgb[1::2, 0::2, 1]
    bayer[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return bayer


def ring_chart(
    h: int = 256, w: int = 256, radii=(60, 90, 110), amp: float = 0.5,
    sigma: float = 2.0, base: float = 0.2,
) -> np.ndarray:
    """Concentric rings: tangential edges perpendicular to the radius — the content
    the blind CA fit needs."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r = np.hypot(yy - cy, xx - cx)
    img = np.full((h, w), base, np.float32)
    for rad in radii:
        img += amp * np.exp(-0.5 * ((r - rad) / sigma) ** 2)
    return img.astype(np.float32)


def heal_case(h2: int, w2: int, density: float, seed: int):
    """CFA planes (4, h2, w2) float32 of a structured scene and a bool mask for
    the heal: random sites at ``density``, every plane corner and, where the
    planes hold them, a 3x3 cluster, a 13x13 blob that four fill sweeps cannot
    reach (it seeds from the plane mean) and blobs across tile corners."""
    rng = np.random.default_rng(seed)
    planes = make_scene(h2, w2, seed=seed)[..., [0, 1, 2, 1]].transpose(2, 0, 1).copy()
    mask = rng.random((4, h2, w2)) < density
    for y, x in ((0, 0), (0, w2 - 1), (h2 - 1, 0), (h2 - 1, w2 - 1)):
        mask[:, y, x] = True
    if h2 >= 40 and w2 >= 40:
        mask[0, 10:13, 20:23] = True
        mask[1, 20:33, 5:18] = True
    # Blobs across a corner of the kernel's 32x32 tiles reaching R - 1 sites
    # past it on every side, for R = 6 and 8 sweeps: a fill front enters them
    # at the first sweep just outside a halo one site short of R.
    for p, (ty, tx), r in ((2, (32, 64), 6), (3, (96, 192), 8)):
        if h2 > ty + r and w2 > tx + r:
            mask[p, ty - r + 1 : ty + r - 1, tx - r + 1 : tx + r - 1] = True
    return planes, mask


HEAL_TILE_KINDS = ("no_site", "every_tile", "tile_corners")


def heal_tile_case(h2: int, w2: int, kind: str, seed: int):
    """CFA planes (4, h2, w2) float32 of a structured scene and a bool mask
    that walks the heal kernel's tiling (16x16 sweep sub-tiles in 32x64 copy
    tiles): ``no_site``, an empty mask; ``every_tile``, one site in every
    16x16 sub-tile, at a place that moves from sub-tile to sub-tile; and
    ``tile_corners``, sites on every sub-tile corner and 1, 5 and 7 sites
    (R - 1 for R = 2, 6 and 8 sweeps) before and past it on both axes."""
    planes = make_scene(h2, w2, seed=seed)[..., [0, 1, 2, 1]].transpose(2, 0, 1).copy()
    mask = np.zeros((4, h2, w2), bool)
    if kind == "every_tile":
        for p in range(4):
            for k, ty in enumerate(range(0, h2, 16)):
                for j, tx in enumerate(range(0, w2, 16)):
                    y = min(ty + (5 * k + 3 * j + p) % 16, h2 - 1)
                    x = min(tx + (7 * j + 2 * k + p) % 16, w2 - 1)
                    mask[p, y, x] = True
    elif kind == "tile_corners":
        offsets = (-7, -5, -1, 0, 5, 7)
        for ty in range(0, h2 + 1, 16):
            for tx in range(0, w2 + 1, 16):
                for dy in offsets:
                    for dx in offsets:
                        if 0 <= ty + dy < h2 and 0 <= tx + dx < w2:
                            mask[:, ty + dy, tx + dx] = True
    elif kind != "no_site":
        raise ValueError(f"kind must be one of {HEAL_TILE_KINDS}, got {kind!r}")
    return planes, mask


MULTISECTION_KINDS = ("noise", "constant", "at_mids", "levels", "nan_samples")


def multisection_case(h2: int, w2: int, kind: str, seed: int) -> np.ndarray:
    """Delta planes (4, h2, w2) float32 for the hot-pixel detector's count
    multisection: ``noise``, the detector's |delta| of sensor noise with a
    thousandth of the sites hot, far above it; ``constant``, one value a plane
    (lo == hi); ``at_mids``, ``noise`` with a third of the sites moved onto
    the first pass's 16 interior points, as float32 computes them, so that
    every count holds samples equal to its mid; ``levels``, five values, all
    ties; ``nan_samples``, ``noise`` with a hundredth of the sites of planes
    1 and 3 NaN, which no count holds (``amin`` / ``amax`` of those planes
    are NaN, of planes 0 and 2 numbers)."""
    rng = np.random.default_rng(seed)
    shape = (4, h2, w2)
    if kind == "constant":
        values = np.float32([0.0, 0.125, 0.3, 1.0])[:, None, None]
        return np.ascontiguousarray(np.broadcast_to(values, shape))
    if kind == "levels":
        return (rng.integers(0, 5, shape) * 0.25).astype(np.float32)
    if kind not in MULTISECTION_KINDS:
        raise ValueError(f"kind must be one of {MULTISECTION_KINDS}, got {kind!r}")
    delta = np.abs(rng.normal(0.0, 0.01, shape)).astype(np.float32)
    hot = rng.random(shape) < 1e-3
    delta[hot] = rng.uniform(0.3, 0.9, int(hot.sum())).astype(np.float32)
    if kind == "at_mids":
        lo, hi = delta.min(axis=(1, 2)), delta.max(axis=(1, 2))
        fr = np.arange(1, 17, dtype=np.float32) / np.float32(17)
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]
        which = rng.integers(0, 16, shape)
        at = np.take_along_axis(mids, which.reshape(4, -1), axis=1).reshape(shape)
        delta = np.where(rng.random(shape) < 1 / 3, at, delta).astype(np.float32)
    elif kind == "nan_samples":
        nan = rng.random(shape) < 1e-2
        nan[0::2] = False
        delta[nan] = np.nan
    return delta


EAG_KINDS = ("noise", "levels", "zeros", "special")


def eag_case(shape, kind: str, seed: int) -> np.ndarray:
    """float32 samples of ``shape`` for the EAG resamples: ``noise`` in [0, 1);
    ``levels``, the values 0, 1 and 2 (so that many infills meet four equal
    greens, a sum of deltas of 0, and ties); ``zeros``, -0.0 at 95% of the
    samples and +0.0 at the rest (a sum begun at 0.0 instead of at its first
    tap turns -0.0 into +0.0); ``special``, noise with NaN, inf and -inf at
    3% of the samples."""
    rng = np.random.default_rng(seed)
    if kind == "levels":
        return rng.integers(0, 3, shape).astype(np.float32)
    if kind == "zeros":
        return np.where(rng.random(shape) < 0.95, -0.0, 0.0).astype(np.float32)
    if kind not in EAG_KINDS:
        raise ValueError(f"kind must be one of {EAG_KINDS}, got {kind!r}")
    x = rng.random(shape, dtype=np.float32)
    if kind == "special":
        sites = rng.random(shape) < 0.03
        x[sites] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), int(sites.sum()))
    return x


def same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    """float32 arrays bit for bit, signed zeros included, with NaN in the same
    places (a NaN's payload is not compared)."""
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(np.where(nan, 0, got).astype(np.float32).view(np.int32),
                               np.where(nan, 0, want).astype(np.float32).view(np.int32)))


def chroma_case(h: int, w: int, seed: int) -> np.ndarray:
    """r, g, b planes (3, h, w) float32 for the chroma-median stage: a scene
    with noise, so that the medians differ from pixel to pixel up to the
    frame's edge, and every plane corner an outlier, which enters a border
    pixel's window as often as the border rule repeats it."""
    rng = np.random.default_rng(seed)
    rgb = make_scene(h, w, seed=seed) + rng.normal(0, 0.05, (h, w, 3))
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1), np.float32)
    corners = ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1))
    for k, values in enumerate(((1.5, -1.5, -1.0, 1.0), (-0.8, 0.9, 1.2, -1.1),
                                (1.1, 1.3, -0.9, -1.4))):
        for (y, x), v in zip(corners, values):
            planes[k, y, x] = v
    return planes


# The raw formats the built-in decoders read, each with its synthetic writer:
# (module under io/, writer, bits of the stored values, writer keywords). The
# blacks are 0 and the CFA RGGB, so a decode of stored values v gives
# v / (2**bits - 1). ARW2 is lossy (a block's spread past 7 bits is shifted);
# the RW2 v4 coder is exact on the small-step content it gets here.
RAW_FORMATS = {
    "dng": ("tiff", "write_synthetic_dng", 12, {"compression": 7, "black_level": 0}),
    "cr2": ("cr2", "write_synthetic_cr2", 14, {}),
    "mrw": ("mrw", "write_synthetic_mrw", 12, {}),
    "raf": ("raf", "write_synthetic_raf", 14, {}),
    "orf": ("orf", "write_synthetic_orf", 12, {"black_rggb": (0, 0, 0, 0)}),
    "rw2": ("rw2", "write_synthetic_rw2", 12, {"black_rgb": (0, 0, 0)}),
    "nef": ("nef", "write_synthetic_nef", 14, {}),
    "arw": ("arw", "write_synthetic_arw", 11, {}),
    "pef": ("pef", "write_synthetic_pef", 12, {"black_rggb": (0, 0, 0, 0)}),
    "srw": ("srw", "write_synthetic_srw", 12, {"black_rggb": (0, 0, 0, 0), "cfa": (0, 1, 1, 2)}),
}
LOSSY_RAW_FORMATS = ("arw",)
# Largest RW2 v4 step between photosites of one colour that the coder keeps
# exact (an 8-bit code at shift 0).
RW2_MAX_STEP = 100


def raw_format_mosaic(fmt: str, mosaic: np.ndarray) -> np.ndarray:
    """The stored values (h, w) uint16 written for ``fmt``: ``mosaic`` (an
    RGGB mosaic in [0, 1], such as ``mosaic_rggb(make_scene(h, w))``) scaled to
    the format's bits; for RW2, with every step from the photosite two
    columns left limited to RW2_MAX_STEP."""
    bits = RAW_FORMATS[fmt][2]
    target = np.round(mosaic * ((1 << bits) - 1)).astype(np.int64)
    if fmt != "rw2":
        return target.astype(np.uint16)
    out = target.copy()
    for x in range(2, out.shape[1]):
        out[:, x] = out[:, x - 2] + np.clip(target[:, x] - out[:, x - 2], -RW2_MAX_STEP,
                                            RW2_MAX_STEP)
    return out.astype(np.uint16)


def write_raw_format(io_package, fmt: str, stored: np.ndarray) -> bytes:
    """File bytes of ``stored`` in ``fmt``, written by ``io_package``'s
    writer (the port's ``"pysp_tpu_torch.io"``, or another package with the
    same modules). The RW2 v4 coder packs 14 photosites at a time: a width
    that is not a multiple of 14 is padded on the right with copies of the
    last two columns, outside the sensor borders the file records, so the
    decode is ``stored`` again."""
    import importlib

    module, writer, _, kwargs = RAW_FORMATS[fmt]
    write = getattr(importlib.import_module(f"{io_package}.{module}"), writer)
    if fmt != "rw2":
        return write(stored, **kwargs)
    h, w = stored.shape
    pad = -w % 14
    cols = np.arange(w + pad)
    cols[w:] = w - 2 + (cols[w:] - w) % 2
    return write(np.ascontiguousarray(stored[:, cols]), borders=(0, 0, h, w), **kwargs)[0]


def arw2_error_bound(stored: np.ndarray) -> np.ndarray:
    """Per photosite, the ARW2 coder's largest error on ``stored`` (11-bit,
    width a multiple of 32): a block is the 16 photosites of one column parity
    in a 32-column span; with spread s it shifts by the least k <= 4 with
    s < 0x80 << k, and each value comes back within (1 << k) of the written
    one, the block's max and min exactly (tests/test_arw.py's bound)."""
    h, w = stored.shape
    v = stored.astype(np.int64).reshape(h, w // 32, 16, 2)
    spread = v.max(axis=2) - v.min(axis=2)                 # (h, w // 32, 2)
    shift = np.zeros_like(spread)
    for _ in range(4):
        shift += (shift < 4) & ((0x80 << shift) <= spread)
    bound = np.broadcast_to((1 << shift)[:, :, None, :], v.shape)
    return bound.reshape(h, w)


def read_png(blob: bytes) -> np.ndarray:
    """Pixels of an 8- or 16-bit grey or RGB PNG whose rows are unfiltered
    (the native writer's): (H, W, C) uint8 or uint16, C 3 (or (H, W) grey)."""
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">L", blob[pos:pos + 4])
        kind, body = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">L", blob[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">LLBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    channels = {0: 1, 2: 3}[colour]
    if depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, interlace {interlace}")
    row = w * channels * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + row)
    if np.any(raw[:, 0]):
        raise ValueError("PNG rows are filtered; only unfiltered rows are read")
    pixels = raw[:, 1:].copy()
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    return pixels.reshape(h, w, channels) if channels == 3 else pixels.reshape(h, w)
