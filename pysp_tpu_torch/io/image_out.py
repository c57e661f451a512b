"""Developed-image output: 16-bit TIFF writing on the host.

Counterpart of ``pysp_tpu/io/image_out.py`` for TIFF. PNG and JPEG output need
the native PNG writer or PIL and are not ported yet (ROADMAP.md queue A, item A3).
Functions take a NumPy array or a tensor on any device; a tensor is copied to
the host first.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tiff as T


def _host(srgb) -> np.ndarray:
    if isinstance(srgb, torch.Tensor):
        srgb = srgb.detach().to("cpu").numpy()
    return np.asarray(srgb, np.float32)


def to_uint8(srgb) -> np.ndarray:
    return np.clip(_host(srgb) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def to_uint16(srgb) -> np.ndarray:
    return np.clip(_host(srgb) * 65535.0 + 0.5, 0, 65535).astype(np.uint16)


def save_image(path: str, srgb) -> None:
    """Save an sRGB float image ([0,1], (H, W, 3)) by extension. Only
    ``.tif``/``.tiff`` (uncompressed 16-bit RGB) is ported."""
    if not path.lower().endswith((".tif", ".tiff")):
        raise NotImplementedError(
            f"{path}: pysp_tpu_torch writes .tif/.tiff only; PNG/JPEG output is "
            "not ported yet (ROADMAP.md queue A, item A3: the native PNG binding)"
        )
    save_tiff16(path, srgb)


def save_tiff16(path: str, srgb) -> None:
    """Write an uncompressed 16-bit RGB TIFF with the built-in writer."""
    img = to_uint16(srgb)
    h, w, _ = img.shape
    ifd0 = {
        T.TAG_IMAGE_WIDTH: (T.TYPE_LONG, [w]),
        T.TAG_IMAGE_LENGTH: (T.TYPE_LONG, [h]),
        T.TAG_BITS_PER_SAMPLE: (T.TYPE_SHORT, [16, 16, 16]),
        T.TAG_COMPRESSION: (T.TYPE_SHORT, [1]),
        T.TAG_PHOTOMETRIC: (T.TYPE_SHORT, [2]),  # RGB
        T.TAG_SAMPLES_PER_PIXEL: (T.TYPE_SHORT, [3]),
        T.TAG_ROWS_PER_STRIP: (T.TYPE_LONG, [h]),
    }
    strip = np.ascontiguousarray(img.astype("<u2")).tobytes()
    blob = T.TiffWriter().write(ifd0, None, None, strip_data=strip, strip_in_sub=False)
    with open(path, "wb") as f:
        f.write(blob)
