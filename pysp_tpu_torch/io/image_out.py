"""Developed-image output: PNG / 16-bit TIFF writing on the host.

Counterpart of ``pysp_tpu/io/image_out.py``. ``.png`` goes through the native
stored-deflate writer (``io/native.py``); PIL is used only for
``fast_png=False``, for JPEG, or where the native library did not build.
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


def save_image(path: str, srgb, fast_png: bool = True) -> None:
    """Save an sRGB float image ([0,1], (H, W, 3)) by extension: .png via the
    native fast writer (or PIL), .jpg via PIL, .tif/.tiff as built-in
    uncompressed 16-bit RGB TIFF.

    ``fast_png=True`` (default) uses the native stored-deflate PNG writer when
    built: bit-identical pixels through any decoder, at larger files than
    PIL's zlib pass. Pass ``fast_png=False`` for PIL's smaller compressed
    output.
    """
    lower = path.lower()
    if lower.endswith((".tif", ".tiff")):
        save_tiff16(path, srgb)
        return

    if lower.endswith(".png") and fast_png:
        from . import native

        if native.has_png():
            with open(path, "wb") as f:
                f.write(native.png_encode(to_uint8(srgb)))
            return

    from PIL import Image

    Image.fromarray(to_uint8(srgb), mode="RGB").save(path)


def save_png16(path: str, srgb) -> None:
    """Write a 16-bit RGB PNG via the native fast writer (PIL cannot write
    16-bit RGB PNGs at all). For a 16-bit format that needs no native build,
    use :func:`save_tiff16`."""
    from . import native

    with open(path, "wb") as f:
        f.write(native.png_encode(to_uint16(srgb)))


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
