"""The harness's own reader of the PNGs the program writes: 8- or 16-bit
grey or RGB, unfiltered rows (what the port's stored-deflate writer emits),
every chunk's CRC checked."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def read_png(blob: bytes) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 / uint16 pixels of ``blob``."""
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">L", blob[pos:pos + 4])
        kind, body = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">L", blob[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">LLBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(colour)
    if channels is None or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour {colour}, depth {depth}, interlace {interlace}")
    row = w * channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + row)
    if np.any(raw[:, 0]):
        raise ValueError("PNG rows are filtered; only unfiltered rows are read")
    pixels = raw[:, 1:]
    pixels = pixels.view(">u2").astype(np.uint16) if depth == 16 else pixels.copy()
    return pixels.reshape(h, w, channels) if channels == 3 else pixels.reshape(h, w)
