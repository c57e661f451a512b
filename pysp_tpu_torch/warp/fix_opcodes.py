"""DNG OpcodeList1 bad-pixel operators: FixBadPixelsConstant (4), FixBadPixelsList (5).

Counterpart of ``pysp_tpu/warp/fix_opcodes.py``. The decoders, encoders and
the mask are the JAX module's host code, copied with only their imports
changed; the heal runs on the mosaic's device: the flagged photosites are
filled by the masked diffusion of ``correct/bad_pixels.py`` on the four CFA
planes, plain PyTorch as in the JAX package (no kernel). Decoding follows
DNG 1.4 section "Opcode Lists".
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

from .opcodes import iter_opcodes

Tensor = torch.Tensor

OPCODE_FIX_BAD_PIXELS_CONSTANT = 4
OPCODE_FIX_BAD_PIXELS_LIST = 5


class BadPixelsConstant(NamedTuple):
    constant: int
    bayer_phase: int


class BadPixelsList(NamedTuple):
    bayer_phase: int
    points: np.ndarray  # (N, 2) int32 (row, col)
    rects: np.ndarray   # (M, 4) int32 (top, left, bottom, right)


def decode_fix_bad_pixels_constant(data: bytes) -> Optional[BadPixelsConstant]:
    if len(data) != 8:
        return None
    constant, phase = struct.unpack(">2L", data)
    return BadPixelsConstant(constant, phase)


def encode_fix_bad_pixels_constant(op: BadPixelsConstant) -> bytes:
    return struct.pack(">2L", op.constant, op.bayer_phase)


def decode_fix_bad_pixels_list(data: bytes) -> Optional[BadPixelsList]:
    if len(data) < 12:
        return None
    phase, n_points, n_rects = struct.unpack(">3L", data[:12])
    need = 12 + 8 * n_points + 16 * n_rects
    if len(data) != need:
        return None
    pts = np.frombuffer(data[12 : 12 + 8 * n_points], dtype=">u4")
    pts = pts.reshape(-1, 2).astype(np.int32)
    rects = np.frombuffer(data[12 + 8 * n_points :], dtype=">u4")
    rects = rects.reshape(-1, 4).astype(np.int32)
    return BadPixelsList(phase, pts, rects)


def encode_fix_bad_pixels_list(op: BadPixelsList) -> bytes:
    body = struct.pack(">3L", op.bayer_phase, len(op.points), len(op.rects))
    body += np.asarray(op.points, ">u4").tobytes()
    body += np.asarray(op.rects, ">u4").tobytes()
    return body


def bad_pixel_mask_from_opcodes(
    stored: np.ndarray, opcode_block: bytes
) -> Optional[np.ndarray]:
    """(H, W) bool mask of pixels flagged by FixBadPixels* opcodes.

    ``stored`` is the raw stored-value mosaic (pre-linearization): the Constant
    variant marks pixels equal to its sentinel value. Returns None if the block
    contains no bad-pixel opcodes.
    """
    h, w = stored.shape
    mask = None
    for opcode_id, _ver, _flags, data in iter_opcodes(opcode_block):
        if opcode_id == OPCODE_FIX_BAD_PIXELS_CONSTANT:
            op = decode_fix_bad_pixels_constant(data)
            if op is None:
                continue
            m = stored == op.constant
        elif opcode_id == OPCODE_FIX_BAD_PIXELS_LIST:
            op = decode_fix_bad_pixels_list(data)
            if op is None:
                continue
            m = np.zeros((h, w), bool)
            pts = op.points[
                (op.points[:, 0] >= 0) & (op.points[:, 0] < h)
                & (op.points[:, 1] >= 0) & (op.points[:, 1] < w)
            ]
            m[pts[:, 0], pts[:, 1]] = True
            for top, left, bottom, right in op.rects:
                m[max(top, 0) : min(bottom, h), max(left, 0) : min(right, w)] = True
        else:
            continue
        mask = m if mask is None else (mask | m)
    return mask


def heal_bad_pixels_from_opcodes(
    bayer: Tensor, stored: np.ndarray, opcode_block: bytes, iterations: int = 32
) -> Tensor:
    """Heal the photosites that the block's FixBadPixels* opcodes flag on the
    normalized mosaic ``bayer`` (H, W), on its device, by masked diffusion
    over the four CFA planes. Returns ``bayer`` itself when nothing is
    flagged."""
    from ..core.bayer import bayer_to_planes, planes_to_bayer
    from ..correct.bad_pixels import diffusion_inpaint

    mask = bad_pixel_mask_from_opcodes(stored, opcode_block)
    if mask is None or not mask.any():
        return bayer
    planes = bayer_to_planes(bayer)
    mask_planes = bayer_to_planes(torch.from_numpy(mask).to(bayer.device))
    return planes_to_bayer(diffusion_inpaint(planes, mask_planes, iterations))
