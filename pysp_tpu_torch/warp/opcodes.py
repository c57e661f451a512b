"""DNG OpcodeList3 parsing and WarpRectilinear application.

Counterpart of ``pysp_tpu/warp/opcodes.py``: the opcode stream walk, the
big-endian WarpRectilinear decode (plane count, six doubles per plane
kr0-3 + kt0-1, optical center), the per-plane warp, ``stack_warp_prior`` so
that a custom remap (e.g. CA) and the DNG warp resample once, and an encoder
for synthetic test DNGs. Parsing is host code; the warp runs on the image's
device through the remap kernel.

With the recorder of ``utils/tracing.py`` on, ``apply_opcode_3_warp`` is the
span ``warp.opcode3``, timed on the device too, with the ``warp.maps`` and
``warp.remap`` spans of ``warp/rectilinear.py`` inside.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.device import CARD, resolve_device
from ..ops.resample import identity_map
from ..utils.tracing import span
from .rectilinear import warp_channel_rectilinear, warp_image_rectilinear

Tensor = torch.Tensor

OPCODE_WARP_RECTILINEAR = 1


def stack_warp_prior(
    image_shape: Tuple[int, int],
    remap_r: Optional[Tuple[Tensor, Tensor]],
    remap_g: Optional[Tuple[Tensor, Tensor]],
    remap_b: Optional[Tuple[Tensor, Tensor]],
    device=CARD,
) -> List[Tuple[Tensor, Tensor]]:
    """Combine per-channel (map_x, map_y) fields on ``device`` (the card
    unless the caller asks for another), identity-filling missing channels."""
    device = resolve_device(device)
    h, w = image_shape
    ident = None
    out = []
    for remap in (remap_r, remap_g, remap_b):
        if remap is None:
            if ident is None:
                ix, iy = identity_map(h, w)
                ident = (torch.from_numpy(ix).to(device), torch.from_numpy(iy).to(device))
            out.append(ident)
        else:
            out.append((torch.as_tensor(remap[0], device=device),
                        torch.as_tensor(remap[1], device=device)))
    return out


def decode_warp_rectilinear(data: bytes, n_planes_expected: int):
    """Decode a WarpRectilinear operator block; None if malformed."""
    if len(data) < 4:
        return None
    count_planes = int.from_bytes(data[:4], byteorder="big")
    if len(data) != 4 + 6 * 8 * count_planes + 16 or count_planes != n_planes_expected:
        return None
    coefficients = []
    for idx in range(count_planes):
        coefficients.append(
            struct.unpack(">6d", data[4 + 48 * idx : 4 + 48 * (idx + 1)])
        )
    center = struct.unpack(
        ">2d", data[4 + 48 * count_planes : 4 + 48 * count_planes + 16]
    )
    return coefficients, center


def iter_opcodes(block: bytes):
    """Yield (opcode_id, version, flags, data) from an OpcodeList block."""
    count = int.from_bytes(block[:4], byteorder="big")
    offset = 4
    for _ in range(count):
        opcode_id = int.from_bytes(block[offset : offset + 4], "big")
        version = int.from_bytes(block[offset + 4 : offset + 8], "big")
        flags = int.from_bytes(block[offset + 8 : offset + 12], "big")
        var_len = int.from_bytes(block[offset + 12 : offset + 16], "big")
        offset += 16
        yield opcode_id, version, flags, block[offset : offset + var_len]
        offset += var_len


def apply_opcode_3_warp(
    image: Tensor,
    opcode_block: bytes,
    scale: float = 1.0,
    prior: Optional[Sequence[Tuple[Tensor, Tensor]]] = None,
    interpolation: str = "lanczos4",
) -> Tensor:
    """Apply the WarpRectilinear operators of an OpcodeList3 block to an
    (H, W, C) image, returning a new image; unknown opcodes are skipped.

    Without ``prior`` each operator is one channel-batched remap kernel launch
    (``warp_image_rectilinear``); with per-channel prior tables each channel
    is warped through its composed table."""
    h, w, c = image.shape

    with span("warp.opcode3", device=image.device, cpu=False):
        for opcode_id, _ver, _flags, data in iter_opcodes(opcode_block):
            if opcode_id != OPCODE_WARP_RECTILINEAR:
                continue
            decoded = decode_warp_rectilinear(data, c)
            if decoded is None:
                continue
            coefficients, center = decoded
            if prior is None:
                image = warp_image_rectilinear(
                    image, coefficients, center, scale, interpolation
                )
                continue
            planes = [
                warp_channel_rectilinear(
                    image[:, :, idx].contiguous(),
                    coeff,
                    center,
                    scale=scale,
                    prior=prior[idx],
                    interpolation=interpolation,
                )
                for idx, coeff in enumerate(coefficients)
            ]
            image = torch.stack(planes, dim=-1)
        return image


def encode_warp_rectilinear(
    coefficients: Sequence[Sequence[float]],
    center: Tuple[float, float],
    version: int = 0x01030000,
    flags: int = 0,
) -> bytes:
    """Encode one WarpRectilinear opcode into an OpcodeList3 block (the
    inverse of :func:`decode_warp_rectilinear`, for synthetic test DNGs)."""
    body = struct.pack(">L", len(coefficients))
    for coeff in coefficients:
        if len(coeff) != 6:
            raise ValueError(f"a WarpRectilinear plane has 6 coefficients, got {len(coeff)}")
        body += struct.pack(">6d", *coeff)
    body += struct.pack(">2d", *center)

    block = struct.pack(">L", 1)  # one opcode
    block += struct.pack(">LLLL", OPCODE_WARP_RECTILINEAR, version, flags, len(body))
    block += body
    return block
