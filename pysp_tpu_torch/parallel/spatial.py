"""Sharded develops: row sharding with a halo exchange, and batch sharding.

Counterpart of ``pysp_tpu/parallel/spatial.py``. One large frame's rows are
split over the mesh's 'spatial' axis: each shard receives a CFA-aligned halo
from its neighbours (``ppermute``), develops its padded block on its own
device and crops the halo away.

Halo semantics, as in the JAX package:
- the halo must be even (CFA phase) and at least the develop's stencil reach
  (13 rows for the AHD kernel with two chroma-median stages; default 16);
- rows away from the frame's top and bottom edges equal the monolithic
  develop's: the AHD kernel's result at a pixel does not depend on where the
  block's tiles fall, and its border rules act inside the cropped halo;
- at the frame's top and bottom the missing neighbour is the CFA-preserving
  quad reflection (pad row -k = row (k-1)^1), so the rows within the stencil
  reach of those edges differ from the monolithic develop's border modes.

``develop_burst_sharded`` splits a burst's frame axis over 'batch' and
develops each shard's frames one after another, as ``lax.map`` does.
"""
from __future__ import annotations

import torch

from ..core.frame import RawFrame
from ..pipeline.develop import DevelopConfig, develop
from .mesh import BATCH_AXIS, SPATIAL_AXIS, Mesh
from .shard import P, axis_index, ppermute, shard_map

Tensor = torch.Tensor

_FRAME_LEAVES = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _cfa_reflect_rows(block: Tensor, halo: int, top: bool) -> Tensor:
    """CFA-preserving reflection pad rows of ``block`` (..., H, W): pad row
    -k = row ((k-1) ^ 1), ordered top to bottom."""
    idx = [(k - 1) ^ 1 for k in range(1, halo + 1)]
    if top:
        return block[..., idx[::-1], :]
    h = block.shape[-2]
    return block[..., [h - 1 - i for i in idx], :]


def _pad_block(block: Tensor, halo: int, from_above: Tensor, from_below: Tensor,
               idx: int, n_sp: int) -> Tensor:
    """``block`` (..., rows, W) with its neighbours' halo rows above and below,
    or the CFA reflection at the frame's top and bottom edges."""
    top = _cfa_reflect_rows(block, halo, top=True) if idx == 0 else from_above
    bottom = _cfa_reflect_rows(block, halo, top=False) if idx == n_sp - 1 else from_below
    return torch.cat([top, block, bottom], dim=-2)


def _exchange_halos(block: Tensor, halo: int, n_sp: int):
    """(from_above, from_below): the neighbours' edge rows of ``block``
    (..., rows, W) over 'spatial'; zeros where there is no neighbour."""
    send_up = [(i, i - 1) for i in range(1, n_sp)]
    send_down = [(i, i + 1) for i in range(n_sp - 1)]
    from_below = ppermute(block[..., :halo, :].contiguous(), SPATIAL_AXIS, send_up)
    from_above = ppermute(block[..., -halo:, :].contiguous(), SPATIAL_AXIS, send_down)
    return from_above, from_below


def _frame_of(template: RawFrame, leaves) -> RawFrame:
    return RawFrame(**dict(zip(_FRAME_LEAVES, leaves)), is_hdr=template.is_hdr,
                    source_pattern=template.source_pattern)


def _leaves(frame: RawFrame):
    return tuple(getattr(frame, name) for name in _FRAME_LEAVES)


def develop_spatial(
    frame: RawFrame,
    cfg: DevelopConfig,
    mesh: Mesh,
    halo: int = 16,
    _develop_fn=None,
) -> Tensor:
    """Develop one frame with its rows sharded over the mesh's spatial axis.

    Halos are exchanged before the local develop, so each shard's AHD kernel
    launch is local to its device. ``_develop_fn(frame, cfg) -> (H, W, 3)``
    replaces the local develop (a test hook, as in the JAX package).
    Returns (H, W, 3) on the mesh's first device."""
    if halo % 2 != 0:
        raise ValueError("halo must keep CFA phase")
    dev_fn = _develop_fn or develop
    n_sp = mesh.shape[SPATIAL_AXIS]
    h = frame.bayer.shape[0]
    if h % (2 * n_sp) != 0:
        raise ValueError(f"height {h} must split into CFA-aligned blocks")

    def block_fn(bayer_block, cam_mat, cam_white, wb_neutral, ev, lim_sat):
        idx = axis_index(SPATIAL_AXIS)
        from_above, from_below = _exchange_halos(bayer_block, halo, n_sp)
        padded = _pad_block(bayer_block, halo, from_above, from_below, idx, n_sp)
        padded_frame = _frame_of(frame, (padded, cam_mat, cam_white, wb_neutral, ev, lim_sat))
        return dev_fn(padded_frame, cfg)[halo:-halo]

    sharded = shard_map(
        block_fn, mesh,
        in_specs=(P(SPATIAL_AXIS, None), P(), P(), P(), P(), P()),
        out_specs=P(SPATIAL_AXIS, None, None),
    )
    return sharded(*_leaves(frame))


def develop_burst_sharded(frames: RawFrame, cfg: DevelopConfig, mesh: Mesh) -> Tensor:
    """Develop a burst frame (leading axis N on every tensor) with the frame
    axis sharded over 'batch'; each shard develops its frames one after
    another. Returns (N, H, W, 3)."""
    n_b = mesh.shape[BATCH_AXIS]
    if frames.bayer.shape[0] % n_b != 0:
        raise ValueError(f"burst size {frames.bayer.shape[0]} must divide the batch "
                         f"axis {n_b}")

    def local_fn(*leaves):
        return torch.stack([develop(_frame_of(frames, one), cfg) for one in zip(*leaves)])

    spec = P(BATCH_AXIS)
    sharded = shard_map(
        local_fn, mesh,
        in_specs=(P(BATCH_AXIS, None, None), spec, spec, spec, spec, spec),
        out_specs=P(BATCH_AXIS, None, None, None),
    )
    return sharded(*_leaves(frames))


def develop_burst_spatial(
    frames: RawFrame,
    cfg: DevelopConfig,
    mesh: Mesh,
    halo: int = 16,
    _develop_fn=None,
) -> Tensor:
    """Fully sharded burst develop: the frame axis over 'batch' and every
    frame's rows over 'spatial', with the halo exchange of
    :func:`develop_spatial` (one ``ppermute`` each way for all of a shard's
    frames). ``_develop_fn`` replaces the local develop. Returns
    (N, H, W, 3)."""
    if halo % 2 != 0:
        raise ValueError("halo must keep CFA phase")
    dev_fn = _develop_fn or develop
    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, h = frames.bayer.shape[0], frames.bayer.shape[1]
    if n % n_b != 0 or h % (2 * n_sp) != 0:
        raise ValueError(f"burst {n}x{h} rows must split over the mesh {mesh.shape} "
                         f"(frames over batch, CFA-aligned rows over spatial)")

    def block_fn(bayer, *meta):
        # bayer: (N / n_b, H / n_sp, W)
        idx = axis_index(SPATIAL_AXIS)
        from_above, from_below = _exchange_halos(bayer, halo, n_sp)
        padded = _pad_block(bayer, halo, from_above, from_below, idx, n_sp)
        return torch.stack([dev_fn(_frame_of(frames, one), cfg)[halo:-halo]
                            for one in zip(padded, *meta)])

    bspec = P(BATCH_AXIS)
    sharded = shard_map(
        block_fn, mesh,
        in_specs=(P(BATCH_AXIS, SPATIAL_AXIS, None), bspec, bspec, bspec, bspec, bspec),
        out_specs=P(BATCH_AXIS, SPATIAL_AXIS, None, None),
    )
    return sharded(*_leaves(frames))
