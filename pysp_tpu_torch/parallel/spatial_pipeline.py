"""Row-sharded corrections, CA removal, develop and DNG warp.

Counterpart of ``pysp_tpu/parallel/spatial_pipeline.py``: one large frame
(``develop_frame_spatial``), or every frame of a burst
(``develop_pipeline_spatial``), runs its whole config-5 chain with the rows
split over the mesh's 'spatial' axis.

Why the split is exact: the CA and warp coordinate maps are fields of the
FULL frame's geometry, with host-side displacement bounds
(``correct.ca.removal._model_bound_px``,
``warp.rectilinear.displacement_bounds``). A row shard [r0, r1) therefore
needs ``halo`` = (displacement bound + resample reach) source rows beyond its
block for each stage, and its maps are the full maps' rows re-based by an
integer offset: ``get_*_coordinates_window`` and
``compute_remapping_table_window`` build a window with the same bits as a
slice of the full table.

Under the mesh:
- corrections: every global statistic (flat means, the hot-pixel quantile,
  the denoise sigma) reduces over the shards' core rows
  (``_correct_one(axis_name=..., core_rows=...)``); the heal is local to the
  shard, as in the JAX package;
- CA and warp: each remap is one launch of the remap kernel on the shard's
  halo-extended block, through the windowed maps, clipped into the frame and
  re-based into the block. The CA remaps are the plain gather, as the
  monolithic ``remove_ca_from_raw``'s; the warp takes the whole frame's
  displacement bounds, as the monolithic ``warp_image_rectilinear``;
- develop: the halo-extended block, as in ``spatial.develop_spatial``;
- rows away from the frame's top and bottom equal the monolithic
  composition's; the rows within the halo of those edges follow the
  CFA-reflection policy.

One halo exchange before the chain covers every stage: the halo is the sum
of the stages' reaches (``required_spatial_halo``). The neighbours' rows come
by ``ppermute``, or from an ``all_gather`` of the whole frame when the halo
is no smaller than a shard's rows (tiny frames).

Not carried, because it exists only for the TPU, whose Mosaic remap has no
gather: the in-shard column rectangles (``_col_rects_for`` with
``remap_fits_full_width`` and ``remap_bounded_pallas_grid``), the
``bilinear_sep`` kinds, and ``_ca_setup``'s refusal of a bound above 12 px on
a frame narrow enough for the full-width select chain. The port refuses a CA
model only where ``_model_bound_px(cap=24)`` is None, as its monolithic
``remove_ca_from_raw`` refuses none.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import RawFrame
from ..demosaic.eag import resample_b, resample_g_to_full_resolution, resample_r
from ..ops.cuda_kernels import remap_kernel
from ..pipeline.develop import develop
from ..pipeline.pipeline import PipelineConfig, _correct_one
from .mesh import BATCH_AXIS, SPATIAL_AXIS, Mesh
from .shard import P, all_gather, axis_index, psum, shard_map
from .spatial import _cfa_reflect_rows, _exchange_halos, _frame_of, _leaves, _pad_block

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# host-side static setup
# ---------------------------------------------------------------------------

def _ceil_even(v: float) -> int:
    n = int(-(-v // 1))
    return n + (n & 1)


def _ca_setup(model, full_h: int, full_w: int):
    """(bound_px, kind_inv, kind_fwd) of one model's remaps on the full
    frame, or None when its displacement has no static bound within 24 px."""
    from ..correct.ca.removal import _model_bound_px

    bound = _model_bound_px(model, full_h, full_w, cap=24)
    if bound is None:
        return None
    return bound, "bilinear", "bilinear"


def _warp_setup(
    warp_block: bytes,
    full_h: int,
    full_w: int,
    scale: float,
    interpolation: str,
) -> List[tuple]:
    """An OpcodeList3 block parsed on the host into one static plan for each
    WarpRectilinear: (coefficients per plane, center, (dyb, dxb), kind).
    Raises if a warp's displacement bounds are unavailable (no static halo
    exists)."""
    from ..warp.opcodes import OPCODE_WARP_RECTILINEAR, decode_warp_rectilinear, iter_opcodes
    from ..warp.rectilinear import displacement_bounds

    ops = []
    for opcode_id, _ver, _flags, data in iter_opcodes(warp_block):
        if opcode_id != OPCODE_WARP_RECTILINEAR:
            continue
        decoded = decode_warp_rectilinear(data, 3)
        if decoded is None:
            continue
        coefficients, center = decoded
        unique = list(dict.fromkeys(tuple(float(v) for v in co) for co in coefficients))
        bs = [displacement_bounds(co, full_w, full_h, center, scale) for co in unique]
        if any(b is None for b in bs):
            raise ValueError(
                "warp displacement bounds unavailable (beyond cap): no static "
                "halo exists for spatial sharding; use the monolithic path"
            )
        dyb = (min(b[0][0] for b in bs), max(b[0][1] for b in bs))
        dxb = (min(b[1][0] for b in bs), max(b[1][1] for b in bs))
        ops.append((coefficients, center, (dyb, dxb), interpolation))
    return ops


def required_spatial_halo(
    cfg: PipelineConfig,
    ca_setups,
    warp_ops,
    interpolation: str,
) -> int:
    """Static sensor-row halo covering every stage's reach (host accounting).

    Backwards from the output: each stage's garbage creeps inward from the
    block edge by (its displacement bound + stencil reach); the block keeps
    its full extended shape through all stages and crops once at the end, so
    the halo is the SUM of stage reaches.
    """
    h = 4  # slack
    if cfg.repair_hot_pixels:
        # median2 detect (2) + masked fill/smooth passes (3x3 on half-res)
        h += 2 * (cfg.hot_pixel_iterations + 2) + 4
    if cfg.denoise_strength > 0.0:
        # dilated B3: reach 2*2^l per level per axis, half-res planes
        h += 4 * ((1 << cfg.denoise_levels) - 1) + 4
    for setup in ca_setups:
        if setup is not None:
            # inverse warp + EAG guide/channel resamples + forward warp
            h += 2 * setup[0] + 16
    h += 16  # develop stencil reach (spatial.develop_spatial's default)
    reach = 4 if interpolation == "lanczos4" else 1
    for _co, _ce, (dyb, _dxb), *_rest in warp_ops:
        h += max(abs(dyb[0]), abs(dyb[1])) + reach + 2
    return _ceil_even(h)


# ---------------------------------------------------------------------------
# windowed device stages
# ---------------------------------------------------------------------------

def _window_maps(model, direction: str, hb: int, b0: int, full_shape, device):
    """Block-local (map_x, map_y) of a CA model's map for the absolute rows
    [b0, b0 + hb): the same values as the monolithic clipped maps' rows,
    re-based into the block (the clip to the block binds only in the halo,
    which is discarded)."""
    full_h, full_w = full_shape
    if direction == "inv":
        coords = model.get_undistorted_coordinates_window(hb, b0, full_shape, device)
    else:
        coords = model.get_distorted_coordinates_window(hb, b0, full_shape, device)
    mx = torch.clamp(coords[..., 1] + (full_w - 1) / 2.0, 0, full_w - 1)
    my = torch.clamp(coords[..., 0] + (full_h - 1) / 2.0, 0, full_h - 1)
    my = torch.clamp(my - b0, 0, hb - 1)
    return mx.contiguous(), my.contiguous()


def _remove_ca_window(
    bayer_ext: Tensor,
    model_r,
    model_b,
    wb: Tensor,
    full_shape: Tuple[int, int],
    b0: int,
    setup_r,
    setup_b,
) -> Tensor:
    """``remove_ca_from_raw``'s per-channel program on a halo-extended row
    block, the maps windowed to its absolute rows; each remap one launch of
    the remap kernel (the plain gather, as the monolithic removal)."""
    r, g1, b, g2 = bayer_to_rgbg(bayer_ext)
    g_res = resample_g_to_full_resolution(g1, g2)
    hb = g_res.shape[-2]

    def correct_channel(half_plane, model, resample, plane_idx, gain):
        g_at = remap_kernel(g_res, *_window_maps(model, "inv", hb, b0, full_shape,
                                                 g_res.device), "bilinear")
        chan_res = resample(half_plane * gain, g_at)
        chan_at_g = remap_kernel(chan_res, *_window_maps(model, "fwd", hb, b0, full_shape,
                                                         g_res.device), "bilinear")
        return bayer_to_rgbg(chan_at_g)[plane_idx] / gain

    if model_r is not None and setup_r is not None:
        r = correct_channel(r, model_r, resample_r, 0, wb[0])
    if model_b is not None and setup_b is not None:
        b = correct_channel(b, model_b, resample_b, 2, wb[2])
    return rgbg_to_bayer(r, g1, b, g2)


def _warp_window(
    img_ext: Tensor,
    warp_ops,
    scale: float,
    full_shape: Tuple[int, int],
    b0: int,
) -> Tensor:
    """``apply_opcode_3_warp`` on a halo-extended row block (H, W, 3): the
    windowed tables of the full frame, re-based into the block, and one
    remap launch for each warp with the whole frame's static bounds (one
    shared table when the planes' coefficients agree, as in
    ``warp_image_rectilinear``)."""
    from ..warp.rectilinear import compute_remapping_table_window

    full_h, full_w = full_shape
    hb = img_ext.shape[0]
    for coefficients, center, bounds, kind in warp_ops:
        coeffs = [tuple(float(v) for v in co) for co in coefficients]
        unique = list(dict.fromkeys(coeffs))
        tables = []
        for co in (unique if len(unique) == 1 else coeffs):
            mx, my = compute_remapping_table_window(co, full_w, full_h, center, scale, b0, hb,
                                                    img_ext.device)
            tables.append((torch.clamp(mx, 0, full_w - 1),
                           torch.clamp(torch.clamp(my, 0, full_h - 1) - b0, 0, hb - 1)))
        mx = torch.stack([t[0] for t in tables])
        my = torch.stack([t[1] for t in tables])
        if len(tables) == 1:
            mx, my = mx[0], my[0]
        img_ext = remap_kernel(img_ext, mx, my, kind, bounds=bounds, channels_last=True)
    return img_ext


def _static_setup(cfg: PipelineConfig, full_h: int, full_w: int, ca_model_r, ca_model_b,
                  warp_block, warp_scale, warp_interpolation, halo, refusal):
    """The host plans: (setup_r, setup_b, warp_ops, halo)."""
    setup_r = _ca_setup(ca_model_r, full_h, full_w) if ca_model_r is not None else None
    setup_b = _ca_setup(ca_model_b, full_h, full_w) if ca_model_b is not None else None
    refusal(ca_model_r is not None and setup_r is None, ca_model_b is not None and setup_b is None)
    warp_ops = (
        _warp_setup(warp_block, full_h, full_w, warp_scale, warp_interpolation)
        if warp_block is not None
        else []
    )
    if halo is None:
        halo = required_spatial_halo(cfg, (setup_r, setup_b), warp_ops, warp_interpolation)
    if halo % 2 != 0:
        raise ValueError("halo must keep CFA phase")
    return setup_r, setup_b, warp_ops, halo


def _extend(blocks: Tensor, halo: int, rows_local: int, n_sp: int, use_gather: bool) -> Tensor:
    """(..., rows_local, W) -> (..., rows_local + 2 halo, W): the neighbours'
    rows by ``ppermute`` (or, when the halo spans blocks, from an
    ``all_gather`` of the whole frame), the CFA reflection at the frame's
    top and bottom."""
    idx = axis_index(SPATIAL_AXIS)
    if use_gather:
        full = all_gather(blocks, SPATIAL_AXIS, axis=blocks.ndim - 2, tiled=True)
        padded = torch.cat([_cfa_reflect_rows(full, halo, top=True), full,
                            _cfa_reflect_rows(full, halo, top=False)], dim=-2)
        return padded[..., idx * rows_local: idx * rows_local + rows_local + 2 * halo, :]
    from_above, from_below = _exchange_halos(blocks, halo, n_sp)
    return _pad_block(blocks, halo, from_above, from_below, idx, n_sp)


def _synthetic(bayer: Optional[Tensor]) -> Optional[RawFrame]:
    return None if bayer is None else RawFrame.synthetic(bayer, device=bayer.device)


# ---------------------------------------------------------------------------
# the sharded pipelines
# ---------------------------------------------------------------------------

def develop_frame_spatial(
    frame: RawFrame,
    mesh: Mesh,
    cfg: PipelineConfig = PipelineConfig(),
    ca_model_r=None,
    ca_model_b=None,
    warp_block: Optional[bytes] = None,
    warp_scale: float = 1.0,
    warp_interpolation: str = "lanczos4",
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
    halo: Optional[int] = None,
) -> Tensor:
    """Config-5 semantics for ONE frame, rows sharded over 'spatial'.

    corrections -> CA removal -> develop -> rectilinear warp, each stage
    on the shard's halo-extended row block; one halo exchange up front covers
    every stage (``required_spatial_halo``). Returns (H, W, 3) sRGB on the
    mesh's first device, whose rows away from the frame's top and bottom
    equal the monolithic ``develop_pipeline`` + ``apply_opcode_3_warp``
    composition's.
    """
    if cfg.fuse_hdr:
        raise ValueError("fuse_hdr needs a burst; see develop_hdr_sharded")
    if frame.bayer.ndim != 2:
        raise ValueError("develop_frame_spatial shards ONE frame's rows; "
                         "use develop_pipeline_sharded for bursts")
    n_sp = mesh.shape[SPATIAL_AXIS]
    full_h, full_w = frame.bayer.shape
    if full_h % (2 * n_sp) != 0:
        raise ValueError(f"height {full_h} must split into CFA-aligned blocks over {n_sp}")
    rows_local = full_h // n_sp

    def refusal(red: bool, blue: bool) -> None:
        if red:
            raise ValueError("red CA model has no static displacement bound; "
                             "spatial sharding unavailable for it")
        if blue:
            raise ValueError("blue CA model has no static displacement bound; "
                             "spatial sharding unavailable for it")

    setup_r, setup_b, warp_ops, halo = _static_setup(
        cfg, full_h, full_w, ca_model_r, ca_model_b, warp_block, warp_scale,
        warp_interpolation, halo, refusal)
    use_gather = halo >= rows_local
    core_rows = (halo, halo + rows_local)

    def extend(block):
        return _extend(block, halo, rows_local, n_sp, use_gather)

    def block_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat, flat_bayer, dark_bayer):
        b0 = axis_index(SPATIAL_AXIS) * rows_local - halo  # absolute row of the block's top
        f = _frame_of(frame, (extend(bayer), cam_mat, cam_white, wb_neutral, ev, lim_sat))
        if cfg.enables_per_frame_corrections:
            flat_f = _synthetic(extend(flat_bayer) if flat_bayer is not None else None)
            dark_f = _synthetic(extend(dark_bayer) if dark_bayer is not None else None)
            f = _correct_one(f, cfg, flat_f, dark_f, None,
                             axis_name=SPATIAL_AXIS, core_rows=core_rows)
        if setup_r is not None or setup_b is not None:
            f = f.replace(bayer=_remove_ca_window(
                f.bayer, ca_model_r, ca_model_b, f.wb_reciprocal(), (full_h, full_w), b0,
                setup_r, setup_b))
        img = develop(f, cfg.develop)
        if warp_ops:
            img = _warp_window(img, warp_ops, warp_scale, (full_h, full_w), b0)
        return img[halo:-halo]

    cal = tuple(c.bayer if c is not None else None for c in (flat, dark))
    cal_specs = tuple(P(SPATIAL_AXIS, None) if c is not None else P() for c in cal)
    sharded = shard_map(
        block_fn, mesh,
        in_specs=(P(SPATIAL_AXIS, None), P(), P(), P(), P(), P(), *cal_specs),
        out_specs=P(SPATIAL_AXIS, None, None),
    )
    return sharded(*_leaves(frame), *cal)


def develop_pipeline_spatial(
    frames: RawFrame,
    mesh: Mesh,
    cfg: PipelineConfig = PipelineConfig(),
    ca_model_r=None,
    ca_model_b=None,
    warp_block: Optional[bytes] = None,
    warp_scale: float = 1.0,
    warp_interpolation: str = "lanczos4",
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
    halo: Optional[int] = None,
) -> Tensor:
    """Config-5 semantics on a ('batch', 'spatial') mesh: the burst's frame
    axis over 'batch' AND every frame's rows over 'spatial' -- the
    ``develop_frame_spatial`` block program run on each local frame, with the
    burst-consensus hot-pixel counts ``psum``med over 'batch' as in
    ``develop_pipeline_sharded``. Returns (N, H, W, 3).
    """
    if cfg.fuse_hdr:
        raise ValueError("fuse_hdr reduces across the frame axis; use "
                         "develop_hdr_sharded for the config-4 shape")
    if frames.bayer.ndim != 3:
        raise ValueError("develop_pipeline_spatial takes a batched RawFrame")
    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, full_h, full_w = frames.bayer.shape
    if n % n_b != 0:
        raise ValueError(f"burst size {n} must divide the batch axis {n_b}")
    if full_h % (2 * n_sp) != 0:
        raise ValueError(f"height {full_h} must split into CFA-aligned blocks over {n_sp}")
    rows_local = full_h // n_sp

    def refusal(red: bool, blue: bool) -> None:
        if red or blue:
            raise ValueError("CA model has no static displacement bound; "
                             "spatial sharding unavailable for it")

    setup_r, setup_b, warp_ops, halo = _static_setup(
        cfg, full_h, full_w, ca_model_r, ca_model_b, warp_block, warp_scale,
        warp_interpolation, halo, refusal)
    use_gather = halo >= rows_local
    core_rows = (halo, halo + rows_local)

    def extend(blocks):
        return _extend(blocks, halo, rows_local, n_sp, use_gather)

    def block_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat, flat_bayer, dark_bayer):
        b0 = axis_index(SPATIAL_AXIS) * rows_local - halo
        ext = extend(bayer)  # (n_local, rows_local + 2 halo, W)
        flat_f = _synthetic(extend(flat_bayer) if flat_bayer is not None else None)
        dark_f = _synthetic(extend(dark_bayer) if dark_bayer is not None else None)
        local = [_frame_of(frames, one)
                 for one in zip(ext, cam_mat, cam_white, wb_neutral, ev, lim_sat)]

        # burst-consensus masks: per-frame detection with the frame's own
        # statistics (psummed over 'spatial'), counts psummed over 'batch'
        shared_masks = None
        if cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None:
            from ..correct.bad_pixels import find_erroneous_pixels_median

            per_frame = [
                find_erroneous_pixels_median(f, cfg.hot_pixel_multiplier,
                                             cfg.hot_pixel_quantile,
                                             axis_name=SPATIAL_AXIS, core_rows=core_rows)
                for f in local
            ]
            total = psum(sum(m.to(torch.int32) for m in per_frame), BATCH_AXIS)
            shared_masks = total >= _consensus_need(n, cfg.hot_pixel_shared_ratio)

        out = []
        for f in local:
            if cfg.enables_per_frame_corrections or shared_masks is not None:
                f = _correct_one(f, cfg, flat_f, dark_f, shared_masks,
                                 axis_name=SPATIAL_AXIS, core_rows=core_rows)
            if setup_r is not None or setup_b is not None:
                f = f.replace(bayer=_remove_ca_window(
                    f.bayer, ca_model_r, ca_model_b, f.wb_reciprocal(), (full_h, full_w), b0,
                    setup_r, setup_b))
            img = develop(f, cfg.develop)
            if warp_ops:
                img = _warp_window(img, warp_ops, warp_scale, (full_h, full_w), b0)
            out.append(img[halo:-halo])
        return torch.stack(out)

    bspec = (P(BATCH_AXIS, SPATIAL_AXIS, None),) + (P(BATCH_AXIS),) * 5
    cal = tuple(c.bayer if c is not None else None for c in (flat, dark))
    cal_specs = tuple(P(SPATIAL_AXIS, None) if c is not None else P() for c in cal)
    sharded = shard_map(
        block_fn, mesh,
        in_specs=(*bspec, *cal_specs),
        out_specs=P(BATCH_AXIS, SPATIAL_AXIS, None, None),
    )
    return sharded(*_leaves(frames), *cal)


def _consensus_need(n: int, ratio: float) -> float:
    """Frames a site must be flagged in: ceil of the float32 ``n * ratio``,
    as ``jnp.ceil`` takes it (``find_shared_pixels``)."""
    return float(np.ceil(np.float32(n * ratio)))


__all__ = [
    "develop_frame_spatial",
    "develop_pipeline_spatial",
    "required_spatial_halo",
]
