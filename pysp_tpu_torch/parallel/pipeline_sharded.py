"""The whole pipeline under the device mesh: config 5 over a burst, config 4
as a collective HDR fuse.

Counterpart of ``pysp_tpu/parallel/pipeline_sharded.py``. Two layouts, as the
work decomposes:

- ``develop_pipeline_sharded``, the config-5 shape (bursts of small frames):
  frames are split over the mesh's 'batch' axis and each shard runs the whole
  per-frame program (corrections -> CA removal -> develop -> rectilinear
  warp) on its own frames. The CA and warp maps are full-frame fields, so
  the frames themselves are not split; the one interaction between shards,
  the burst-consensus hot-pixel masks, is a ``psum`` of the per-frame mask
  counts over 'batch' (``find_shared_pixels`` semantics). Each shard's CA is
  the port's burst removal on its local stack: the maps built once, one remap
  launch a map over the shard's frames. On a mesh whose 'spatial' axis is
  longer than 1, the call goes to ``spatial_pipeline.develop_pipeline_spatial``
  (the frames' rows split too).
- ``develop_hdr_sharded``, the config-4 shape (a bracket of large frames that
  fuses to one): per-frame weighted sums reduce over 'batch' by ``psum`` (the
  fuse is the collective), the EVs and the first frame's neutral come by
  ``all_gather``, the fused frame lands on every shard, and the one develop
  after it is row-sharded over 'spatial', each shard slicing its halo rows
  from its own copy of the fused frame (no ``ppermute``). As under
  ``shard_map``, the batch axis' shards all develop; the gather keeps batch
  row 0's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.frame import RawFrame, stack_frames
from ..pipeline.develop import develop
from ..pipeline.pipeline import PipelineConfig, _correct_one
from .mesh import BATCH_AXIS, SPATIAL_AXIS, Mesh
from .shard import P, all_gather, axis_index, psum, shard_map
from .spatial import _cfa_reflect_rows, _frame_of, _leaves
from .spatial_pipeline import _consensus_need, _synthetic

Tensor = torch.Tensor


def _shared_masks(local, cfg: PipelineConfig, n: int):
    """Burst-consensus masks of the whole burst: the local frames' mask
    counts ``psum``med over 'batch' against ceil(n * ratio); None without
    consensus."""
    if not (cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None):
        return None
    from ..correct.bad_pixels import find_erroneous_pixels_median

    per_frame = [find_erroneous_pixels_median(f, cfg.hot_pixel_multiplier,
                                              cfg.hot_pixel_quantile) for f in local]
    total = psum(sum(m.to(torch.int32) for m in per_frame), BATCH_AXIS)
    return total >= _consensus_need(n, cfg.hot_pixel_shared_ratio)


def develop_pipeline_sharded(
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
) -> Tensor:
    """Config-5 semantics batch-sharded: corrections + CA + develop + warp.

    ``frames`` is a burst frame (leading axis N on every tensor); N must
    divide by the mesh's batch size. ``flat`` / ``dark`` are single
    calibration frames, copied to every shard. Returns (N, H, W, 3) sRGB on
    the mesh's first device.
    """
    if cfg.fuse_hdr:
        raise ValueError(
            "fuse_hdr reduces across the sharded frame axis; use "
            "develop_hdr_sharded for the config-4 shape"
        )
    if mesh.shape[SPATIAL_AXIS] > 1:
        from .spatial_pipeline import develop_pipeline_spatial

        return develop_pipeline_spatial(
            frames, mesh, cfg,
            ca_model_r=ca_model_r, ca_model_b=ca_model_b,
            warp_block=warp_block, warp_scale=warp_scale,
            warp_interpolation=warp_interpolation, flat=flat, dark=dark,
        )
    n_b = mesh.shape[BATCH_AXIS]
    n = frames.bayer.shape[0]
    if n % n_b != 0:
        raise ValueError(f"burst size {n} must divide the batch axis {n_b}")

    from ..correct.ca.removal import remove_ca_from_raw
    from ..warp.opcodes import apply_opcode_3_warp

    def local_fn(leaves, flat_bayer, dark_bayer):
        flat_f, dark_f = _synthetic(flat_bayer), _synthetic(dark_bayer)
        local = [_frame_of(frames, one) for one in zip(*leaves)]
        shared_masks = _shared_masks(local, cfg, n)
        if cfg.enables_per_frame_corrections or shared_masks is not None:
            local = [_correct_one(f, cfg, flat_f, dark_f, shared_masks) for f in local]
        # the shard's CA as one burst: maps once, one remap launch a map
        stack = remove_ca_from_raw(stack_frames(local, device=local[0].device),
                                   ca_model_r, ca_model_b)
        out = []
        for k in range(len(local)):
            img = develop(_frame_of(frames, [leaf[k] for leaf in _leaves(stack)]), cfg.develop)
            if warp_block is not None:
                img = apply_opcode_3_warp(img, warp_block, warp_scale,
                                          interpolation=warp_interpolation)
            out.append(img)
        return torch.stack(out)

    bspec = (P(BATCH_AXIS, None, None),) + (P(BATCH_AXIS),) * 5
    cal = tuple(c.bayer if c is not None else None for c in (flat, dark))
    sharded = shard_map(
        local_fn, mesh,
        in_specs=(bspec, P(), P()),
        out_specs=P(BATCH_AXIS, None, None, None),
    )
    return sharded(_leaves(frames), *cal)


def develop_hdr_sharded(
    frames: RawFrame,
    mesh: Mesh,
    cfg: PipelineConfig,
    halo: int = 16,
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
) -> Tensor:
    """Config 4 under the mesh: per-frame corrections on each batch shard ->
    the HDR fuse as a 'batch' ``psum`` -> ONE develop row-sharded over
    'spatial'.

    The fuse follows ``fuse_exposures_to_raw`` with the frame reduction
    replaced by local sums and a ``psum``; the target EV and the brightest
    frame come from an ``all_gather`` of the EVs, so every shard agrees. The
    colour metadata is the burst's first frame's. Returns (H, W, 3) sRGB on
    the mesh's first device.
    """
    if not cfg.fuse_hdr:
        raise ValueError("develop_hdr_sharded is the fuse_hdr path")
    if halo % 2 != 0:
        raise ValueError("halo must keep CFA phase")
    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, h, w = frames.bayer.shape
    if n % n_b != 0:
        raise ValueError(f"bracket size {n} must divide the batch axis {n_b}")
    if h % (2 * n_sp) != 0:
        raise ValueError("rows must split CFA-aligned over 'spatial'")
    n_local = n // n_b
    rows_local = h // n_sp

    def local_fn(leaves, flat_bayer, dark_bayer):
        flat_f, dark_f = _synthetic(flat_bayer), _synthetic(dark_bayer)
        local = [_frame_of(frames, one) for one in zip(*leaves)]
        shared_masks = _shared_masks(local, cfg, n)
        if cfg.enables_per_frame_corrections:
            local = [_correct_one(f, cfg, flat_f, dark_f, shared_masks) for f in local]
        bayer = torch.stack([f.bayer for f in local])                     # (n_local, H, W)
        ev = torch.stack([f.ev for f in local])

        def of_burst(name: str) -> Tensor:
            """Every frame's ``name`` in burst order, (n, ...)."""
            return all_gather(torch.stack([getattr(f, name) for f in local]),
                              BATCH_AXIS).flatten(0, 1)

        # ---- the HDR fuse as a collective (fuse_exposures_to_raw) ----
        evs_all = of_burst("ev")
        target = (evs_all.mean() if cfg.hdr_target_ev is None
                  else torch.full((), float(cfg.hdr_target_ev), device=ev.device))
        offsets_all = 2.0 ** (evs_all - target)
        idx_max = int(torch.argmax(offsets_all))
        local_off = 2.0 ** (ev - target)                                  # (n_local,)

        wb_neutral0 = of_burst("wb_neutral")[0]          # the burst's first frame's
        wb = 1.0 / wb_neutral0
        wpat = torch.stack([torch.stack([wb[0], wb[1]]), torch.stack([wb[1], wb[2]])])
        bias22 = 1.6 ** (-0.1 * torch.abs(local_off[:, None, None] * wpat[None]))

        q = bayer.reshape(n_local, h // 2, 2, w // 2, 2)    # CFA phase on axes 2 and 4
        weights = (0.5 - torch.abs(q - 0.5)) * bias22[:, None, :, None, :]
        first = axis_index(BATCH_AXIS) * n_local
        brightest = (q[idx_max - first] if first <= idx_max < first + n_local
                     else torch.zeros_like(q[0]))
        sums = (
            weights.sum(dim=0),
            (q * weights * local_off[:, None, None, None, None]).sum(dim=0),
            brightest,
        )
        sum_weight, sum_pixel, max_pix = psum(sums, BATCH_AXIS)
        max_exposure = max_pix * offsets_all.max()
        fused = torch.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)
        fused = fused.reshape(h, w).to(torch.float32)

        # ---- the spatial develop of the fused frame each shard holds ----
        padded = torch.cat([_cfa_reflect_rows(fused, halo, top=True), fused,
                            _cfa_reflect_rows(fused, halo, top=False)], dim=0)
        r0 = axis_index(SPATIAL_AXIS) * rows_local
        hdr_frame = RawFrame(
            bayer=padded[r0:r0 + rows_local + 2 * halo],
            cam_mat=of_burst("cam_mat")[0],
            cam_white=of_burst("cam_white")[0],
            wb_neutral=wb_neutral0,
            ev=target,
            lim_sat=offsets_all.max(),
            is_hdr=True,
            source_pattern=frames.source_pattern,
        )
        return develop(hdr_frame, cfg.develop)[halo:-halo]

    bspec = (P(BATCH_AXIS, None, None),) + (P(BATCH_AXIS),) * 5
    cal = tuple(c.bayer if c is not None else None for c in (flat, dark))
    sharded = shard_map(
        local_fn, mesh,
        in_specs=(bspec, P(), P()),
        out_specs=P(SPATIAL_AXIS, None, None),
    )
    return sharded(_leaves(frames), *cal)
