"""The composed develop pipeline: sensor corrections, HDR fuse, develop.

Counterpart of ``pysp_tpu/pipeline/pipeline.py``. ``PipelineConfig`` has the
same fields and defaults; ``develop_pipeline`` runs eagerly where the JAX
package compiles one program. Stage order is the reference's canonical flow:
dark subtract -> flat field -> hot-pixel heal -> denoise -> HDR fuse ->
develop.

A burst is a frame with a leading frame axis on every tensor
(``core.frame.stack_frames``). Its per-frame corrections run one frame after
another, as ``lax.map`` runs them in the JAX package; then the burst either
fuses to one HDR frame (``fuse_hdr``) or develops frame by frame.

With the recorder of ``utils/tracing.py`` on, a call is the span
``pipeline.develop_pipeline``, with ``pipeline.detect`` (the hot-pixel
detector, one a frame), ``pipeline.consensus`` (the burst's shared masks),
``pipeline.correct`` (one a frame: dark, flat, heal, denoise; a detector run
for that frame alone is inside it), ``pipeline.fuse`` and then ``develop``
inside; all but ``pipeline.develop_pipeline`` are timed on the device too,
and none reads the thread's CPU clock (``span(cpu=False)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.frame import RawFrame, stack_frames, unstack_frames
from ..utils.tracing import span
from .develop import DevelopConfig, develop

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline composition knobs (same fields and defaults as the JAX package).

    Stage order: dark subtract -> flat field -> hot-pixel heal -> HDR fuse ->
    develop.
    """

    develop: DevelopConfig = DevelopConfig()
    # dark-frame subtraction (pass ``dark=`` at call time)
    dark_frame: bool = False
    # flat-field division (pass ``flat=`` at call time)
    flat_field: bool = False
    flat_clamp_high: bool = False
    # hot-pixel detect (median method) + masked-fill heal, per frame
    repair_hot_pixels: bool = False
    hot_pixel_multiplier: float = 1.5
    hot_pixel_quantile: float = 0.9999
    # fillable cluster radius for masked_fill_inpaint
    hot_pixel_iterations: int = 4
    # burst-consensus masks: flag pixels hot in >= this ratio of frames (None = per-frame)
    hot_pixel_shared_ratio: Optional[float] = None
    # Bayer-domain wavelet NR (correct/denoise.py); 0 = off, ~1 = noise floor
    denoise_strength: float = 0.0
    denoise_levels: int = 3
    # Bayer-domain HDR fuse of the burst
    fuse_hdr: bool = False
    # EV the fuse normalizes to (None = mean of the burst's EVs)
    hdr_target_ev: Optional[float] = None

    @property
    def enables_per_frame_corrections(self) -> bool:
        """True iff ``_correct_one`` would apply at least one correction: the
        single source of truth for it. ``develop_pipeline`` skips the burst's
        per-frame loop without one, so any flag added to ``_correct_one`` must
        be added here too."""
        return (
            self.dark_frame
            or self.flat_field
            or self.repair_hot_pixels
            or self.denoise_strength > 0.0
        )


def _correct_one(
    frame: RawFrame,
    cfg: PipelineConfig,
    flat: Optional[RawFrame],
    dark: Optional[RawFrame],
    masks: Optional[Tensor],
    axis_name=None,
    core_rows=None,
) -> RawFrame:
    # Keep PipelineConfig.enables_per_frame_corrections in sync with the flags
    # consulted here.
    # ``axis_name`` / ``core_rows``: on a halo-extended row shard of a mesh
    # (parallel/spatial_pipeline.py), every global statistic (flat means,
    # hot-pixel quantile, denoise sigma) reduces over the shards' core rows.
    from ..correct.bad_pixels import find_erroneous_pixels_median, repair_bad_pixels
    from ..correct.flat_field import dark_frame_subtraction, flat_frame_correction

    if cfg.dark_frame:
        frame = dark_frame_subtraction(frame, dark)
    if cfg.flat_field:
        frame = flat_frame_correction(frame, flat, clamp_high=cfg.flat_clamp_high,
                                      axis_name=axis_name, core_rows=core_rows)
    if cfg.repair_hot_pixels:
        if masks is None:
            with span("pipeline.detect", device=frame.bayer.device, cpu=False):
                masks = find_erroneous_pixels_median(
                    frame, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile,
                    axis_name=axis_name, core_rows=core_rows,
                )
        frame = repair_bad_pixels(frame, masks, cfg.hot_pixel_iterations)
    if cfg.denoise_strength > 0.0:
        from ..correct.denoise import denoise_bayer_wavelet

        frame = denoise_bayer_wavelet(frame, cfg.denoise_strength, cfg.denoise_levels,
                                      axis_name=axis_name, core_rows=core_rows)
    return frame


def develop_pipeline(
    frames: RawFrame,
    cfg: PipelineConfig = PipelineConfig(),
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
) -> Tensor:
    """Run the composed pipeline on ``frames``' device.

    ``frames``: a single RawFrame, or a burst (leading axis N on every
    tensor). Returns sRGB (H, W, 3), or (N, H, W, 3) for a burst without
    ``fuse_hdr``."""
    with span("pipeline.develop_pipeline", cpu=False):
        return _develop_pipeline(frames, cfg, flat, dark)


def _correct(frame, cfg, flat, dark, masks) -> RawFrame:
    with span("pipeline.correct", device=frame.bayer.device, cpu=False):
        return _correct_one(frame, cfg, flat, dark, masks)


def _develop_pipeline(frames, cfg, flat, dark) -> Tensor:
    from ..correct.bad_pixels import find_erroneous_pixels_median
    from ..correct.hdr import fuse_exposures_to_raw

    device = frames.bayer.device
    is_burst = frames.bayer.ndim == 3
    if cfg.fuse_hdr and not is_burst:
        raise ValueError("fuse_hdr requires a batched burst (leading frame axis)")
    if not is_burst:
        return develop(_correct(frames, cfg, flat, dark, None), cfg.develop)

    burst = unstack_frames(frames)
    shared_masks = None
    if cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None:
        # consensus across the burst (find_shared_pixels semantics), taken on
        # the frames as they come in, before any correction
        per_frame = []
        for f in burst:
            with span("pipeline.detect", device=device, cpu=False):
                per_frame.append(find_erroneous_pixels_median(
                    f, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile))
        with span("pipeline.consensus", device=device, cpu=False):
            need = float(np.ceil(np.float32(len(burst) * cfg.hot_pixel_shared_ratio)))
            shared_masks = sum(m.to(torch.int32) for m in per_frame) >= need

    if cfg.enables_per_frame_corrections:
        burst = [_correct(f, cfg, flat, dark, shared_masks) for f in burst]
    if cfg.fuse_hdr:
        with span("pipeline.fuse", device=device, cpu=False):
            if cfg.enables_per_frame_corrections:
                frames = stack_frames(burst, device=device)
            fused, _counts = fuse_exposures_to_raw(frames, cfg.hdr_target_ev)
        return develop(fused, cfg.develop)
    return torch.stack([develop(f, cfg.develop) for f in burst])
