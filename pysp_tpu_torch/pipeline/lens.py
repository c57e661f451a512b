"""The lens-corrected single-frame chain: what the command line runs on one
loaded raw.

``develop_lens_corrected`` composes, in the command line's order and with its
branches:

1. lateral CA removal with the given R and B models (``remove_ca_from_raw``);
2. hot-pixel detection and heal (``find_erroneous_pixels_median``, then
   ``repair_bad_pixels``), where asked;
3. the Bayer-domain wavelet denoise, where asked;
4. the develop (``develop``; ``develop_pipeline`` where a ``PipelineConfig``
   for a dark frame or a flat field is given, and it then does the heal and
   the denoise itself);
5. the linear-light filters with their clip and sRGB gamma
   (``finish_image``), where a ``FinishConfig`` is given;
6. the DNG OpcodeList3 WarpRectilinear (``apply_opcode_3_warp``, Lanczos4),
   where a block is given.

The chain starts after the load and the sidecar's white balance, and ends
where the warp's output is complete; saving is the caller's. Each stage is
the port's own function, so the chain gives the same bits as the stages
called one by one.

With the recorder of ``utils/tracing.py`` on, a call is the span
``pipeline.develop_lens_corrected`` (host only), with ``ca.remove``,
``pipeline.detect``, ``develop`` and ``warp.opcode3`` inside, each also timed
on the device; none reads the thread's CPU clock.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.frame import RawFrame
from ..utils.tracing import span
from .develop import DevelopConfig, develop, develop_with_stats

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FinishConfig:
    """The linear-light filters on a developed image (developed without
    gamma), in this order, then clip to [0, 1] and sRGB gamma: the command
    line's ``--deconv``, ``--unsharp``, ``--blur`` and ``--no-gamma``."""

    # Richardson-Lucy luma deconvolution: (sigma, iterations)
    deconv: Optional[Tuple[float, int]] = None
    # Oklab-L unsharp mask: (amount, radius)
    unsharp: Optional[Tuple[float, float]] = None
    # Gaussian blur sigma
    blur: Optional[float] = None
    gamma_encode: bool = True


def finish_image(image: Tensor, finish: FinishConfig) -> Tensor:
    """The filters of ``finish`` on the linear (H, W, 3) ``image``, then clip
    and gamma unless ``finish.gamma_encode`` is off."""
    from ..colorimetry.transforms import lin_srgb_to_srgb
    from ..filters.blur import blur_gaussian
    from ..filters.sharpen import gaussian_rt_deconvolution_yuv, unsharp_mask_lab

    if finish.deconv is not None:
        sigma, iters = finish.deconv
        image = gaussian_rt_deconvolution_yuv(image, sigma, int(iters))
    if finish.unsharp is not None:
        amount, radius = finish.unsharp
        image = unsharp_mask_lab(image, radius, amount)
    if finish.blur is not None:
        image = blur_gaussian(image, finish.blur)
    if finish.gamma_encode:
        image = lin_srgb_to_srgb(torch.clamp(image, 0.0, 1.0))
    return image


def develop_lens_corrected(
    frame: RawFrame,
    cfg: DevelopConfig = DevelopConfig(),
    *,
    ca_models=None,
    repair_hot_pixels: bool = False,
    denoise_strength: float = 0.0,
    pipeline=None,
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
    finish: Optional[FinishConfig] = None,
    warp_block: Optional[bytes] = None,
    stats: Optional[dict] = None,
) -> Tensor:
    """The (H, W, 3) image of one frame through the lens-corrected chain.

    ``ca_models``: ``(model_r, model_b)``, either of them None, or None for
    no CA removal. ``pipeline``: a ``PipelineConfig`` (and its ``flat`` and
    ``dark`` frames) that develops in place of the heal, the denoise and
    ``develop(frame, cfg)``. ``stats``: a dict that receives the sensor and
    output statistics of ``develop_with_stats`` (not with ``pipeline``).
    ``warp_block``: an OpcodeList3 block whose WarpRectilinear operators warp
    the finished image."""
    with span("pipeline.develop_lens_corrected", cpu=False):
        if ca_models is not None:
            from ..correct.ca.removal import remove_ca_from_raw

            frame = remove_ca_from_raw(frame, *ca_models)
        if pipeline is not None:
            from .pipeline import develop_pipeline

            out = develop_pipeline(frame, pipeline, flat=flat, dark=dark)
        else:
            if repair_hot_pixels:
                from ..correct.bad_pixels import find_erroneous_pixels_median, repair_bad_pixels

                with span("pipeline.detect", device=frame.bayer.device, cpu=False):
                    masks = find_erroneous_pixels_median(frame)
                frame = repair_bad_pixels(frame, masks)
            if denoise_strength > 0.0:
                from ..correct.denoise import denoise_bayer_wavelet

                frame = denoise_bayer_wavelet(frame, denoise_strength)
            if stats is not None:
                out, found = develop_with_stats(frame, cfg)
                stats.update(found)
            else:
                out = develop(frame, cfg)
        if finish is not None:
            out = finish_image(out, finish)
        if warp_block is not None:
            from ..warp.opcodes import apply_opcode_3_warp

            out = apply_opcode_3_warp(out, warp_block)
        return out
