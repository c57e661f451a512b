"""The develop pipeline: normalized Bayer -> demosaic -> camera->lin-sRGB -> sRGB.

Counterpart of ``pysp_tpu/pipeline/develop.py``. PyTorch runs eagerly, so
there is no jit and ``DevelopConfig`` is a plain frozen dataclass with the same
fields and defaults: the three quality tiers (Draft, Fast, Best) and both
highlight modes, ``"clip"`` and ``"reconstruct"`` (the clipped channels
rebuilt from the unclipped ones, ``correct/highlights.py``, then a soft knee
before gamma). ``develop_with_stats`` adds the sensor and output statistics
of ``utils/tracing.py``.

``use_pallas`` keeps its name and meaning: use the hand-written kernels.
``demosaic.develop_route`` picks a develop's route from what it can see (the
tier, the highlight mode, the frame's device and shape, ``use_pallas`` and
the AHD kernel's gate), and nothing else decides it. On a CUDA frame Best
then develops in one launch of the AHD kernel, which computes the whole
frame, border included; more chroma-median stages than that kernel takes,
and frames under its smallest side, go through the staged AHD route on the
homogeneity and postprocess kernels. A kernel that cannot build or launch
raises. With ``highlights="reconstruct"`` a CUDA Best frame develops through
one launch of the AHD kernel in its demosaic-only mode (the (3, H, W)
planes, no clip, matrix or gamma inside), and the reconstruction and the
colour tail follow in plain PyTorch. On a CPU frame the plain PyTorch path
runs, as the JAX package runs XLA off the TPU. Draft and Fast are plain
PyTorch on every device, as they are plain XLA in the JAX package.
``develop_to_image`` (and ``demosaic``) demosaic alone: the staged route on
the card, as in the JAX package.

With the recorder of ``utils/tracing.py`` on, a develop is the span
``develop`` (timed on the device too), with ``develop.color_matrix`` (the
cam->lin-sRGB matrix, computed once a develop on every route: before
Best's demosaic, the small launches ahead of the AHD kernel; after Draft's
and Fast's planes), ``develop.demosaic`` (the AHD kernel's wrapper, or the
plain tier) and ``develop.tail`` (the plain colour tail, where it runs)
inside; none of them reads the thread's CPU clock (``span(cpu=False)``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..colorimetry.transforms import cam_to_lin_srgb_matrix, color_tail_channels
from ..const import BayerPattern, QualityDemosaic
from ..core.bayer import reversible_transform_rggb
from ..core.frame import DevelopedImage, RawFrame, unstack_frames
from ..demosaic import Route, demosaic, develop_route
from ..demosaic.ahd import ahd_channels
from ..demosaic.ahd_mega import demosaic_ahd_mega
from ..demosaic.draft import demosaic_draft_channels, draft_phases
from ..demosaic.eag import demosaic_eag_channels, eag_phases
from ..ops.polyphase import color_tail_quads
from ..utils.tracing import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DevelopConfig:
    """Develop knobs (same fields and defaults as the JAX package)."""

    quality: QualityDemosaic = QualityDemosaic.Best
    postprocess_stages: int = 1
    clip_highlights: bool = True
    gamma_encode: bool = True
    # Use the hand-written CUDA kernels for frames on a CUDA device.
    use_pallas: bool = True
    # "clip" = saturate at 1.0 (blown areas render white); "reconstruct" =
    # rebuild clipped channels from unclipped ones and compress with a soft
    # knee (correct/highlights.py), bypassing the AHD kernel's fused tail.
    highlights: str = "clip"


# Draft's and Fast's functions of (frame, wb): (the fused develop's phase
# planes, the channels).
_TIERS = {
    QualityDemosaic.Draft: (draft_phases, demosaic_draft_channels),
    QualityDemosaic.Fast: (eag_phases, demosaic_eag_channels),
}


def develop_to_image(frame: RawFrame, cfg: DevelopConfig) -> DevelopedImage:
    """Demosaic + un-canonicalize to the source pattern orientation. The
    highlight mode does not enter here, as in the JAX package."""
    dev = demosaic(frame, cfg.quality, cfg.postprocess_stages, cfg.use_pallas)
    if frame.source_pattern != BayerPattern.Rggb:
        dev = dev.replace(
            image=reversible_transform_rggb(dev.image, frame.source_pattern)
        )
    return dev


def develop(frame: RawFrame, cfg: DevelopConfig = DevelopConfig()) -> Tensor:
    """Full develop: demosaic -> camera->lin-sRGB -> (optional) gamma encode,
    returning the (H, W, 3) float32 image in the source pattern's orientation.

    With the kernel, Best's colour tail runs inside the AHD kernel and the
    image leaves it in its final layout. A 2-D Draft or Fast frame takes the
    fused polyphase develop (the tail on the phase planes, one full-res
    assembly per channel), as in the JAX package.

    With ``highlights="reconstruct"``: the demosaiced channels (on a CUDA
    Best frame the AHD kernel's planes), the reconstruction against the
    frame's WB gains and ``lim_sat``, the cam->lin-sRGB matrix with no clip
    before it, the soft knee of ``max(c, 0)``, then gamma."""
    with span("develop", device=frame.bayer.device, cpu=False):
        route = develop_route(cfg.quality, cfg.use_pallas, frame.bayer.device,
                              frame.bayer.shape, cfg.postprocess_stages, cfg.highlights)
        tail = (cfg.clip_highlights, cfg.gamma_encode)
        # Best's demosaic needs the matrix. Draft and Fast take it after their
        # planes, whose launches keep the card busy while the host launches
        # the matrix's small ones.
        mat = _color_matrix(frame) if cfg.quality == QualityDemosaic.Best else None
        wb = frame.wb_reciprocal()
        with span("develop.demosaic", cpu=False):
            if route is Route.AHD_KERNEL:
                out = demosaic_ahd_mega(frame, mat, wb, cfg.postprocess_stages, tail)
            elif route is Route.AHD_KERNEL_PLANES:
                rgb = demosaic_ahd_mega(frame, mat, wb, cfg.postprocess_stages).unbind(0)
            elif route is Route.FUSED:
                rgb = _TIERS[cfg.quality][0](frame, wb)
            elif route is Route.CHANNELS:
                rgb = _TIERS[cfg.quality][1](frame, wb)
            else:
                rgb = ahd_channels(frame.bayer, mat, wb, frame.is_hdr, cfg.postprocess_stages,
                                   staged=route is Route.AHD_STAGED)
        if route is not Route.AHD_KERNEL:
            if mat is None:
                mat = _color_matrix(frame)
            with span("develop.tail", cpu=False):
                if route is Route.FUSED:
                    srgb = color_tail_quads(rgb, mat, *tail)
                elif cfg.highlights == "reconstruct":
                    srgb = _reconstruct_tail(*rgb, frame, mat, wb, cfg.gamma_encode)
                else:
                    srgb = color_tail_channels(*rgb, mat, *tail)
            out = torch.stack(srgb, dim=-1).to(torch.float32)
        if frame.source_pattern != BayerPattern.Rggb:
            out = reversible_transform_rggb(out, frame.source_pattern)
        return out


def _color_matrix(frame: RawFrame) -> Tensor:
    """The frame's cam->lin-sRGB matrix: once a develop, in its span."""
    with span("develop.color_matrix", cpu=False):
        return cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)


def _reconstruct_tail(r, g, b, frame: RawFrame, mat, wb, gamma_encode: bool):
    """The clipped channels reconstructed against ``wb`` and ``lim_sat``,
    then the matrix with no pre-matrix clip: super-white survives it, and a
    soft knee brings it under 1.0 with tonal separation before gamma."""
    from ..colorimetry.transforms import lin_srgb_to_srgb
    from ..correct.highlights import compress_highlights, reconstruct_highlights_channels

    r, g, b = reconstruct_highlights_channels(r, g, b, wb, frame.lim_sat)
    srgb = [compress_highlights(torch.clamp(c, min=0.0))
            for c in color_tail_channels(r, g, b, mat, False, False)]
    if gamma_encode:
        srgb = [lin_srgb_to_srgb(c) for c in srgb]
    return srgb


def develop_burst(frames: RawFrame, cfg: DevelopConfig = DevelopConfig()) -> Tensor:
    """Develop a burst: every tensor of ``frames`` carries a leading frame axis.

    Frames develop one after another, as ``lax.map`` runs them in the JAX
    package; the result is (N, H, W, 3)."""
    return torch.stack([develop(f, cfg) for f in unstack_frames(frames)])


def develop_with_stats(frame: RawFrame, cfg: DevelopConfig = DevelopConfig()):
    """Develop, and the sensor and output statistics beside it:
    ``(out, {"sensor": bayer_stats(bayer, lim_sat), "output": rgb_stats(out)})``,
    each statistic a 0-d or (3,) tensor on the frame's device."""
    from ..utils.tracing import bayer_stats, rgb_stats

    stats = {"sensor": bayer_stats(frame.bayer, frame.lim_sat)}
    out = develop(frame, cfg)
    stats["output"] = rgb_stats(out)
    return out, stats
