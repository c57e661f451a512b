"""The develop pipeline: normalized Bayer -> demosaic -> camera->lin-sRGB -> sRGB.

Counterpart of ``pysp_tpu/pipeline/develop.py``. PyTorch runs eagerly, so
there is no jit and ``DevelopConfig`` is a plain frozen dataclass with the same
fields and defaults: the three quality tiers (Draft, Fast, Best) and both
highlight modes, ``"clip"`` and ``"reconstruct"`` (the clipped channels
rebuilt from the unclipped ones, ``correct/highlights.py``, then a soft knee
before gamma). ``develop_with_stats`` adds the sensor and output statistics
of ``utils/tracing.py``.

``use_pallas`` keeps its name and meaning: use the hand-written kernels. On a
CUDA frame, Best then develops in one launch of the AHD kernel, which computes
the whole frame, border included; more chroma-median stages than that kernel
takes, and frames under its smallest side, go through the staged AHD route on
the homogeneity and postprocess kernels. A kernel that cannot build or launch
raises.
With ``highlights="reconstruct"`` a CUDA Best frame develops through one
launch of the AHD kernel in its demosaic-only mode (the (3, H, W) planes, no
clip, matrix or gamma inside), and the reconstruction and the colour tail
follow in plain PyTorch.
On a CPU frame the plain PyTorch path runs, as the JAX package runs XLA off
the TPU. Draft and Fast are plain PyTorch on every device, as they are plain
XLA in the JAX package.

With the recorder of ``utils/tracing.py`` on, a develop is the span
``develop`` (timed on the device too), with ``develop.color_matrix`` (the
cam->lin-sRGB matrix and the reciprocal WB gains: the small launches before
the AHD kernel), ``develop.demosaic`` (the AHD kernel's wrapper, or the
plain tier) and ``develop.tail`` (the plain colour tail, where it runs)
inside; none of them reads the thread's CPU clock (``span(cpu=False)``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..colorimetry.transforms import cam_to_lin_srgb_matrix
from ..const import BayerPattern, QualityDemosaic
from ..core.bayer import reversible_transform_rggb
from ..core.frame import DevelopedImage, RawFrame, unstack_frames
from ..demosaic import demosaic
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


def _use_kernel(frame: RawFrame, cfg: DevelopConfig) -> bool:
    return (
        cfg.quality == QualityDemosaic.Best
        and cfg.use_pallas
        and frame.bayer.device.type == "cuda"
        and frame.bayer.ndim == 2
    )


def develop_to_image(frame: RawFrame, cfg: DevelopConfig) -> DevelopedImage:
    """Demosaic + un-canonicalize to the source pattern orientation. The
    highlight mode does not enter here, as in the JAX package."""
    dev = demosaic(frame, cfg.quality, cfg.postprocess_stages, cfg.use_pallas)
    if frame.source_pattern != BayerPattern.Rggb:
        dev = dev.replace(
            image=reversible_transform_rggb(dev.image, frame.source_pattern)
        )
    return dev


def _demosaic_channels(frame: RawFrame, cfg: DevelopConfig):
    from ..demosaic.ahd import demosaic_ahd_channels
    from ..demosaic.draft import demosaic_draft_channels
    from ..demosaic.eag import demosaic_eag_channels

    if cfg.quality == QualityDemosaic.Best:
        if _use_kernel(frame, cfg):
            from ..demosaic.ahd_mega import demosaic_ahd_mega

            # The AHD kernel; the staged route for frames it does not take.
            return demosaic_ahd_mega(frame, cfg.postprocess_stages)
        return demosaic_ahd_channels(frame, cfg.postprocess_stages, cfg.use_pallas)
    if cfg.quality == QualityDemosaic.Fast:
        return demosaic_eag_channels(frame)
    if cfg.quality == QualityDemosaic.Draft:
        return demosaic_draft_channels(frame)
    raise NotImplementedError(f"Quality mode not implemented: {cfg.quality}")


def _color_tail_channels(
    r: Tensor, g: Tensor, b: Tensor, mat: Tensor,
    clip_highlights: bool, gamma_encode: bool,
):
    """Channelwise colour tail: clip -> cam->lin-sRGB matrix -> sRGB gamma.
    The plain version of the AHD kernel's fused tail."""
    if clip_highlights:
        r = torch.clamp(r, 0.0, 1.0)
        g = torch.clamp(g, 0.0, 1.0)
        b = torch.clamp(b, 0.0, 1.0)
    ir = mat[0, 0] * r + mat[0, 1] * g + mat[0, 2] * b
    ig = mat[1, 0] * r + mat[1, 1] * g + mat[1, 2] * b
    ib = mat[2, 0] * r + mat[2, 1] * g + mat[2, 2] * b

    if gamma_encode:
        def gamma(x):
            x = torch.clamp(x, 0.0, 1.0)
            return torch.where(
                x <= 0.0031308,
                x * 12.92,
                1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055,
            )

        ir, ig, ib = gamma(ir), gamma(ig), gamma(ib)
    return ir, ig, ib


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
        out = srgb = None
        if cfg.highlights == "reconstruct":
            srgb = _reconstruct_channels(frame, cfg)
        elif _use_kernel(frame, cfg):
            from ..demosaic.ahd_mega import develop_channels_mega

            out = develop_channels_mega(
                frame, cfg.postprocess_stages, cfg.clip_highlights, cfg.gamma_encode
            )
        if out is None and srgb is None and frame.bayer.ndim == 2:
            if cfg.quality == QualityDemosaic.Draft:
                from ..demosaic.draft import develop_channels_draft

                with span("develop.demosaic", cpu=False):
                    srgb = develop_channels_draft(frame, cfg.clip_highlights, cfg.gamma_encode)
            elif cfg.quality == QualityDemosaic.Fast:
                from ..demosaic.eag import develop_channels_eag

                with span("develop.demosaic", cpu=False):
                    srgb = develop_channels_eag(frame, cfg.clip_highlights, cfg.gamma_encode)
        if out is None:
            if srgb is None:
                with span("develop.demosaic", cpu=False):
                    r, g, b = _demosaic_channels(frame, cfg)
                with span("develop.color_matrix", cpu=False):
                    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
                with span("develop.tail", cpu=False):
                    srgb = _color_tail_channels(
                        r, g, b, mat, cfg.clip_highlights, cfg.gamma_encode
                    )
            out = torch.stack(srgb, dim=-1).to(torch.float32)
        if frame.source_pattern != BayerPattern.Rggb:
            out = reversible_transform_rggb(out, frame.source_pattern)
        return out


def _reconstruct_channels(frame: RawFrame, cfg: DevelopConfig):
    """The develop's (r, g, b) with the clipped channels reconstructed."""
    from ..colorimetry.transforms import lin_srgb_to_srgb
    from ..correct.highlights import compress_highlights, reconstruct_highlights_channels

    with span("develop.demosaic", cpu=False):
        r, g, b = _demosaic_channels(frame, cfg)
    with span("develop.color_matrix", cpu=False):
        wb = frame.wb_reciprocal()
        mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    with span("develop.tail", cpu=False):
        r, g, b = reconstruct_highlights_channels(r, g, b, wb, frame.lim_sat)
        # no pre-matrix clip: super-white survives the matrix, then a soft knee
        # brings it under 1.0 with tonal separation before gamma
        srgb = [compress_highlights(torch.clamp(c, min=0.0))
                for c in _color_tail_channels(r, g, b, mat, False, False)]
        if cfg.gamma_encode:
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
