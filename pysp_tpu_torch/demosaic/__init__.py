"""Demosaic dispatch over the three quality tiers: Draft (quarter-res resolve
and bilinear upsample), Fast (edge-assisted Gaussian) and Best (AHD), and
:func:`develop_route`, the one place that picks the route a develop or a
demosaic takes."""
from __future__ import annotations

import enum

import torch

from ..const import QualityDemosaic
from ..core.frame import DevelopedImage, RawFrame
from ..ops.cuda_kernels import ahd_kernel_admits
from .ahd import demosaic_ahd
from .draft import demosaic_draft
from .eag import demosaic_eag

__all__ = ["demosaic", "demosaic_ahd", "demosaic_draft", "demosaic_eag"]


class Route(enum.Enum):
    """How a frame develops (``pipeline.develop``) or demosaics."""

    AHD_KERNEL = "one launch of the AHD kernel, the colour tail inside it"
    AHD_KERNEL_PLANES = "the AHD kernel's (3, H, W) planes, the tail after it"
    AHD_STAGED = "the staged AHD on the homogeneity and postprocess kernels"
    AHD_PLAIN = "the plain AHD"
    FUSED = "the fused Draft or Fast develop on the phase planes"
    CHANNELS = "the Draft or Fast channels"

    @property
    def uses_kernels(self) -> bool:
        return self in (Route.AHD_KERNEL, Route.AHD_KERNEL_PLANES, Route.AHD_STAGED)


def develop_route(
    quality: QualityDemosaic, use_pallas: bool, device, shape,
    postprocess_stages: int = 1, highlights: str = "clip", tail: bool = True,
) -> Route:
    """The route of a mosaic of ``shape`` on ``device``: a develop's
    (``tail``: demosaic and colour tail) or a demosaic's alone.

    Best with ``use_pallas`` on a CUDA device takes the AHD kernel where
    :func:`ops.cuda_kernels.ahd_kernel_admits` takes the mosaic and the
    stages (its (3, H, W) planes where ``highlights`` is ``"reconstruct"``),
    and the staged route otherwise; a demosaic alone takes the staged route.
    Best elsewhere is plain. Draft and Fast take the fused develop on 2-D
    mosaics with the clipping tail, their channels otherwise."""
    if quality == QualityDemosaic.Best:
        if not (use_pallas and torch.device(device).type == "cuda"):
            return Route.AHD_PLAIN
        if tail and ahd_kernel_admits(tuple(shape), postprocess_stages):
            return Route.AHD_KERNEL_PLANES if highlights == "reconstruct" else Route.AHD_KERNEL
        return Route.AHD_STAGED
    if quality in (QualityDemosaic.Draft, QualityDemosaic.Fast):
        if tail and len(shape) == 2 and highlights != "reconstruct":
            return Route.FUSED
        return Route.CHANNELS
    raise NotImplementedError(f"Quality mode not implemented: {quality}")


def demosaic(
    frame: RawFrame,
    quality: QualityDemosaic = QualityDemosaic.Best,
    postprocess_steps: int = 1,
    use_pallas: bool = False,
) -> DevelopedImage:
    """Demosaic a canonical-RGGB frame at the requested quality tier.

    Un-canonicalization back to the source pattern happens in the develop
    pipeline."""
    route = develop_route(quality, use_pallas, frame.bayer.device, frame.bayer.shape,
                          postprocess_steps, tail=False)
    if quality == QualityDemosaic.Draft:
        return demosaic_draft(frame)
    if quality == QualityDemosaic.Fast:
        return demosaic_eag(frame)
    return demosaic_ahd(frame, postprocess_steps, use_pallas=route is Route.AHD_STAGED)
