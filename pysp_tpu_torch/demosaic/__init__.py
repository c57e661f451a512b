"""Demosaic dispatch. Only the Best (AHD) tier is ported; Draft and Fast raise
``NotImplementedError`` (ROADMAP.md queue A, item A1)."""
from __future__ import annotations

from ..const import QualityDemosaic
from ..core.frame import DevelopedImage, RawFrame
from .ahd import demosaic_ahd

__all__ = ["demosaic", "demosaic_ahd"]


def demosaic(
    frame: RawFrame,
    quality: QualityDemosaic = QualityDemosaic.Best,
    postprocess_steps: int = 1,
    use_pallas: bool = False,
) -> DevelopedImage:
    """Demosaic a canonical-RGGB frame at the requested quality tier.

    Un-canonicalization back to the source pattern happens in the develop
    pipeline."""
    if quality == QualityDemosaic.Best:
        return demosaic_ahd(
            frame, postprocess_stages=postprocess_steps, use_pallas=use_pallas
        )
    if quality in (QualityDemosaic.Fast, QualityDemosaic.Draft):
        raise NotImplementedError(
            f"Quality {quality!r} is not ported to pysp_tpu_torch yet "
            "(ROADMAP.md queue A, item A1: Draft and Fast)"
        )
    raise NotImplementedError(f"Quality mode not implemented: {quality}")
