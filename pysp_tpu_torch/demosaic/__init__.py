"""Demosaic dispatch over the three quality tiers: Draft (quarter-res resolve
and bilinear upsample), Fast (edge-assisted Gaussian) and Best (AHD)."""
from __future__ import annotations

from ..const import QualityDemosaic
from ..core.frame import DevelopedImage, RawFrame
from .ahd import demosaic_ahd
from .draft import demosaic_draft
from .eag import demosaic_eag

__all__ = ["demosaic", "demosaic_ahd", "demosaic_draft", "demosaic_eag"]


def demosaic(
    frame: RawFrame,
    quality: QualityDemosaic = QualityDemosaic.Best,
    postprocess_steps: int = 1,
    use_pallas: bool = False,
) -> DevelopedImage:
    """Demosaic a canonical-RGGB frame at the requested quality tier.

    Un-canonicalization back to the source pattern happens in the develop
    pipeline."""
    if quality == QualityDemosaic.Draft:
        return demosaic_draft(frame)
    if quality == QualityDemosaic.Fast:
        return demosaic_eag(frame)
    if quality == QualityDemosaic.Best:
        return demosaic_ahd(
            frame, postprocess_stages=postprocess_steps, use_pallas=use_pallas
        )
    raise NotImplementedError(f"Quality mode not implemented: {quality}")
