"""HDR exposure stacking, in the Bayer domain and in the RGB domain.

Counterpart of ``pysp_tpu/correct/hdr.py``: each frame is EV-normalized
(``2^(ev - target)``), weighted by the tent ``0.5 - |x - 0.5|`` times the noise
bias ``1.6^(-0.1 * |ev_offset * wb_weight|)``, and the weighted mean is taken,
falling back to the brightest frame where the total weight is zero. Inputs are
burst frames with a leading frame axis on every tensor
(``core.frame.stack_frames``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..colorimetry.transforms import cam_to_lin_srgb
from ..core.frame import DevelopedImage, RawFrame

Tensor = torch.Tensor


def _target(evs: Tensor, target_ev: Optional[float]) -> Tensor:
    if target_ev is None:
        return evs.mean()
    return torch.full((), float(target_ev), dtype=torch.float32, device=evs.device)


def fuse_exposures_to_raw(
    frames: RawFrame, target_ev: Optional[float] = None
) -> Tuple[RawFrame, Tensor]:
    """Fuse a burst frame (leading axis N on every tensor) into one HDR raw.

    Returns (HDR frame, per-photosite contribution counts). The output keeps
    the first frame's colour metadata, with ``lim_sat = max(ev_offsets)`` and
    the HDR flag set."""
    evs = frames.ev
    target = _target(evs, target_ev)
    ev_offsets = 2.0 ** (evs - target)                                   # (N,)

    n, h, w = frames.bayer.shape
    wb = 1.0 / frames.wb_neutral[0]
    wpat = torch.stack([torch.stack([wb[0], wb[1]]), torch.stack([wb[1], wb[2]])])  # RGGB
    bias22 = 1.6 ** (-0.1 * torch.abs(ev_offsets[:, None, None] * wpat[None]))    # (N, 2, 2)

    # The (N, H/2, 2, W/2, 2) view puts the CFA phase on axes 2 and 4, so the
    # (N, 2, 2) bias broadcasts over the mosaic without a full-size copy.
    bayer = frames.bayer.reshape(n, h // 2, 2, w // 2, 2)
    bias = bias22[:, None, :, None, :]
    off = ev_offsets[:, None, None, None, None]
    weights = (0.5 - torch.abs(bayer - 0.5)) * bias
    sum_weight = weights.sum(dim=0)
    sum_pixel = (bayer * weights * off).sum(dim=0)
    counts = (weights > 0).sum(dim=0, dtype=torch.int32)

    # index_select: indexing with the 0-d argmax would read it on the host, a
    # wait for the device's queue
    max_exposure = bayer.index_select(0, torch.argmax(ev_offsets)[None])[0] * ev_offsets.max()
    fused = torch.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)

    hdr = RawFrame(
        bayer=fused.reshape(h, w).to(torch.float32),
        cam_mat=frames.cam_mat[0],
        cam_white=frames.cam_white[0],
        wb_neutral=frames.wb_neutral[0],
        ev=target,
        lim_sat=ev_offsets.max(),
        is_hdr=True,
        source_pattern=frames.source_pattern,
    )
    return hdr, counts.reshape(h, w)


def fuse_exposures_from_debayer(
    images: DevelopedImage, target_ev: Optional[float] = None
) -> Tuple[Tensor, Tensor]:
    """Fuse burst demosaiced images (leading axis N on every tensor, WB
    applied) to linear sRGB HDR. Weights are taken on the WB-undone pixels,
    the sums on the WB-applied ones. Returns (linear sRGB, counts)."""
    evs = images.ev
    target = _target(evs, target_ev)
    ev_offsets = 2.0 ** (evs - target)
    off = ev_offsets[:, None, None, None]

    undone = images.image / images.wb_coeff[:, None, None, :3]
    weights = (0.5 - torch.abs(undone - 0.5)) * (1.6 ** (-0.1 * off))
    sum_weight = weights.sum(dim=0)
    sum_pixel = (images.image * weights * off).sum(dim=0)

    max_exposure = (images.image.index_select(0, torch.argmax(ev_offsets)[None])[0]
                    * ev_offsets.max())
    fused = torch.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)
    counts = (weights > 0).sum(dim=0, dtype=torch.int32)

    lin = cam_to_lin_srgb(
        fused.to(torch.float32), images.cam_mat[0], images.cam_white[0], clip_highlights=False
    )
    return lin, counts
