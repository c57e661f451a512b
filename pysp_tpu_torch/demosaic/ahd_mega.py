"""Whole-AHD dispatch: one launch of the CUDA AHD kernel over the frame.

Counterpart of ``pysp_tpu/demosaic/ahd_mega.py``, with the same output contract
as ``demosaic_ahd_channels``. The JAX module computes the frame's interior with
its kernel and recomputes a border of ``2 * margin_for(stages)`` pixels from
four strips, because a halo tile cannot reproduce border rules that the plain
AHD applies to its intermediates. The port has no strips and no ``margin_for``:
the kernel (``ops.cuda_kernels.ahd_kernel``, ``csrc/ahd.cu``) applies every
stage's border rule itself (symmetric phase planes and CIELAB windows,
reflect-101 correlations and box sums, replicate medians), so its output is the
whole frame in its final layout and a develop is one launch. On CPU frames the
wrapper runs the plain version, which is ``demosaic_ahd_channels`` exactly.

Frames the kernel does not take go whole to the staged route,
``demosaic_ahd_channels(..., use_pallas=True)`` on the homogeneity and
postprocess kernels, as in the JAX package: more chroma-median stages than
``AHD_MAX_STAGES``, and frames with a side under ``AHD_MIN_SIDE``.
"""
from __future__ import annotations

from ..colorimetry.transforms import cam_to_lin_srgb_matrix
from ..core.frame import RawFrame
from ..ops.cuda_kernels import ahd_kernel, ahd_kernel_admits
from ..utils.tracing import span
from .ahd import demosaic_ahd_channels


def demosaic_ahd_mega(frame: RawFrame, postprocess_stages: int = 1):
    """AHD demosaic through the AHD kernel, returning (r, g, b) channels."""
    if not ahd_kernel_admits(tuple(frame.bayer.shape), postprocess_stages):
        return demosaic_ahd_channels(frame, postprocess_stages, use_pallas=True)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    planes = ahd_kernel(
        frame.bayer, mat, frame.wb_reciprocal(), frame.is_hdr, postprocess_stages
    )
    return planes[0], planes[1], planes[2]


def develop_channels_mega(
    frame: RawFrame, postprocess_stages: int, clip_highlights: bool,
    gamma_encode: bool,
):
    """Full Best develop (demosaic, clip, cam->lin-sRGB, gamma) with the colour
    tail inside the AHD kernel, returned as the (H, W, 3) image.

    Returns None when the frame is outside what the kernel takes (the caller
    then develops through ``demosaic_ahd_mega``'s staged route)."""
    if not ahd_kernel_admits(tuple(frame.bayer.shape), postprocess_stages):
        return None
    with span("develop.color_matrix", cpu=False):
        mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
        wb = frame.wb_reciprocal()
    with span("develop.demosaic", cpu=False):
        return ahd_kernel(
            frame.bayer, mat, wb, frame.is_hdr, postprocess_stages,
            tail=(clip_highlights, gamma_encode),
        )
