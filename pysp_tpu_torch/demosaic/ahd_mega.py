"""Whole-AHD dispatch: the CUDA AHD kernel over the frame, plain border strips.

Counterpart of ``pysp_tpu/demosaic/ahd_mega.py``, with the same output contract
as ``demosaic_ahd_channels``. The kernel (``ops.cuda_kernels.ahd_kernel``)
computes every pixel in its final layout. Pixels within
``2 * margin_for(stages)`` of the image border depend on border rules applied
to intermediates (reflect-101 correlations, symmetric CIELAB windows, replicate
medians), which a halo tile cannot reproduce, so that frame is recomputed by
the plain version on four narrow crops and written over the kernel's output.

The strips run ``demosaic_ahd_channels`` on the staged route's kernels: the
homogeneity kernel for both counts and the postprocess kernel for each
chroma-median stage. Both are bit-identical to their plain versions, so the
stitched border equals the plain whole-frame result exactly; on the card each
launch replaces some 70 (a count) or 350 (a stage) elementwise launches per
strip.

Frames too small for the strips, and stage counts the AHD kernel does not
take, go whole to ``demosaic_ahd_channels`` on those two kernels, as in the
JAX package.
"""
from __future__ import annotations

import torch

from ..colorimetry.transforms import cam_to_lin_srgb_matrix
from ..core.frame import RawFrame
from ..ops.cuda_kernels import AHD_MAX_STAGES, ahd_kernel
from .ahd import demosaic_ahd_channels

Tensor = torch.Tensor


def margin_for(postprocess_stages: int) -> int:
    """Border depth, in CFA phase-plane pixels per side, that the kernel's
    output must not be trusted for: the reach of the AHD stage chain (5 full-res
    px plus 4 per chroma-median stage) rounded up, as in the JAX package."""
    return 4 + 2 * max(int(postprocess_stages), 0)


def _strip_sizes(frame: RawFrame, postprocess_stages: int):
    """(f, s): the border width to restitch and the strip crop size, or None
    when the frame or the stage count is outside what the kernel path takes."""
    h, w = frame.bayer.shape[-2], frame.bayer.shape[-1]
    f = 2 * margin_for(postprocess_stages)  # full-res border width to restitch
    s = 2 * f + 8  # strip size: f pasted rows + f reach + CFA slack
    if (
        frame.bayer.ndim != 2
        or h < 4 * s
        or w < 4 * s
        or int(postprocess_stages) > AHD_MAX_STAGES
    ):
        return None
    return f, s


def _stitch_edges(c: Tensor, t, bo, le, ri, f: int, s: int, h: int, w: int) -> None:
    """Overwrite the f-wide border frame of ``c`` in place with the strips: row
    strips first, then the full-height column strips over the corners."""
    c[:f, :] = t[:f, :]
    c[h - f :, :] = bo[s - f :, :]
    c[:, :f] = le[:, :f]
    c[:, w - f :] = ri[:, s - f :]


def _strips(frame: RawFrame, s: int, postprocess_stages: int, mat=None, tail=None):
    """AHD of the four border crops by the staged route (the homogeneity and
    postprocess kernels), then develop's tail with ``mat`` when ``tail`` is
    given."""
    from ..pipeline.develop import _color_tail_channels

    h, w = frame.bayer.shape

    def crop(rows, cols):
        sub = frame.replace(bayer=frame.bayer[rows, cols])
        r, g, b = demosaic_ahd_channels(sub, postprocess_stages, use_pallas=True)
        if tail is not None:
            r, g, b = _color_tail_channels(r, g, b, mat, *tail)
        return r, g, b

    return (
        crop(slice(0, s), slice(None)),
        crop(slice(h - s, h), slice(None)),
        crop(slice(None), slice(0, s)),
        crop(slice(None), slice(w - s, w)),
    )


def demosaic_ahd_mega(frame: RawFrame, postprocess_stages: int = 1):
    """AHD demosaic through the AHD kernel, returning (r, g, b) channels."""
    sizes = _strip_sizes(frame, postprocess_stages)
    if sizes is None:
        return demosaic_ahd_channels(frame, postprocess_stages, use_pallas=True)
    f, s = sizes
    h, w = frame.bayer.shape

    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    planes = ahd_kernel(
        frame.bayer, mat, frame.wb_reciprocal(), frame.is_hdr, postprocess_stages
    )
    top, bot, left, right = _strips(frame, s, postprocess_stages)
    for k in range(3):
        _stitch_edges(planes[k], top[k], bot[k], left[k], right[k], f, s, h, w)
    return planes[0], planes[1], planes[2]


def develop_channels_mega(
    frame: RawFrame, postprocess_stages: int, clip_highlights: bool,
    gamma_encode: bool,
):
    """Full Best develop (demosaic, clip, cam->lin-sRGB, gamma) with the colour
    tail inside the AHD kernel, returned as the (H, W, 3) image.

    The border strips run the plain demosaic and the same channelwise tail.
    Returns None when the frame is outside what the kernel path takes (the
    caller then develops through ``demosaic_ahd_mega``'s fallback)."""
    sizes = _strip_sizes(frame, postprocess_stages)
    if sizes is None:
        return None
    f, s = sizes
    h, w = frame.bayer.shape

    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    tail = (clip_highlights, gamma_encode)
    out = ahd_kernel(
        frame.bayer, mat, frame.wb_reciprocal(), frame.is_hdr, postprocess_stages,
        tail=tail,
    )
    top, bot, left, right = _strips(frame, s, postprocess_stages, mat, tail)
    for k in range(3):
        _stitch_edges(out[..., k], top[k], bot[k], left[k], right[k], f, s, h, w)
    return out
