"""Edge-assisted Gaussian ("Fast") demosaic, and the photosite-phase channel
resampling it shares with AHD.

Counterpart of ``pysp_tpu/demosaic/eag.py``. Green is filled to full resolution
by edge-weighted bilinear interpolation; R and B are recovered by
photosite-phase Gaussian upsampling of the (channel - G) difference plus
re-injection of green high frequencies. The stages are shifts and 3x3
correlations in plain PyTorch: the JAX package has no kernel for this tier
either. The resamples that CA removal calls (:func:`resample_g_to_full_resolution`,
:func:`resample_r`, :func:`resample_b`, :func:`resample_rb`) launch the EAG
kernels of ``ops.cuda_kernels`` where :func:`resamples_in_kernel` holds (CUDA
tensors), bit for bit their plain versions here
(``resample_g_to_full_resolution_plain``, ``resample_channel_plain``), which
run on CPU tensors.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import DevelopedImage, RawFrame
from ..ops.cuda_kernels import eag_fill_kernel, eag_upsample_kernel
from ..ops.phase_kernels import BayerPatternPosition, get_rgbg_kernel
from ..ops.stencil import (
    GAUSSIAN3_SIGMA1,
    filter2d,
    gaussian_blur3,
    pad_reflect,
    pad_replicate,
    shift2d,
)

Tensor = torch.Tensor


def simple_delta_mix_bilinear(top: Tensor, bottom: Tensor, left: Tensor, right: Tensor) -> Tensor:
    """Direction-weighted bilinear infill.

    More change top-bottom => blend more along the left-right axis to preserve
    the edge running left-right (and vice versa); equal weights where the
    neighbourhood is flat."""
    delta_y = torch.abs(top - bottom)
    delta_x = torch.abs(left - right)
    sum_delta = delta_y + delta_x

    avg_x = (left + right) * 0.5
    avg_y = (top + bottom) * 0.5

    nonzero = sum_delta != 0
    strength_y = torch.where(nonzero, delta_y / torch.where(nonzero, sum_delta, 1.0), 0.5)
    strength_x = 1.0 - strength_y

    return avg_y * strength_x + avg_x * strength_y


def _eag_g_phases(
    g1: Tensor, g2: Tensor, use_bilinear_weighting: bool = True
) -> Tuple[Tensor, Tensor]:
    """Interpolated G at the R and B photosites, as quarter-res phase planes.

    The polyphase core of :func:`resample_g_to_full_resolution` (same slices,
    same border reflection on the quarter-res planes), kept un-interleaved so
    the fused Fast develop can stay in phase space end to end."""
    g1p = pad_reflect(g1, 1)
    g2p = pad_reflect(g2, 1)

    h, w = g1.shape[-2], g1.shape[-1]

    # G value at the B photosite (bottom-right of quad): greens at N/S from g1, W/E from g2
    b_t = g1p[..., 1 : 1 + h, 1 : 1 + w]
    b_b = g1p[..., 2 : 2 + h, 1 : 1 + w]
    b_l = g2p[..., 1 : 1 + h, 1 : 1 + w]
    b_r = g2p[..., 1 : 1 + h, 2 : 2 + w]

    # G value at the R photosite (top-left of quad)
    r_t = g2p[..., 0:h, 1 : 1 + w]
    r_b = g2p[..., 1 : 1 + h, 1 : 1 + w]
    r_l = g1p[..., 1 : 1 + h, 0:w]
    r_r = g1p[..., 1 : 1 + h, 1 : 1 + w]

    if not use_bilinear_weighting:
        r = (r_t + r_b + r_l + r_r) * 0.25
        b = (b_t + b_b + b_l + b_r) * 0.25
    else:
        r = simple_delta_mix_bilinear(r_t, r_b, r_l, r_r)
        b = simple_delta_mix_bilinear(b_t, b_b, b_l, b_r)
    return r, b


def resample_g_to_full_resolution_plain(
    g1: Tensor, g2: Tensor, use_bilinear_weighting: bool = True
) -> Tensor:
    """Fill G to sensor resolution from the two green phases.

    Original photosites are preserved; the missing R/B positions are
    interpolated from the 4 cardinal greens (reflect padding hides the
    borders)."""
    r, b = _eag_g_phases(g1, g2, use_bilinear_weighting)
    return rgbg_to_bayer(r, g1, b, g2)


def resamples_in_kernel(t: Tensor) -> bool:
    """Whether the resamples of ``t``'s planes launch the EAG kernels: on
    CUDA tensors, one launch a resample over every frame."""
    return t.is_cuda


def resample_g_to_full_resolution(
    g1: Tensor, g2: Tensor, use_bilinear_weighting: bool = True
) -> Tensor:
    """:func:`resample_g_to_full_resolution_plain`, on CUDA tensors by the
    EAG fill kernel."""
    if resamples_in_kernel(g1):
        return eag_fill_kernel(g1, g2, use_bilinear_weighting)
    return resample_g_to_full_resolution_plain(g1, g2, use_bilinear_weighting)


def _phase_upsample(plane: Tensor, position: BayerPatternPosition) -> Tensor:
    """Upsample a quarter-res plane to full res with the 4 phase kernels."""
    k_tl, k_tr, k_bl, k_br = get_rgbg_kernel(position)
    return rgbg_to_bayer(
        filter2d(plane, k_tl),
        filter2d(plane, k_tr),
        filter2d(plane, k_br),
        filter2d(plane, k_bl),
    )


def resample_channel(
    subpixel: Tensor,
    g_at_subpixel: Tensor,
    g_hf_pass: Tensor,
    position: BayerPatternPosition,
) -> Tensor:
    """Full-res channel from quarter-res samples via G-difference upsampling,
    in the reduced form ``up(sub) + hf`` (the green term cancels because the
    photosite-phase correlation is linear), as in the JAX package."""
    del g_at_subpixel  # cancels by linearity
    return _phase_upsample(subpixel, position) + g_hf_pass


def resample_channel_plain(
    subpixel: Tensor, g_upscaled: Tensor, position: BayerPatternPosition
) -> Tensor:
    """:func:`resample_channel` with the high frequencies of the
    full-resolution green ``g_upscaled`` (itself less its 3x3 Gaussian blur)."""
    return _phase_upsample(subpixel, position) + (g_upscaled - gaussian_blur3(g_upscaled))


def _resample(subpixel: Tensor, g_upscaled: Tensor, position: BayerPatternPosition) -> Tensor:
    if resamples_in_kernel(subpixel):
        return eag_upsample_kernel(subpixel, g_upscaled, position)
    return resample_channel_plain(subpixel, g_upscaled, position)


def resample_r(r: Tensor, g_upscaled: Tensor) -> Tensor:
    """Resample R alone: :func:`resample_channel_plain` at TOP_LEFT, on CUDA
    tensors by the EAG upsample kernel."""
    return _resample(r, g_upscaled, BayerPatternPosition.TOP_LEFT)


def resample_b(b: Tensor, g_upscaled: Tensor) -> Tensor:
    """Resample B alone: :func:`resample_channel_plain` at BOTTOM_RIGHT, on
    CUDA tensors by the EAG upsample kernel."""
    return _resample(b, g_upscaled, BayerPatternPosition.BOTTOM_RIGHT)


def resample_rb(r: Tensor, b: Tensor, g_upscaled: Tensor) -> Tuple[Tensor, Tensor]:
    """Resample R and B to full resolution; the plain path blurs the green
    once for both."""
    if resamples_in_kernel(r):
        return resample_r(r, g_upscaled), resample_b(b, g_upscaled)
    g_hf_cut = g_upscaled - gaussian_blur3(g_upscaled)
    return (_phase_upsample(r, BayerPatternPosition.TOP_LEFT) + g_hf_cut,
            _phase_upsample(b, BayerPatternPosition.BOTTOM_RIGHT) + g_hf_cut)


def _blur3_phases(quad):
    """``gaussian_blur3`` of the full-res interleave, computed per phase.

    Separable [a, b, a] passes in phase space: for output row-phase 0 the
    vertical taps are (P1[i-1], P0[i], P1[i]); for row-phase 1 they are
    (P0[i], P1[i], P0[i+1]). The full-res reflect101 border maps full row -1
    to full row +1, which in phase space is the opposite-parity plane's row 0,
    a replicate pad on the shifted plane (same for columns). Values match the
    interleaved ``gaussian_blur3`` to conv-association order (about 1 ulp)."""
    # GAUSSIAN3_SIGMA1 = outer(g, g) for the 1-D taps g = (s1, c1, s1)
    c1 = math.sqrt(float(GAUSSIAN3_SIGMA1[1, 1]))
    s1 = float(GAUSSIAN3_SIGMA1[0, 1]) / c1

    def pass_axis(q, axis):
        (p00, p01), (p10, p11) = q

        def up1(p):  # p[i-1] with replicate border
            return shift2d(p, -1, 0, pad_replicate) if axis == 0 else shift2d(p, 0, -1, pad_replicate)

        def dn1(p):  # p[i+1] with replicate border
            return shift2d(p, 1, 0, pad_replicate) if axis == 0 else shift2d(p, 0, 1, pad_replicate)

        if axis == 0:
            o00 = s1 * up1(p10) + c1 * p00 + s1 * p10
            o01 = s1 * up1(p11) + c1 * p01 + s1 * p11
            o10 = s1 * p00 + c1 * p10 + s1 * dn1(p00)
            o11 = s1 * p01 + c1 * p11 + s1 * dn1(p01)
        else:
            o00 = s1 * up1(p01) + c1 * p00 + s1 * p01
            o10 = s1 * up1(p11) + c1 * p10 + s1 * p11
            o01 = s1 * p00 + c1 * p01 + s1 * dn1(p00)
            o11 = s1 * p10 + c1 * p11 + s1 * dn1(p10)
        return ((o00, o01), (o10, o11))

    return pass_axis(pass_axis(quad, 0), 1)


def _phase_upsample_quad(plane: Tensor, position: BayerPatternPosition):
    """:func:`_phase_upsample` without the interleave: the 4 phase planes directly."""
    k_tl, k_tr, k_bl, k_br = get_rgbg_kernel(position)
    return (
        (filter2d(plane, k_tl), filter2d(plane, k_tr)),
        (filter2d(plane, k_bl), filter2d(plane, k_br)),
    )


def eag_phases(frame: RawFrame, wb: Tensor):
    """The fused Fast develop's (r, g, b) quads, with the reciprocal WB gains
    ``wb``: the whole EAG pipeline on the four CFA phase planes (G fill and
    blur3 as phase stencils; the photosite-phase R/B convolutions already
    produce phases)."""
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    gr, gb = _eag_g_phases(g1, g2)
    w1 = wb[1]
    gq = ((gr * w1, g1 * w1), (g2 * w1, gb * w1))
    gblur = _blur3_phases(gq)
    ghf = tuple(
        tuple(gq[py][px] - gblur[py][px] for px in (0, 1)) for py in (0, 1)
    )

    rq = _phase_upsample_quad(r * wb[0], BayerPatternPosition.TOP_LEFT)
    bq = _phase_upsample_quad(b * wb[2], BayerPatternPosition.BOTTOM_RIGHT)

    def with_hf(q):
        return tuple(tuple(q[py][px] + ghf[py][px] for px in (0, 1)) for py in (0, 1))

    return with_hf(rq), gq, with_hf(bq)


def develop_channels_eag(
    frame: RawFrame, mat: Tensor, wb: Tensor, clip_highlights: bool, gamma_encode: bool,
):
    """Fused Fast develop: the whole EAG pipeline + colour tail in phase space,
    with the cam->lin-sRGB ``mat`` and the reciprocal WB gains ``wb``.

    The (pointwise) colour tail runs on each phase of :func:`eag_phases`, and
    the full-res image is assembled once per channel. The same taps as
    :func:`demosaic_eag_channels` plus the tail, up to conv and association
    rounding order."""
    from ..ops.polyphase import color_tail_quads

    return color_tail_quads(eag_phases(frame, wb), mat, clip_highlights, gamma_encode)


def demosaic_eag_channels(frame: RawFrame, wb: Tensor):
    """Fast demosaic with the reciprocal WB gains ``wb``, returning separate
    (r, g, b) channels."""
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)

    g_up = resample_g_to_full_resolution(g1, g2) * wb[1]
    r_up, b_up = resample_rb(r * wb[0], b * wb[2], g_up)
    return r_up, g_up, b_up


def demosaic_eag(frame: RawFrame) -> DevelopedImage:
    """Fast demosaic entry point."""
    wb = frame.wb_reciprocal()
    r_up, g_up, b_up = demosaic_eag_channels(frame, wb)
    return DevelopedImage(
        image=torch.stack([r_up, g_up, b_up], dim=-1).to(torch.float32),
        wb_coeff=wb,
        cam_mat=frame.cam_mat,
        cam_white=frame.cam_white,
        ev=frame.ev,
        wb_applied=True,
        wb_normalized=False,
    )
