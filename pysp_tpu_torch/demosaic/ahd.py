"""AHD ("Best") demosaic in plain PyTorch — Hirakawa–Parks Adaptive
Homogeneity-Directed demosaicing.

Counterpart of ``pysp_tpu/demosaic/ahd.py``, with the same operation order line
for line: directional green interpolation H/V with the blended 5-tap filter,
full-res R/B reconstruction by phase-kernel upsampling plus green HF
re-injection, CIELAB homogeneity maps for both directions (HDR: luma L and
tonemapped chroma), 3x3 box-summed maps with a binary direction pick, and
iterative chroma-median postprocessing.

This is the port's CPU path and the plain version the AHD kernel is held
against over the whole frame (``ahd_channels`` plus
``colorimetry.transforms.color_tail_channels``). ``ahd_channels(...,
staged=True)`` is the staged route: the homogeneity counts come from the
homogeneity kernel and the chroma-median stages from the postprocess kernel,
both bit-identical to their plain versions (which their wrappers run on CPU
tensors), so the route equals the plain one exactly. It develops what the AHD
kernel does not take: more than two chroma-median stages and frames under the
kernel's smallest side.
"""
from __future__ import annotations

import numpy as np
import torch

from ..colorimetry.transforms import cam_to_lin_srgb_matrix, rgb_to_lab_channels
from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import DevelopedImage, RawFrame
from ..ops.phase_kernels import BayerPatternPosition
from ..ops.stencil import box_sum3, gaussian_blur3, median5, pad_reflect
from .eag import resample_channel
from .homogeneity import homogeneity_map_channels

Tensor = torch.Tensor

# Blended 5-tap green filter: h_optimal from the paper, h_fast its power-of-two
# variant; 12.5% optimal reduces maze artifacts without pink fringing.
_H_OPTIMAL = np.array([-0.2569, 0.4339, 0.5138, 0.4339, -0.2569], dtype=np.float64)
_H_FAST = np.array([-0.25, 0.5, 0.5, 0.5, -0.25], dtype=np.float64)
_RATIO_OPTIMAL = 0.125
_H = _H_OPTIMAL * _RATIO_OPTIMAL + _H_FAST * (1 - _RATIO_OPTIMAL)
_H = (_H / _H.sum()).astype(np.float32)


def _build_homogeneity_map(
    r: Tensor, g: Tensor, b: Tensor, mat: Tensor, wb: Tensor, is_hdr: bool,
    is_vertical: bool, count=homogeneity_map_channels,
) -> Tensor:
    """LAB homogeneity for one direction, counted by ``count``
    (:func:`homogeneity_map_channels` or :func:`_homogeneity_kernel_count`).

    WB is multiplied in a second time here (the candidate planes already carry
    it from the interpolation stage), as the reference does."""
    rr, gg, bb = r * wb[0], g * wb[1], b * wb[2]
    ir = mat[0, 0] * rr + mat[0, 1] * gg + mat[0, 2] * bb
    ig = mat[1, 0] * rr + mat[1, 1] * gg + mat[1, 2] * bb
    ib = mat[2, 0] * rr + mat[2, 1] * gg + mat[2, 2] * bb

    if is_hdr:
        # HDR: keep unbounded luma as L*, tonemap chroma
        luma = 0.2126 * ir + 0.7152 * ig + 0.0722 * ib
        ir = ir / (1.0 + ir)
        ig = ig / (1.0 + ig)
        ib = ib / (1.0 + ib)
        lum, la, lb = rgb_to_lab_channels(ir, ig, ib)
        lum = luma
    else:
        lum, la, lb = rgb_to_lab_channels(ir, ig, ib)
    return count(lum, la, lb, is_vertical)


def _homogeneity_kernel_count(lum: Tensor, a: Tensor, b: Tensor, is_vertical: bool) -> Tensor:
    """The staged route's count: the homogeneity kernel, bit-identical to
    :func:`homogeneity_map_channels`, which its wrapper runs on CPU planes."""
    from ..ops.cuda_kernels import homogeneity_kernel

    return homogeneity_kernel(lum.contiguous(), a.contiguous(), b.contiguous(), is_vertical)


def ahd_decision_plain(
    r_h: Tensor, g_h: Tensor, b_h: Tensor, r_v: Tensor, g_v: Tensor, b_v: Tensor,
    mat: Tensor, wb: Tensor, is_hdr: bool, count=homogeneity_map_channels,
) -> Tensor:
    """The H/V pick from the six candidate fields: 1.0 where the horizontal
    candidate's box-summed homogeneity is below the vertical one's. The plain
    version of the decision kernel (``ops.cuda_kernels.decision_kernel``).

    The counts are integers, so the unnormalized sums compare exactly; the
    staged route's ``count`` (:func:`_homogeneity_kernel_count`) changes no
    value."""
    map_h = box_sum3(_build_homogeneity_map(r_h, g_h, b_h, mat, wb, is_hdr, False, count))
    map_v = box_sum3(_build_homogeneity_map(r_v, g_v, b_v, mat, wb, is_hdr, True, count))
    return (map_h < map_v).to(torch.float32)


def ahd_decision(
    r_h: Tensor, g_h: Tensor, b_h: Tensor, r_v: Tensor, g_v: Tensor, b_v: Tensor,
    mat: Tensor, wb: Tensor, is_hdr: bool,
) -> Tensor:
    """The H/V pick in one pass by the decision kernel on CUDA fields
    (:func:`ahd_decision_plain` on CPU ones). Counterpart of
    ``pysp_tpu/ops/pallas_kernels.py::ahd_decision_pallas``; as there,
    :func:`ahd_channels` does not call it: its ``cbrtf`` flips picks at exact
    ties, and the staged route equals the plain one bit for bit."""
    from ..ops.cuda_kernels import decision_kernel

    return decision_kernel(r_h, g_h, b_h, r_v, g_v, b_v, mat, wb, is_hdr)


def postprocess_color_channels(r: Tensor, g: Tensor, b: Tensor):
    """One chroma-median stage on separate channels; the plain version of the
    postprocess kernel (``ops.cuda_kernels.postprocess_color_kernel``)."""
    r = median5(r - g) + g
    b = median5(b - g) + g
    g = (median5(g - r) + median5(g - b) + r + b) * 0.5
    return r, g, b


def postprocess_color(image: Tensor, use_pallas: bool = False) -> Tensor:
    """One chroma-median stage on an (H, W, 3) image. With ``use_pallas`` it
    goes through the postprocess kernel's (H, W, 3) entry
    (``ops.cuda_kernels.postprocess_color_image_kernel``, bit-identical, the
    plain stage on a CPU image); otherwise the plain stage runs on the three
    channels."""
    if use_pallas:
        from ..ops.cuda_kernels import postprocess_color_image_kernel

        return postprocess_color_image_kernel(image.contiguous())
    r, g, b = postprocess_color_channels(image[..., 0], image[..., 1], image[..., 2])
    return torch.stack([r, g, b], dim=-1)


def ahd_candidates(bayer: Tensor, wb: Tensor):
    """The six candidate fields ``(r_h, g_h, b_h, r_v, g_v, b_v)`` of a
    canonical-RGGB mosaic (H, W): green interpolated along the rows (h) and
    along the columns (v), and R and B rebuilt on each."""
    r0, g1_0, b0, g2_0 = bayer_to_rgbg(bayer)

    # Pad planes 1px (BORDER_REFLECT) and pre-apply WB
    r = pad_reflect(r0, 1) * wb[0]
    g1 = pad_reflect(g1_0, 1) * wb[1]
    b = pad_reflect(b0, 1) * wb[2]
    g2 = pad_reflect(g2_0, 1) * wb[1]

    h = [float(v) for v in _H]

    # Directional green estimates at R sites
    gh_r = (
        r[1:-1, :-2] * h[0]
        + g1[1:-1, :-2] * h[1]
        + r[1:-1, 1:-1] * h[2]
        + g1[1:-1, 1:-1] * h[3]
        + r[1:-1, 2:] * h[4]
    )
    gv_r = (
        r[:-2, 1:-1] * h[0]
        + g2[:-2, 1:-1] * h[1]
        + r[1:-1, 1:-1] * h[2]
        + g2[1:-1, 1:-1] * h[3]
        + r[2:, 1:-1] * h[4]
    )

    # Directional green estimates at B sites
    gh_b = (
        b[1:-1, :-2] * h[0]
        + g2[1:-1, 1:-1] * h[1]
        + b[1:-1, 1:-1] * h[2]
        + g2[1:-1, 2:] * h[3]
        + b[1:-1, 2:] * h[4]
    )
    gv_b = (
        b[:-2, 1:-1] * h[0]
        + g1[1:-1, 1:-1] * h[1]
        + b[1:-1, 1:-1] * h[2]
        + g1[2:, 1:-1] * h[3]
        + b[2:, 1:-1] * h[4]
    )

    g1_c = g1[1:-1, 1:-1]
    g2_c = g2[1:-1, 1:-1]

    # Full-resolution green fields
    g_h = rgbg_to_bayer(gh_r, g1_c, gh_b, g2_c)
    g_v = rgbg_to_bayer(gv_r, g1_c, gv_b, g2_c)

    # R/B reconstruction: phase-kernel upsample of channel-G difference + G HF
    # re-injection
    delta_gh_hf = g_h - gaussian_blur3(g_h)
    delta_gv_hf = g_v - gaussian_blur3(g_v)

    r_c = r[1:-1, 1:-1]
    b_c = b[1:-1, 1:-1]

    r_h = resample_channel(r_c, gh_r, delta_gh_hf, BayerPatternPosition.TOP_LEFT)
    r_v = resample_channel(r_c, gv_r, delta_gv_hf, BayerPatternPosition.TOP_LEFT)
    b_h = resample_channel(b_c, gh_b, delta_gh_hf, BayerPatternPosition.BOTTOM_RIGHT)
    b_v = resample_channel(b_c, gv_b, delta_gv_hf, BayerPatternPosition.BOTTOM_RIGHT)
    return r_h, g_h, b_h, r_v, g_v, b_v


def ahd_channels(
    bayer: Tensor, mat: Tensor, wb: Tensor, is_hdr: bool,
    postprocess_stages: int = 1, staged: bool = False,
):
    """AHD of a canonical-RGGB mosaic (H, W) to separate (r, g, b) channels.

    ``mat`` is the cam->lin-sRGB matrix and ``wb`` the reciprocal WB gains.
    ``staged``: the homogeneity counts and the chroma-median stages go
    through their kernel wrappers, which launch the CUDA kernels on CUDA
    tensors and run the plain versions on CPU ones."""
    if staged:
        from ..ops.cuda_kernels import postprocess_color_kernel as stage

        count = _homogeneity_kernel_count
    else:
        count, stage = homogeneity_map_channels, postprocess_color_channels
    r_h, g_h, b_h, r_v, g_v, b_v = ahd_candidates(bayer, wb)

    pick = ahd_decision_plain(r_h, g_h, b_h, r_v, g_v, b_v, mat, wb, is_hdr, count)
    inv = 1.0 - pick
    out_r = r_h * pick + r_v * inv
    out_g = g_h * pick + g_v * inv
    out_b = b_h * pick + b_v * inv

    for _ in range(max(int(postprocess_stages), 0)):
        out_r, out_g, out_b = stage(out_r, out_g, out_b)

    return out_r, out_g, out_b


def demosaic_ahd_channels(
    frame: RawFrame, postprocess_stages: int = 1, use_pallas: bool = False
):
    """AHD demosaic of ``frame`` returning separate (r, g, b) channels;
    ``use_pallas`` takes the staged route (:func:`ahd_channels`)."""
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    return ahd_channels(
        frame.bayer, mat, frame.wb_reciprocal(), frame.is_hdr,
        postprocess_stages, staged=use_pallas,
    )


def demosaic_ahd(
    frame: RawFrame, postprocess_stages: int = 1, use_pallas: bool = False
) -> DevelopedImage:
    r, g, b = demosaic_ahd_channels(frame, postprocess_stages, use_pallas)
    return DevelopedImage(
        image=torch.stack([r, g, b], dim=-1).to(torch.float32),
        wb_coeff=frame.wb_reciprocal(),
        cam_mat=frame.cam_mat,
        cam_white=frame.cam_white,
        ev=frame.ev,
        wb_applied=True,
        wb_normalized=False,
    )
