"""Draft demosaic: quarter-res resolve + bilinear 2x upsample.

Counterpart of ``pysp_tpu/demosaic/draft.py``. G is the mean of both green
photosites; R and B are re-centred at pixel centres by blending 25% of the
diagonal neighbour; the quarter-res RGB is then bilinearly resized to sensor
resolution (cv2.resize INTER_LINEAR semantics). Plain PyTorch on every device:
the JAX package has no kernel for this tier either.
"""
from __future__ import annotations

import torch

from ..core.bayer import bayer_to_rgbg
from ..core.frame import DevelopedImage, RawFrame
from ..ops.stencil import pad_reflect, pad_replicate, upsample2x_bilinear_cv2

Tensor = torch.Tensor


def _quarter_res_channels(frame: RawFrame, wb: Tensor):
    """(r, g, b) at quarter resolution, the reciprocal WB gains ``wb``
    applied, R and B re-centred."""
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)

    g = (g1 + g2) * 0.5 * wb[1]

    # R sits at the quad's top-left: nudge toward the bottom-right diagonal
    # (reflect border).
    rp = pad_reflect(r, (0, 1, 0, 1))
    r_center = 0.75 * rp[:-1, :-1] + 0.25 * rp[1:, 1:]

    # B sits at the bottom-right: nudge toward the top-left diagonal.
    bp = pad_reflect(b, (1, 0, 1, 0))
    b_center = 0.75 * bp[1:, 1:] + 0.25 * bp[:-1, :-1]

    return r_center * wb[0], g, b_center * wb[2]


def demosaic_draft_channels(frame: RawFrame, wb: Tensor):
    """Draft demosaic with the reciprocal WB gains ``wb``, returning separate
    (r, g, b) channels."""
    r, g, b = _quarter_res_channels(frame, wb)
    return (
        upsample2x_bilinear_cv2(r),
        upsample2x_bilinear_cv2(g),
        upsample2x_bilinear_cv2(b),
    )


def draft_phases(frame: RawFrame, wb: Tensor):
    """The fused Draft develop's (r, g, b) quads: the four 2x-bilinear output
    phases of each channel as 4-tap stencils at quarter resolution, with the
    reciprocal WB gains ``wb``."""
    r_c, g, b_c = _quarter_res_channels(frame, wb)

    def up_phases(p):
        pp = pad_replicate(p, 1)
        c = pp[1:-1, 1:-1]
        up_ = pp[:-2, 1:-1]
        dn = pp[2:, 1:-1]
        lf = pp[1:-1, :-2]
        rt = pp[1:-1, 2:]
        ul = pp[:-2, :-2]
        ur = pp[:-2, 2:]
        dl = pp[2:, :-2]
        dr = pp[2:, 2:]
        p00 = 0.5625 * c + 0.1875 * up_ + 0.1875 * lf + 0.0625 * ul
        p01 = 0.5625 * c + 0.1875 * up_ + 0.1875 * rt + 0.0625 * ur
        p10 = 0.5625 * c + 0.1875 * dn + 0.1875 * lf + 0.0625 * dl
        p11 = 0.5625 * c + 0.1875 * dn + 0.1875 * rt + 0.0625 * dr
        return ((p00, p01), (p10, p11))

    return up_phases(r_c), up_phases(g), up_phases(b_c)


def develop_channels_draft(
    frame: RawFrame, mat: Tensor, wb: Tensor, clip_highlights: bool, gamma_encode: bool,
):
    """Fused Draft develop: polyphase upsample + colour tail at quarter res,
    with the cam->lin-sRGB ``mat`` and the reciprocal WB gains ``wb``.

    The (pointwise) colour tail runs on :func:`draft_phases`, and the
    full-res image is assembled once per channel: the same taps as
    :func:`demosaic_draft_channels` plus the tail, in one other association
    order (about 1 ulp). Returns colour-tailed (r, g, b) full-res channels."""
    from ..ops.polyphase import color_tail_quads

    return color_tail_quads(draft_phases(frame, wb), mat, clip_highlights, gamma_encode)


def demosaic_draft(frame: RawFrame) -> DevelopedImage:
    wb = frame.wb_reciprocal()
    r, g, b = demosaic_draft_channels(frame, wb)
    return DevelopedImage(
        image=torch.stack([r, g, b], dim=-1).to(torch.float32),
        wb_coeff=wb,
        cam_mat=frame.cam_mat,
        cam_white=frame.cam_white,
        ev=frame.ev,
        wb_applied=True,
        wb_normalized=False,
    )
