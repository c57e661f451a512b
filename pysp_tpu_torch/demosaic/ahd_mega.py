"""Whole-AHD dispatch: one launch of the CUDA AHD kernel over the frame.

Counterpart of ``pysp_tpu/demosaic/ahd_mega.py``. The JAX module computes the
frame's interior with its kernel and recomputes a border of
``2 * margin_for(stages)`` pixels from four strips, because a halo tile cannot
reproduce border rules that the plain AHD applies to its intermediates. The
port has no strips and no ``margin_for``: the kernel
(``ops.cuda_kernels.ahd_kernel``, ``csrc/ahd.cu``) applies every stage's
border rule itself (symmetric phase planes and CIELAB windows, reflect-101
correlations and box sums, replicate medians), so its output is the whole
frame in its final layout and a develop is one launch. On CPU frames the
wrapper runs the plain version, ``demosaic.ahd.ahd_channels`` and the colour
tail exactly.

Which frames take the kernel is ``demosaic.develop_route``'s decision
(``ops.cuda_kernels.ahd_kernel_admits``); the rest go whole to the staged
route, as in the JAX package.
"""
from __future__ import annotations

from ..core.frame import RawFrame
from ..ops.cuda_kernels import ahd_kernel


def demosaic_ahd_mega(frame: RawFrame, mat, wb, postprocess_stages: int = 1, tail=None):
    """AHD of ``frame`` by one launch of the AHD kernel, with the
    cam->lin-sRGB ``mat`` and the reciprocal WB gains ``wb``: the demosaiced
    (3, H, W) planes, or with ``tail = (clip_highlights, gamma_encode)`` the
    developed (H, W, 3) image after the colour tail."""
    return ahd_kernel(frame.bayer, mat, wb, frame.is_hdr, postprocess_stages, tail=tail)
