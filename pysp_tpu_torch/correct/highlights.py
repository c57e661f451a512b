"""Highlight reconstruction: rebuild clipped channels from unclipped ones.

Counterpart of ``pysp_tpu/correct/highlights.py``, plain PyTorch as the JAX
package's is plain XLA (it has no kernel). The method (the JAX module's own
design, documented in DIVERGENCES.md):

1. Work on the WB-applied camera-space channels the demosaic emits. Channel
   ``c`` clips at ``L_c = wb_gain_c * lim_sat`` there.
2. Per channel, compute the chroma ratio ``rho_c = v_c / I`` against the
   all-unclipped intensity ``I = mean_c(v_c / L_c)``, valid only where no
   channel clips, and propagate it into the clipped region with a valid-aware
   pyramid fill plus a few harmonic smoothing sweeps.
3. Re-estimate the intensity inside the clipped region from the channels
   still unclipped there: ``I_est = mean_u(v_u / rho_u)``; a fully clipped
   pixel takes the lower bound ``max_c(v_c / rho_c)``.
4. ``v'_c = max(v_c, rho_c * I_est)`` inside the clipped mask only; unclipped
   pixels are bit-untouched.

The output exceeds the clip levels; ``develop`` compresses it back below 1.0
with a soft knee (:func:`compress_highlights`) before gamma when
``DevelopConfig.highlights == "reconstruct"``.

The channels may be strided views (the AHD kernel's planes are): everything
here is shifts, pads, reshapes of copies and elementwise arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..colorimetry.transforms import div_const
from ..ops.stencil import pad_replicate, shift2d

Tensor = torch.Tensor


def _down2(x: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """Valid-aware 2x2 reduction: normalized sum of valid samples per quad,
    summed in row-major order within the quad."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        x = pad_replicate(x, (0, h % 2, 0, w % 2))
        v = pad_replicate(v, (0, h % 2, 0, w % 2))

    def quad_sum(t):
        return (t[..., 0::2, 0::2] + t[..., 0::2, 1::2]) + t[..., 1::2, 0::2] + t[..., 1::2, 1::2]

    xs, vs = quad_sum(x), quad_sum(v)
    return xs / torch.clamp(vs, min=1.0), torch.clamp(vs, max=1.0)


def _up2(x: Tensor, h: int, w: int) -> Tensor:
    """Nearest 2x upsample cropped to (h, w) — a fill seed, smoothing follows."""
    up = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up[..., :h, :w]


def masked_fill_pyramid(
    x: Tensor, valid: Tensor, levels: int = 6, smooth_iterations: int = 2
) -> Tensor:
    """Fill invalid pixels from valid ones at the nearest available scale.

    Valid data is untouched; invalid pixels get the normalized mean of the
    nearest valid content at the finest scale that has any (the global valid
    mean where no level has any), then ``smooth_iterations`` harmonic sweeps
    with a replicate border relax the seams. The levels halve the shape (odd
    sides padded by replication) until ``levels`` or a side of 1.
    """
    v = valid.to(x.dtype)
    x0 = x * v

    stack = [(x0, v)]
    for _ in range(levels):
        if min(stack[-1][0].shape[-2:]) <= 1:
            break
        stack.append(_down2(*stack[-1]))

    # coarsest: anything still invalid falls back to the global valid mean
    xc, vc = stack[-1]
    gmean = x0.sum(dim=(-2, -1), keepdim=True) / torch.clamp(
        v.sum(dim=(-2, -1), keepdim=True), min=1.0
    )
    filled = torch.where(vc > 0, xc, gmean)

    # composite back up: valid data wins, holes take the coarser fill
    for xf, vf in reversed(stack[:-1]):
        h, w = xf.shape[-2], xf.shape[-1]
        filled = torch.where(vf > 0, xf, _up2(filled, h, w))

    for _ in range(smooth_iterations):
        acc = (
            shift2d(filled, -1, 0, pad_replicate)
            + shift2d(filled, 1, 0, pad_replicate)
            + shift2d(filled, 0, -1, pad_replicate)
            + shift2d(filled, 0, 1, pad_replicate)
        ) * 0.25
        filled = torch.where(valid, filled, acc)
    return filled


def reconstruct_highlights_channels(
    r: Tensor,
    g: Tensor,
    b: Tensor,
    wb_gains: Tensor,
    lim_sat: Tensor,
    threshold: float = 0.95,
    levels: int = 6,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Reconstruct clipped channels of WB-applied camera RGB (see module doc).

    ``wb_gains`` are the reciprocal WB multipliers (1/neutral) that the
    demosaic pre-applied; ``lim_sat`` is the frame's saturation ceiling (1.0
    for single exposures, >1 for HDR stacks).
    """
    eps = 1e-6
    vals = [r, g, b]
    gains = [wb_gains[i].to(r.dtype) for i in range(3)]
    limits = [gains[i] * lim_sat for i in range(3)]
    clipped = [vals[i] >= threshold * limits[i] for i in range(3)]
    none_clipped = torch.logical_not(clipped[0] | clipped[1] | clipped[2])

    # all-unclipped intensity (clip-level-normalized so channels are comparable)
    intensity = (
        vals[0] / limits[0] + vals[1] / limits[1] + vals[2] / limits[2]
    ) * (1.0 / 3.0)

    rhos = []
    for i in range(3):
        rho = vals[i] / torch.clamp(intensity, min=eps)
        rhos.append(masked_fill_pyramid(rho, none_clipped, levels=levels))

    # intensity witnesses: unclipped channels back-project through their ratio
    est_num = torch.zeros_like(intensity)
    est_den = torch.zeros_like(intensity)
    lower_bound = torch.zeros_like(intensity)
    for i in range(3):
        witness = torch.logical_not(clipped[i]).to(r.dtype)
        proj = vals[i] / torch.clamp(rhos[i], min=eps)
        est_num = est_num + witness * proj
        est_den = est_den + witness
        lower_bound = torch.maximum(lower_bound, proj)

    i_est = torch.where(est_den > 0, est_num / torch.clamp(est_den, min=1.0), lower_bound)

    out = []
    for i in range(3):
        rec = torch.maximum(vals[i], rhos[i] * i_est)
        out.append(torch.where(clipped[i], rec, vals[i]))
    return out[0], out[1], out[2]


def compress_highlights(x: Tensor, knee: float = 0.85) -> Tensor:
    """Soft-knee compression of super-white linear values into [0, 1].

    Identity below ``knee``; above it an exponential shoulder asymptotes to 1,
    C1-continuous at the knee.
    """
    span = 1.0 - knee
    shoulder = knee + span * (1.0 - torch.exp(div_const(-(x - knee), span)))
    return torch.where(x <= knee, x, shoulder)
