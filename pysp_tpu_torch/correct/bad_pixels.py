"""Bad-pixel detection and repair on Bayer planes.

Counterpart of ``pysp_tpu/correct/bad_pixels.py``: threshold detection against
the 8 neighbours, median-delta detection with a quantile threshold, burst
consensus, and repair by a masked normalized-convolution fill per CFA plane.

Under a row-sharded mesh (``parallel/``) the median detector takes the JAX
function's ``axis_name`` / ``core_rows``: its statistics are the whole
frame's, reduced over the shards. The heal stays local to the shard, as in
the JAX package. The compacted sparse fill (``compact_mask_indices``,
``masked_fill_inpaint_sparse``) works around the TPU's scatter cost, is
bit-identical to the dense fill, and is not carried.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..colorimetry.transforms import div_const
from ..core.bayer import bayer_to_planes, planes_to_bayer
from ..core.frame import RawFrame
from ..ops.stencil import median2, pad_reflect101, pad_replicate, shift2d

Tensor = torch.Tensor

_NEIGHBORS_8 = [
    (-1, 0), (0, 1), (1, 0), (0, -1),
    (-1, -1), (-1, 1), (1, 1), (1, -1),
]


def find_erroneous_pixels_threshold(
    frame: RawFrame, min_delta: float = 0.025, min_neighbour_count: int = 5
) -> Tensor:
    """Hot-pixel masks per plane: pixel > (neighbour + min_delta) for more than
    ``min_neighbour_count`` of its 8 neighbours.

    Returns (4, H/2, W/2) bool in (R, G1, B, G2) order."""
    planes = bayer_to_planes(frame.bayer)
    h, w = planes.shape[-2], planes.shape[-1]
    padded = pad_reflect101(planes, 1)
    lifted = planes - min_delta
    count = torch.zeros_like(planes, dtype=torch.int32)
    for dy, dx in _NEIGHBORS_8:
        neigh = padded[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        count = count + (lifted > neigh).to(torch.int32)
    return count > min_neighbour_count


def find_erroneous_pixels_median(
    frame: RawFrame,
    multiplier: float = 1.5,
    quantile: float = 0.9999,
    axis_name=None,
    core_rows=None,
) -> Tensor:
    """Hot-pixel masks from the delta against a 2x2 median, noise floor
    subtracted, thresholded at ``multiplier`` times the per-plane
    ``quantile`` of the delta (the upper order statistic, see
    :func:`_bisect_quantile`). Returns (4, H/2, W/2) bool.

    On a halo-extended row shard (``parallel/``): ``core_rows`` (mosaic rows
    [lo, hi)) restricts the noise floor and the quantile to the shard's own
    rows, and ``axis_name`` reduces them over the shards (the floor by
    ``pmean``, the quantile's counts by ``psum``), so the threshold is the
    whole frame's; the masks cover the whole extended block."""
    planes = bayer_to_planes(frame.bayer)
    delta = torch.abs(planes - median2(planes))

    def core(x):
        return x if core_rows is None else x[..., core_rows[0] // 2 : core_rows[1] // 2, :]

    noise_floor = core(delta).mean(dim=(-2, -1), keepdim=True)
    if axis_name is not None:
        from ..parallel.shard import pmean

        # equal-size shards: the frame's mean is the mean of the shards' means
        noise_floor = pmean(noise_floor, axis_name)
    delta = torch.abs(delta - noise_floor)
    strong = _bisect_quantile(core(delta), quantile, axis_name=axis_name).reshape(4, 1, 1)
    return delta > strong * multiplier


def _bisect_quantile(delta: Tensor, q: float, iters: int = 4, branches: int = 16,
                     axis_name=None) -> Tensor:
    """Per-plane upper-order-statistic quantile of ``delta`` (P, H, W) by count
    multisection: each of ``iters`` passes splits the bracket at ``branches``
    interior points, counts the samples at or below each, and narrows the
    bracket to the first point that reaches rank ``q * (n - 1)``. Not
    ``torch.quantile``, which interpolates between order statistics.

    With ``axis_name`` the bracket's ends are ``pmin`` / ``pmax``ed and the
    counts ``psum``med over the shards, so row shards of one frame find the
    frame's quantile exactly: counting rank is associative. The counts are
    summed as integers and rounded to float32 once, as the whole frame's
    count is: above 2**24 samples a plane (67 MP frames) a float32 sum of the
    shards' counts would round differently from it."""
    n = delta.shape[-2] * delta.shape[-1]
    lo = delta.amin(dim=(-2, -1))
    hi = delta.amax(dim=(-2, -1))
    if axis_name is not None:
        from ..parallel.shard import pmax, pmin, psum

        n = n * psum(1, axis_name)
        lo, hi = pmin(lo, axis_name), pmax(hi, axis_name)
    # float32 comparisons throughout, as in the JAX package: the counts are
    # exact integers below 2**24 and the target is rounded to float32. The
    # constants are filled on the device (no host copy, no synchronisation).
    target = torch.full((), float(np.float32(q * (n - 1))), device=delta.device)
    fr = div_const(torch.arange(1, branches + 1, dtype=delta.dtype, device=delta.device),
                   branches + 1)
    for _ in range(iters):
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]          # (P, B)
        # the rank of every mid in one pass over delta: (P, B, H, W) compares
        cnt = (delta[:, None] <= mids[:, :, None, None]).sum(dim=(-2, -1))
        if axis_name is not None:
            cnt = psum(cnt, axis_name)
        ok = (cnt.to(torch.float32) - 1.0) >= target
        hi = torch.where(ok, mids, hi[:, None]).amin(dim=1)
        lo = torch.where(ok, lo[:, None], mids).amax(dim=1)
    return hi


def find_shared_pixels(masks: Sequence[Tensor], min_ratio: float = 0.1) -> Optional[Tensor]:
    """Consensus mask: pixels flagged in at least ceil(N * min_ratio) of the N
    (4, H/2, W/2) masks; None for no masks or masks of different shapes."""
    if len(masks) == 0:
        return None
    if len({tuple(m.shape) for m in masks}) != 1:
        return None
    # ceil of the float32 ratio, as jnp.ceil takes it
    min_acceptance = float(np.ceil(np.float32(len(masks) * min_ratio)))
    total = sum(m.to(torch.int16) for m in masks)
    return total >= min_acceptance


def _nb_sum(x: Tensor) -> Tensor:
    """((up + down) + left) + right, replicate border."""
    return (
        shift2d(x, -1, 0, pad_replicate)
        + shift2d(x, 1, 0, pad_replicate)
        + shift2d(x, 0, -1, pad_replicate)
        + shift2d(x, 0, 1, pad_replicate)
    )


def diffusion_inpaint(chan: Tensor, mask: Tensor, iterations: int = 32) -> Tensor:
    """Fill masked pixels by Jacobi diffusion from their 4-neighbourhood,
    starting from the plane mean."""
    mask_f = mask.to(chan.dtype)
    seed = chan.mean(dim=(-2, -1), keepdim=True)
    x = chan * (1 - mask_f) + seed * mask_f
    for _ in range(iterations):
        x = torch.where(mask, _nb_sum(x) * 0.25, chan)
    return x


def masked_fill_inpaint(
    chan: Tensor, mask: Tensor, fill_iterations: int = 4, smooth_iterations: int = 2
) -> Tensor:
    """Mask-aware inpaint: normalized-convolution fill and a short harmonic
    smoothing, on (..., H, W) planes with a replicate border.

    Each fill sweep extends the valid front by one pixel (clusters up to radius
    ``fill_iterations`` fill); sites still unreached take their plane's mean;
    the smoothing sweeps then relax the masked sites toward the harmonic fill.
    The plain version of the heal kernel (``ops.cuda_kernels.heal_kernel``)."""
    v = torch.logical_not(mask).to(chan.dtype)
    x = chan * v
    for _ in range(fill_iterations):
        xs = _nb_sum(x)
        vs = _nb_sum(v)
        filled = xs / torch.clamp(vs, min=1.0)
        x = torch.where(v > 0, x, filled)
        v = torch.clamp(v + vs, max=1.0)
    seed = chan.mean(dim=(-2, -1), keepdim=True)
    x = torch.where(v > 0, x, seed)
    for _ in range(smooth_iterations):
        x = torch.where(mask, _nb_sum(x) * 0.25, chan)
    return torch.where(mask, x, chan)


def repair_bad_pixels(frame: RawFrame, masks, iterations: int = 4) -> RawFrame:
    """Heal the masked photosites per plane; returns a new frame.
    ``iterations`` bounds the fillable cluster radius.

    On CUDA planes the heal kernel runs every sweep in one launch, where its
    gate (:func:`ops.cuda_kernels.heal_kernel_admits`) takes the sweep counts;
    on CPU planes, and outside the gate on either device, the dense
    :func:`masked_fill_inpaint` runs. Both give the same bits."""
    from ..ops import cuda_kernels as K

    masks = torch.as_tensor(masks, device=frame.bayer.device).to(torch.bool)
    if masks.shape[0] != 4:
        return frame
    planes = bayer_to_planes(frame.bayer)
    if planes.ndim == 3 and K.heal_kernel_admits(iterations, 2):
        healed = K.heal_kernel(planes, masks, iterations, 2)
    else:
        healed = masked_fill_inpaint(planes, masks, fill_iterations=iterations)
    return frame.replace(bayer=planes_to_bayer(healed))
