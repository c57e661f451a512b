"""Flat-field (shading) correction and dark / bias frame subtraction.

Counterpart of ``pysp_tpu/correct/flat_field.py``: per CFA plane,
``chan * mean(flat_chan) / flat_chan``, infinities replaced with the plane's
largest finite value, negatives clamped to 0, optionally clamped at 1. On a
row shard of a mesh (``parallel/``) the per-plane statistics are the whole
flat's, reduced over the shards (``axis_name`` / ``core_rows``, as in the
JAX function).
"""
from __future__ import annotations

import torch

from ..core.frame import RawFrame

Tensor = torch.Tensor

_PHASES = (-4, -2)   # the row and column axes of the (h2, 2, w2, 2) view


def _phase_view(x: Tensor) -> Tensor:
    """(..., H, W) as (..., H/2, 2, W/2, 2): axes -3 and -1 index the CFA phase,
    so a reduction over ``_PHASES`` gives one value per phase that broadcasts
    back over the view."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    return x.reshape(*x.shape[:-2], h2, 2, w2, 2)


def flat_frame_correction(
    frame: RawFrame,
    flat: RawFrame,
    clamp_high: bool = False,
    axis_name=None,
    core_rows=None,
) -> RawFrame:
    """Per-plane flat division; returns the corrected frame.

    Each photosite divides by its own flat value and scales by its CFA
    plane's flat mean. An all-positive flat takes the short branch (the
    division is finite everywhere); otherwise non-finite results take the
    plane's largest finite value and a plane with no finite value is left as
    it was, as in the JAX package's ``lax.cond`` branches.

    On a halo-extended row shard: ``core_rows`` (mosaic rows [lo, hi))
    keeps the exchanged halo rows out of the per-plane statistics, and
    ``axis_name`` reduces them over the shards (mean by ``pmean``, largest
    finite value and "any finite" by ``pmax``), so the scale is the whole
    flat's; the branch is taken on every shard alike (``pmin`` of "all
    positive")."""

    from ..parallel import shard

    def per_phase(x: Tensor, reduce, collective: str) -> Tensor:
        """``reduce`` of the core rows' CFA phases, then ``shard.<collective>``
        over the shards."""
        if core_rows is not None:
            x = x[..., core_rows[0] : core_rows[1], :]
        v = reduce(_phase_view(x))
        return v if axis_name is None else getattr(shard, collective)(v, axis_name)

    bayer, flat_b = _phase_view(frame.bayer), _phase_view(flat.bayer)
    mean = per_phase(flat.bayer, lambda q: q.mean(dim=_PHASES, keepdim=True), "pmean")
    out = bayer * mean / flat_b
    all_pos = bool((flat_b > 0).all())
    if axis_name is not None:
        all_pos = shard.pmin(all_pos, axis_name)
    if all_pos:
        out = torch.clamp(out, min=0.0)
        if clamp_high:
            out = torch.clamp(out, max=1.0)
        return frame.replace(bayer=out.reshape(frame.bayer.shape))

    finite = torch.isfinite(out)
    neg_inf = torch.where(finite, out, torch.full_like(out, float("-inf")))
    max_map = per_phase(neg_inf.reshape(frame.bayer.shape),
                        lambda q: q.amax(dim=_PHASES, keepdim=True), "pmax")
    any_map = per_phase(finite.reshape(frame.bayer.shape),
                        lambda q: q.sum(dim=_PHASES, keepdim=True) > 0, "pmax")
    out = torch.clamp(torch.where(finite, out, max_map), min=0.0)
    if clamp_high:
        out = torch.clamp(out, max=1.0)
    out = torch.where(any_map.to(torch.bool), out, bayer)
    return frame.replace(bayer=out.reshape(frame.bayer.shape))


def dark_frame_subtraction(frame: RawFrame, dark: RawFrame) -> RawFrame:
    """Remove dark-current noise: the dark frame subtracted, clamped at 0."""
    return frame.replace(bayer=torch.clamp(frame.bayer - dark.bayer, min=0.0))


def bias_frame_subtraction(frame: RawFrame, bias: RawFrame) -> RawFrame:
    """Remove fixed-pattern read noise: the bias frame subtracted, clamped at 0."""
    return frame.replace(bayer=torch.clamp(frame.bayer - bias.bayer, min=0.0))
