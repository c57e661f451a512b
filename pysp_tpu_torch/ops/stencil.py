"""Stencil primitives on tensors: padding, small correlations, blurs, medians.

Counterpart of ``pysp_tpu/ops/stencil.py``. Border semantics match OpenCV:

- ``pad_reflect`` == cv2.BORDER_REFLECT   (edge repeated;  np.pad 'symmetric')
- ``pad_reflect101`` == cv2.BORDER_REFLECT_101 (edge not repeated; np.pad 'reflect')
- ``pad_replicate`` == cv2.BORDER_REPLICATE

Correlations are shift-and-add, never ``conv2d``: cuDNN runs a float32
convolution in TF32 by default, and shift-and-add keeps the JAX package's exact
float32 accumulation order, term by term.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def _expand_pad(pad: int | Sequence[int]) -> tuple[int, int, int, int]:
    if isinstance(pad, int):
        return pad, pad, pad, pad
    pad = tuple(pad)
    if len(pad) == 2:
        return pad[0], pad[0], pad[1], pad[1]
    if len(pad) != 4:
        raise ValueError("pad must be int, (py,px) or (top,bottom,left,right)")
    return pad  # type: ignore[return-value]


def _pad_axis(x: Tensor, before: int, after: int, dim: int, mode: str) -> Tensor:
    n = x.shape[dim]
    shape = tuple(x.shape)
    parts = []
    if before:
        if mode == "symmetric":
            parts.append(x.narrow(dim, 0, before).flip(dim))
        elif mode == "reflect":
            parts.append(x.narrow(dim, 1, before).flip(dim))
        else:
            parts.append(x.narrow(dim, 0, 1).expand(*shape[:dim], before, *shape[dim + 1:]))
    parts.append(x)
    if after:
        if mode == "symmetric":
            parts.append(x.narrow(dim, n - after, after).flip(dim))
        elif mode == "reflect":
            parts.append(x.narrow(dim, n - 1 - after, after).flip(dim))
        else:
            parts.append(x.narrow(dim, n - 1, 1).expand(*shape[:dim], after, *shape[dim + 1:]))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


def _pad(x: Tensor, pad, mode: str) -> Tensor:
    t, b, l, r = _expand_pad(pad)
    return _pad_axis(_pad_axis(x, t, b, x.ndim - 2, mode), l, r, x.ndim - 1, mode)


def pad_reflect(x: Tensor, pad: int | Sequence[int]) -> Tensor:
    """cv2.BORDER_REFLECT on the last two axes."""
    return _pad(x, pad, "symmetric")


def pad_reflect101(x: Tensor, pad: int | Sequence[int]) -> Tensor:
    """cv2.BORDER_REFLECT_101 on the last two axes."""
    return _pad(x, pad, "reflect")


def pad_replicate(x: Tensor, pad: int | Sequence[int]) -> Tensor:
    """cv2.BORDER_REPLICATE on the last two axes."""
    return _pad(x, pad, "edge")


def _conv_valid(x: Tensor, kernel) -> Tensor:
    """VALID cross-correlation on the last two axes as shift-and-add, skipping
    zero taps, accumulated in row-major tap order."""
    k_host = np.asarray(kernel, np.float64)
    kh, kw = k_host.shape
    h = x.shape[-2] - kh + 1
    w = x.shape[-1] - kw + 1

    out = None
    for dy in range(kh):
        for dx in range(kw):
            coeff = float(k_host[dy, dx])
            if coeff == 0.0:
                continue
            term = x[..., dy : dy + h, dx : dx + w] * coeff
            out = term if out is None else out + term
    if out is None:
        return x.new_zeros(x.shape[:-2] + (h, w))
    return out


def filter2d(x: Tensor, kernel, border: str = "reflect101") -> Tensor:
    """cv2.filter2D equivalent: same-size cross-correlation, center anchor,
    on the last two axes of ``x``."""
    kh, kw = np.shape(kernel)
    pt, pb = kh // 2, (kh - 1) // 2
    pl, pr = kw // 2, (kw - 1) // 2
    pad_fn = {
        "reflect101": pad_reflect101, "reflect": pad_reflect, "replicate": pad_replicate
    }[border]
    return _conv_valid(pad_fn(x, (pt, pb, pl, pr)), kernel)


def filter2d_hwc(x: Tensor, kernel, border: str = "reflect101") -> Tensor:
    """filter2d for channel-last images (H, W, C) or single-channel (H, W)."""
    if x.ndim == 2:
        return filter2d(x, kernel, border)
    return filter2d(x.movedim(-1, 0), kernel, border).movedim(0, -1)


def box_blur3(x: Tensor) -> Tensor:
    """cv2.blur(src, (3,3)) equivalent (normalized box, reflect101 border)."""
    return filter2d(x, np.full((3, 3), 1.0 / 9.0, np.float32))


def box_sum3(x: Tensor) -> Tensor:
    """Unnormalized 3x3 box sum (reflect101 border). On integer-valued inputs
    (the AHD homogeneity counts) every sum is exact."""
    xp = pad_reflect101(x, 1)
    h, w = x.shape[-2], x.shape[-1]
    out = None
    for dy in range(3):
        for dx in range(3):
            term = xp[..., dy : dy + h, dx : dx + w]
            out = term if out is None else out + term
    return out


# cv2.getGaussianKernel(3, 1.0): exp(-x^2/2) at {-1,0,1}, normalized.
_G3 = np.exp(-0.5 * np.array([1.0, 0.0, 1.0]))
_G3 = _G3 / _G3.sum()
GAUSSIAN3_SIGMA1 = np.outer(_G3, _G3).astype(np.float32)


def gaussian_blur3(x: Tensor) -> Tensor:
    """cv2.GaussianBlur(src, (3,3), 1.0) equivalent (reflect101 border)."""
    return filter2d(x, GAUSSIAN3_SIGMA1)


# --- Shared-column 5x5 median -------------------------------------------------
#
# Sort each 5-column once (shared by the 5 windows it intersects), merge adjacent
# sorted-column pairs (10-sorted, shared by 3 windows), merge pairs-of-pairs
# (20-sorted, pruned to ranks 7..12), and finish with the two-sorted-list
# selection identity rank_k(A u B) = max_i(min(A[i], B[k-i])): 86 min/max ops per
# pixel. Medians are selections, so any correct network returns identical values.

_SORT5_CE = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))


def sort5(vals: list) -> list:
    """Elementwise 5-way sort of equal-shape tensors (optimal 9-comparator network)."""
    vals = list(vals)
    if len(vals) != 5:
        raise ValueError("sort5 takes exactly 5 tensors")
    for i, j in _SORT5_CE:
        lo = torch.minimum(vals[i], vals[j])
        hi = torch.maximum(vals[i], vals[j])
        vals[i], vals[j] = lo, hi
    return vals


def _oddeven_merge_wires(a: tuple, b: tuple, out: list) -> tuple:
    """Batcher odd-even merge of sorted wire runs (arbitrary lengths); appends
    compare-exchange pairs to ``out`` and returns wires in sorted order."""
    if not a:
        return b
    if not b:
        return a
    if len(a) == 1 and len(b) == 1:
        out.append((a[0], b[0]))
        return (a[0], b[0])
    e = _oddeven_merge_wires(a[0::2], b[0::2], out)
    o = _oddeven_merge_wires(a[1::2], b[1::2], out)
    res = [e[0]]
    oi, ei = 0, 1
    while oi < len(o) and ei < len(e):
        out.append((o[oi], e[ei]))
        res.append(o[oi])
        res.append(e[ei])
        oi += 1
        ei += 1
    res.extend(o[oi:])
    res.extend(e[ei:])
    return tuple(res)


@lru_cache(maxsize=None)
def _merge_net(m: int, n: int, ranks: frozenset | None = None):
    """Typed-op merge network for sorted runs [0..m) + [m..m+n), backward-pruned to
    the given output ranks (all ranks if None). Returns (ops, order)."""
    ce: list = []
    order = _oddeven_merge_wires(tuple(range(m)), tuple(range(m, m + n)), ce)
    if ranks is None:
        return tuple(("cmp", i, j) for i, j in ce), order
    needed = {order[r] for r in ranks}
    kept = []
    for (i, j) in reversed(ce):
        nm, nM = i in needed, j in needed
        if not (nm or nM):
            continue
        kept.append(("cmp" if (nm and nM) else ("min" if nm else "max"), i, j))
        needed.add(i)
        needed.add(j)
    kept.reverse()
    return tuple(kept), order


def merge_sorted(a: list, b: list, ranks=None):
    """Elementwise merge of two sorted lists of tensors. Returns the m+n sorted
    fields, or a {rank: field} dict restricted to ``ranks``."""
    rk = frozenset(ranks) if ranks is not None else None
    ops, order = _merge_net(len(a), len(b), rk)
    wires = list(a) + list(b)
    for kind, i, j in ops:
        if kind == "cmp":
            lo = torch.minimum(wires[i], wires[j])
            hi = torch.maximum(wires[i], wires[j])
            wires[i], wires[j] = lo, hi
        elif kind == "min":
            wires[i] = torch.minimum(wires[i], wires[j])
        else:
            wires[j] = torch.maximum(wires[i], wires[j])
    if rk is None:
        return [wires[w] for w in order]
    return {r: wires[order[r]] for r in rk}


_Q_RANKS = frozenset(range(7, 13))  # sorted-20 ranks that can reach overall rank 12


def median25_select(q: dict, side: list) -> Tensor:
    """Overall median (rank 12 of 25) from a sorted-20 dict (ranks 7..12) and one
    sorted column of 5, via the two-sorted-list selection identity."""
    t = q[7]
    for k in range(5):
        t = torch.maximum(t, torch.minimum(q[8 + k], side[4 - k]))
    return t


def median5_from_padded(xp: Tensor, h: int, w: int) -> Tensor:
    """5x5 median field for output rows/cols [0,h)x[0,w) of ``xp``, which must carry
    a 2-pixel halo on every side."""
    s_cols = sort5([xp[..., dy : dy + h, : w + 4] for dy in range(5)])
    pairs = merge_sorted(
        [s[..., :, : w + 3] for s in s_cols], [s[..., :, 1 : w + 4] for s in s_cols]
    )
    q = merge_sorted(
        [p[..., :, :w] for p in pairs],
        [p[..., :, 2 : 2 + w] for p in pairs],
        ranks=_Q_RANKS,
    )
    side = [s[..., :, 4 : 4 + w] for s in s_cols]
    return median25_select(q, side)


def median5(x: Tensor) -> Tensor:
    """cv2.medianBlur(src, 5) equivalent for float32 (replicate border)."""
    h, w = x.shape[-2], x.shape[-1]
    return median5_from_padded(pad_replicate(x, 2), h, w)


# Paeth's 19-comparator network for the median of nine (Graphics Gems,
# "Median finding on a 3x3 grid"): a selection, so the value is the one any
# exact median network returns.
_MEDIAN9_CE = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
               (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
               (4, 2))


def median3(x: Tensor) -> Tensor:
    """cv2.medianBlur(src, 3) equivalent for float32 (replicate border)."""
    xp = pad_replicate(x, 1)
    h, w = x.shape[-2], x.shape[-1]
    p = [xp[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    for i, j in _MEDIAN9_CE:
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[4]


def median2(x: Tensor) -> Tensor:
    """The reference's 2x2 median: the mean of the two middle values of {self,
    E, S, SE} with a reflect101 border. The middle pair comes from a 6-op
    min/max network, bit-identical to sorting's."""
    xp = pad_reflect101(x, 1)
    h, w = x.shape[-2], x.shape[-1]
    a = xp[..., 1 : 1 + h, 1 : 1 + w]
    b = xp[..., 1 : 1 + h, 2 : 2 + w]
    c = xp[..., 2 : 2 + h, 1 : 1 + w]
    d = xp[..., 2 : 2 + h, 2 : 2 + w]
    lo_ab, hi_ab = torch.minimum(a, b), torch.maximum(a, b)
    lo_cd, hi_cd = torch.minimum(c, d), torch.maximum(c, d)
    return (torch.maximum(lo_ab, lo_cd) + torch.minimum(hi_ab, hi_cd)) * 0.5


def shift2d(x: Tensor, dy: int, dx: int, pad_fn=pad_reflect) -> Tensor:
    """``x`` sampled at (y + dy, x + dx) with the given border handling."""
    py, px = abs(dy), abs(dx)
    if py == 0 and px == 0:
        return x
    xp = pad_fn(x, (py, py, px, px))
    h, w = x.shape[-2], x.shape[-1]
    return xp[..., py + dy : py + dy + h, px + dx : px + dx + w]


def upsample2x_bilinear_cv2(x: Tensor) -> Tensor:
    """cv2.resize(src, (2W, 2H), INTER_LINEAR) equivalent for an (H, W) plane
    or an (..., H, W, C) image.

    Half-pixel-centre bilinear 2x upsample reduces to a fixed 2-tap stencil per
    output parity: even outputs = 0.75*p[i] + 0.25*p[i-1], odd = 0.75*p[i] +
    0.25*p[i+1] (edges replicate). Used by the Draft demosaic."""

    def up_axis(v: Tensor, axis: int) -> Tensor:
        v = v.movedim(axis, -1)
        n = v.shape[-1]
        vp = torch.cat([v[..., :1], v, v[..., -1:]], dim=-1)
        prev_ = vp[..., 0:n]
        cur = vp[..., 1 : n + 1]
        nxt = vp[..., 2 : n + 2]
        even = 0.75 * cur + 0.25 * prev_
        odd = 0.75 * cur + 0.25 * nxt
        out = torch.stack([even, odd], dim=-1).reshape(*v.shape[:-1], 2 * n)
        return out.movedim(-1, axis)

    if x.ndim == 2:
        return up_axis(up_axis(x, 0), 1)
    return up_axis(up_axis(x, -3), -2)
