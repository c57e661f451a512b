"""The three demosaics in plain PyTorch: Best (AHD: directional greens, R
and B by phase-kernel upsampling with green high frequencies, CIELAB
homogeneity counts, box-summed pick, chroma-median stages), Fast
(edge-assisted Gaussian) and Draft (quarter-resolution resolve and a 2x
bilinear upsample). A frozen copy of the port's plain versions, in the
straight full-resolution form: no phase-plane fusion. Everything runs in
the dtype of the mosaic given.
"""
from __future__ import annotations

import numpy as np
import torch

from .colour import rgb_to_lab

Tensor = torch.Tensor


# --- borders and stencils (OpenCV's border rules) -----------------------------

def _pad_axis(x: Tensor, before: int, after: int, dim: int, mode: str) -> Tensor:
    n = x.shape[dim]
    parts = []
    if before:
        parts.append({"symmetric": lambda: x.narrow(dim, 0, before).flip(dim),
                      "reflect": lambda: x.narrow(dim, 1, before).flip(dim),
                      "edge": lambda: x.narrow(dim, 0, 1).repeat_interleave(before, dim)}[mode]())
    parts.append(x)
    if after:
        parts.append({"symmetric": lambda: x.narrow(dim, n - after, after).flip(dim),
                      "reflect": lambda: x.narrow(dim, n - 1 - after, after).flip(dim),
                      "edge": lambda: x.narrow(dim, n - 1, 1).repeat_interleave(after, dim)}[mode]())
    return torch.cat(parts, dim=dim)


def pad(x: Tensor, t: int, b: int, l: int, r: int, mode: str) -> Tensor:
    """``symmetric`` = BORDER_REFLECT, ``reflect`` = BORDER_REFLECT_101,
    ``edge`` = BORDER_REPLICATE, on the last two axes."""
    return _pad_axis(_pad_axis(x, t, b, x.ndim - 2, mode), l, r, x.ndim - 1, mode)


def correlate(x: Tensor, kernel, mode: str = "reflect") -> Tensor:
    """Same-size cross-correlation (centre anchor), shift and add over the
    non-zero taps in row-major order."""
    k = np.asarray(kernel, np.float64)
    kh, kw = k.shape
    xp = pad(x, kh // 2, (kh - 1) // 2, kw // 2, (kw - 1) // 2, mode)
    h, w = x.shape[-2:]
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if k[dy, dx] != 0.0:
                term = xp[..., dy:dy + h, dx:dx + w] * float(k[dy, dx])
                out = term if out is None else out + term
    return out


def box_sum3(x: Tensor) -> Tensor:
    xp = pad(x, 1, 1, 1, 1, "reflect")
    h, w = x.shape[-2:]
    out = None
    for dy in range(3):
        for dx in range(3):
            out = xp[..., dy:dy + h, dx:dx + w] if out is None else out + xp[..., dy:dy + h, dx:dx + w]
    return out


_G3 = np.exp(-0.5 * np.array([1.0, 0.0, 1.0]))
_G3 = _G3 / _G3.sum()
GAUSS3 = np.outer(_G3, _G3).astype(np.float32)


# The 5x5 median as min/max networks with shared columns: each 5-column
# sorted once, adjacent pairs merged (Batcher), pairs of pairs merged and
# pruned to ranks 7..12, and rank 12 of 25 selected as max_i(min(A[i], B[k-i])).
_SORT5 = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4), (1, 3), (1, 2))


def _merge_wires(a: tuple, b: tuple, out: list) -> tuple:
    if not a:
        return b
    if not b:
        return a
    if len(a) == 1 and len(b) == 1:
        out.append((a[0], b[0]))
        return (a[0], b[0])
    e = _merge_wires(a[0::2], b[0::2], out)
    o = _merge_wires(a[1::2], b[1::2], out)
    res, oi, ei = [e[0]], 0, 1
    while oi < len(o) and ei < len(e):
        out.append((o[oi], e[ei]))
        res += [o[oi], e[ei]]
        oi, ei = oi + 1, ei + 1
    return tuple(res + list(o[oi:]) + list(e[ei:]))


def _merge(a: list, b: list, ranks=None):
    ce = []
    order = _merge_wires(tuple(range(len(a))), tuple(range(len(a), len(a) + len(b))), ce)
    ops = [("cmp", i, j) for i, j in ce]
    if ranks is not None:
        needed, ops = {order[r] for r in ranks}, []
        for i, j in reversed(ce):
            if i in needed or j in needed:
                ops.append(("cmp" if (i in needed and j in needed)
                            else ("min" if i in needed else "max"), i, j))
                needed |= {i, j}
        ops.reverse()
    w = list(a) + list(b)
    for kind, i, j in ops:
        if kind == "cmp":
            w[i], w[j] = torch.minimum(w[i], w[j]), torch.maximum(w[i], w[j])
        elif kind == "min":
            w[i] = torch.minimum(w[i], w[j])
        else:
            w[j] = torch.maximum(w[i], w[j])
    return [w[k] for k in order] if ranks is None else {r: w[order[r]] for r in ranks}


def median5(x: Tensor) -> Tensor:
    """5x5 median (replicate border), cv2.medianBlur's value."""
    h, w = x.shape[-2:]
    xp = pad(x, 2, 2, 2, 2, "edge")
    cols = [xp[..., dy:dy + h, :w + 4] for dy in range(5)]
    for i, j in _SORT5:
        cols[i], cols[j] = torch.minimum(cols[i], cols[j]), torch.maximum(cols[i], cols[j])
    pairs = _merge([c[..., :, :w + 3] for c in cols], [c[..., :, 1:w + 4] for c in cols])
    q = _merge([p[..., :, :w] for p in pairs], [p[..., :, 2:2 + w] for p in pairs],
               ranks=range(7, 13))
    side = [c[..., :, 4:4 + w] for c in cols]
    t = q[7]
    for k in range(5):
        t = torch.maximum(t, torch.minimum(q[8 + k], side[4 - k]))
    return t


def shift(x: Tensor, dy: int, dx: int) -> Tensor:
    """``x`` at (y + dy, x + dx), replicate border."""
    h, w = x.shape[-2:]
    py, px = abs(dy), abs(dx)
    xp = pad(x, py, py, px, px, "edge")
    return xp[..., py + dy:py + dy + h, px + dx:px + dx + w]


# --- CFA planes --------------------------------------------------------------

def rgbg(bayer: Tensor):
    """(R, G1, B, G2) quarter planes of an RGGB mosaic."""
    return bayer[..., 0::2, 0::2], bayer[..., 0::2, 1::2], bayer[..., 1::2, 1::2], bayer[..., 1::2, 0::2]


def interleave(r: Tensor, g1: Tensor, b: Tensor, g2: Tensor) -> Tensor:
    h2, w2 = r.shape[-2:]
    out = r.new_empty(r.shape[:-2] + (2 * h2, 2 * w2))
    out[..., 0::2, 0::2], out[..., 0::2, 1::2] = r, g1
    out[..., 1::2, 1::2], out[..., 1::2, 0::2] = b, g2
    return out


_BINOMIAL5 = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64)


def _phase_kernels(base_left: bool, base_bottom: bool):
    """The four 3x3 kernels (TL, TR, BL, BR) that upsample a quarter plane
    sitting at the given quad position, split from the 5x5 binomial."""
    out = []
    for left, bottom in ((True, False), (False, False), (True, True), (False, True)):
        k = _BINOMIAL5[0::2] if base_bottom == bottom else _BINOMIAL5[1::2]
        k = k[:, 0::2] if base_left == left else k[:, 1::2]
        if left != base_left:
            z = np.zeros((k.shape[0], 1))
            k = np.hstack([k, z]) if left else np.hstack([z, k])
        if bottom != base_bottom:
            z = np.zeros((1, k.shape[1]))
            k = np.vstack([z, k]) if bottom else np.vstack([k, z])
        out.append((k / k.sum()).astype(np.float32))
    return out


def phase_upsample(plane: Tensor, base_left: bool, base_bottom: bool) -> Tensor:
    tl, tr, bl, br = _phase_kernels(base_left, base_bottom)
    return interleave(correlate(plane, tl), correlate(plane, tr), correlate(plane, br),
                      correlate(plane, bl))


# --- Best: AHD ---------------------------------------------------------------

_H = np.array([-0.2569, 0.4339, 0.5138, 0.4339, -0.2569]) * 0.125 \
    + np.array([-0.25, 0.5, 0.5, 0.5, -0.25]) * 0.875
_H = [float(v) for v in (_H / _H.sum()).astype(np.float32)]


def _homogeneity(lum, a, b, vertical: bool) -> Tensor:
    """Neighbours of the 3x3 window within the adaptive luminance (one-sided)
    and chroma bounds that the two neighbours along the direction set."""
    h, w = lum.shape[-2:]
    lp, ap, bp = (pad(t, 1, 1, 1, 1, "symmetric") for t in (lum, a, b))

    def win(t, dy, dx):
        return t[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    n1, n2 = ((-1, 0), (1, 0)) if vertical else ((0, -1), (0, 1))
    eps_l = torch.maximum(torch.abs(lum - win(lp, *n1)), torch.abs(lum - win(lp, *n2)))
    eps_c = torch.maximum((a - win(ap, *n1)) ** 2 + (b - win(bp, *n1)) ** 2,
                          (a - win(ap, *n2)) ** 2 + (b - win(bp, *n2)) ** 2)
    count = torch.full_like(lum, 3.0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) in ((0, 0), n1, n2):
                continue
            ok = ((win(lp, dy, dx) - lum) <= eps_l) & \
                 (((win(ap, dy, dx) - a) ** 2 + (win(bp, dy, dx) - b) ** 2) <= eps_c)
            count = count + ok.to(lum.dtype)
    return count


def _direction_map(r, g, b, mat, wb, is_hdr: bool, vertical: bool) -> Tensor:
    rr, gg, bb = r * wb[0], g * wb[1], b * wb[2]
    ir, ig, ib = (mat[i, 0] * rr + mat[i, 1] * gg + mat[i, 2] * bb for i in range(3))
    if is_hdr:
        luma = 0.2126 * ir + 0.7152 * ig + 0.0722 * ib
        _, la, lb = rgb_to_lab(ir / (1.0 + ir), ig / (1.0 + ig), ib / (1.0 + ib))
        return _homogeneity(luma, la, lb, vertical)
    return _homogeneity(*rgb_to_lab(ir, ig, ib), vertical)


def ahd(bayer: Tensor, mat: Tensor, wb: Tensor, is_hdr: bool, stages: int):
    """AHD of an RGGB mosaic to (r, g, b); ``mat`` the camera -> linear sRGB
    matrix, ``wb`` the reciprocal neutral."""
    r0, g10, b0, g20 = rgbg(bayer)
    r = pad(r0, 1, 1, 1, 1, "symmetric") * wb[0]
    g1 = pad(g10, 1, 1, 1, 1, "symmetric") * wb[1]
    b = pad(b0, 1, 1, 1, 1, "symmetric") * wb[2]
    g2 = pad(g20, 1, 1, 1, 1, "symmetric") * wb[1]
    h = _H
    gh_r = r[1:-1, :-2] * h[0] + g1[1:-1, :-2] * h[1] + r[1:-1, 1:-1] * h[2] \
        + g1[1:-1, 1:-1] * h[3] + r[1:-1, 2:] * h[4]
    gv_r = r[:-2, 1:-1] * h[0] + g2[:-2, 1:-1] * h[1] + r[1:-1, 1:-1] * h[2] \
        + g2[1:-1, 1:-1] * h[3] + r[2:, 1:-1] * h[4]
    gh_b = b[1:-1, :-2] * h[0] + g2[1:-1, 1:-1] * h[1] + b[1:-1, 1:-1] * h[2] \
        + g2[1:-1, 2:] * h[3] + b[1:-1, 2:] * h[4]
    gv_b = b[:-2, 1:-1] * h[0] + g1[1:-1, 1:-1] * h[1] + b[1:-1, 1:-1] * h[2] \
        + g1[2:, 1:-1] * h[3] + b[2:, 1:-1] * h[4]
    g1c, g2c = g1[1:-1, 1:-1], g2[1:-1, 1:-1]
    g_h = interleave(gh_r, g1c, gh_b, g2c)
    g_v = interleave(gv_r, g1c, gv_b, g2c)
    hf_h = g_h - correlate(g_h, GAUSS3)
    hf_v = g_v - correlate(g_v, GAUSS3)
    # each direction upsamples R and B again, as the plain path does (the
    # work that roofline.BEST_OPS_PER_PX counts)
    r_h = phase_upsample(r[1:-1, 1:-1], True, False) + hf_h
    r_v = phase_upsample(r[1:-1, 1:-1], True, False) + hf_v
    b_h = phase_upsample(b[1:-1, 1:-1], False, True) + hf_h
    b_v = phase_upsample(b[1:-1, 1:-1], False, True) + hf_v

    map_h = box_sum3(_direction_map(r_h, g_h, b_h, mat, wb, is_hdr, False))
    map_v = box_sum3(_direction_map(r_v, g_v, b_v, mat, wb, is_hdr, True))
    pick = (map_h < map_v).to(bayer.dtype)
    inv = 1.0 - pick
    out_r, out_g, out_b = r_h * pick + r_v * inv, g_h * pick + g_v * inv, b_h * pick + b_v * inv
    for _ in range(stages):
        out_r = median5(out_r - out_g) + out_g
        out_b = median5(out_b - out_g) + out_g
        out_g = (median5(out_g - out_r) + median5(out_g - out_b) + out_r + out_b) * 0.5
    return out_r, out_g, out_b


# --- Fast: edge-assisted Gaussian ---------------------------------------------

def _mix(top, bottom, left, right):
    dy, dx = torch.abs(top - bottom), torch.abs(left - right)
    s = dy + dx
    nz = s != 0
    sy = torch.where(nz, dy / torch.where(nz, s, 1.0), 0.5)
    return (top + bottom) * 0.5 * (1.0 - sy) + (left + right) * 0.5 * sy


def eag(bayer: Tensor, wb: Tensor):
    """Fast demosaic of an RGGB mosaic to (r, g, b), WB applied."""
    r, g1, b, g2 = rgbg(bayer)
    h, w = g1.shape[-2:]
    g1p, g2p = pad(g1, 1, 1, 1, 1, "symmetric"), pad(g2, 1, 1, 1, 1, "symmetric")
    g_at_b = _mix(g1p[1:1 + h, 1:1 + w], g1p[2:2 + h, 1:1 + w],
                  g2p[1:1 + h, 1:1 + w], g2p[1:1 + h, 2:2 + w])
    g_at_r = _mix(g2p[0:h, 1:1 + w], g2p[1:1 + h, 1:1 + w],
                  g1p[1:1 + h, 0:w], g1p[1:1 + h, 1:1 + w])
    g_up = interleave(g_at_r, g1, g_at_b, g2) * wb[1]
    hf = g_up - correlate(g_up, GAUSS3)
    r_up = phase_upsample(r * wb[0], True, False) + hf
    b_up = phase_upsample(b * wb[2], False, True) + hf
    return r_up, g_up, b_up


# --- Draft: quarter resolution and a 2x bilinear upsample ---------------------

def _upsample2x(x: Tensor) -> Tensor:
    """cv2.resize INTER_LINEAR to twice the size (half-pixel centres)."""
    def axis(v, dim):
        v = v.movedim(dim, -1)
        n = v.shape[-1]
        vp = torch.cat([v[..., :1], v, v[..., -1:]], dim=-1)
        even = 0.75 * vp[..., 1:n + 1] + 0.25 * vp[..., 0:n]
        odd = 0.75 * vp[..., 1:n + 1] + 0.25 * vp[..., 2:n + 2]
        return torch.stack([even, odd], dim=-1).reshape(*v.shape[:-1], 2 * n).movedim(-1, dim)
    return axis(axis(x, 0), 1)


def draft(bayer: Tensor, wb: Tensor):
    r, g1, b, g2 = rgbg(bayer)
    g = (g1 + g2) * 0.5 * wb[1]
    rp = pad(r, 0, 1, 0, 1, "symmetric")
    bp = pad(b, 1, 0, 1, 0, "symmetric")
    rc = (0.75 * rp[:-1, :-1] + 0.25 * rp[1:, 1:]) * wb[0]
    bc = (0.75 * bp[1:, 1:] + 0.25 * bp[:-1, :-1]) * wb[2]
    return _upsample2x(rc), _upsample2x(g), _upsample2x(bc)
