"""Radial template matching for CA scale-pair extraction.

Counterpart of ``pysp_tpu/correct/ca/matcher.py``. ``template_match`` and
``_bilinear_patch`` are its host NumPy code unchanged; ``template_match_batch``
is torch on the device of the reference channel, every tile at once.

Reference behavior: pySP's corr_ca/solver/tiled_template_matcher.py:4-99 —
slide a blurred tile along its center-ray segment in quarter-pixel coarse steps,
L1 error against the reference channel, then interval-halving sub-pixel refinement.

Vectorized over the coarse steps (the reference loops in Python per step): all step
positions are sampled in one bilinear gather batch. The reference weights the error as
``abs(diff) ** 1 / 2.2`` — which by operator precedence is a constant 1/2.2 scale, not a
gamma; argmin is unchanged, so plain L1 is used here.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _bilinear_patch(
    image: np.ndarray, offset_y: np.ndarray, offset_x: np.ndarray, th: int, tw: int
) -> np.ndarray:
    """Sample (len(offsets), th, tw) patches at fractional corners (vectorized)."""
    h, w = image.shape[:2]
    ys = offset_y[:, None, None] + np.arange(th, dtype=np.float32)[None, :, None]
    xs = offset_x[:, None, None] + np.arange(tw, dtype=np.float32)[None, None, :]
    ys = np.broadcast_to(ys, (len(offset_y), th, tw))
    xs = np.broadcast_to(xs, (len(offset_x), th, tw))

    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    fy = ys - y0
    fx = xs - x0
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)

    return (
        (1 - fx) * (1 - fy) * image[y0c, x0c]
        + fx * (1 - fy) * image[y0c, x1c]
        + (1 - fx) * fy * image[y1c, x0c]
        + fx * fy * image[y1c, x1c]
    )


def template_match(
    target: np.ndarray,
    tile_blurred: np.ndarray,
    start: np.ndarray,
    end: np.ndarray,
    integer_only: bool = False,
    resample: bool = True,
    resample_max_steps: int = 8,
) -> np.ndarray:
    """Optimal (y, x) tile position along the start->end axis minimizing L1 error.

    Matches the reference semantics: quarter-pixel coarse scan from ``start`` (endpoint
    excluded, :60-66), then interval-halving refinement around the coarse winner
    (:82-97). ``integer_only`` floors sampling positions for fast lookups.
    """
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    th, tw = tile_blurred.shape[:2]

    delta = end - start
    mag = float(np.sqrt(np.sum(delta**2)))
    vec = delta / mag / 4.0  # quarter-pixel steps
    n_steps = int(np.floor(mag * 4.0))
    if n_steps <= 0:
        return np.copy(start)

    steps = np.arange(n_steps, dtype=np.float64)
    pos = start[None, :] + steps[:, None] * vec[None, :]

    if integer_only:
        pos_i = np.floor(pos).astype(np.int64)
        errs = np.empty(n_steps)
        for i, (py, px) in enumerate(pos_i):
            section = target[py : py + th, px : px + tw]
            errs[i] = np.sum(np.abs(section - tile_blurred))
        best_step = int(np.argmin(errs))
        return start + best_step * vec

    patches = _bilinear_patch(
        target, pos[:, 0].astype(np.float32), pos[:, 1].astype(np.float32), th, tw
    )
    errs = np.sum(np.abs(patches - tile_blurred[None]), axis=(1, 2))
    best_step = int(np.argmin(errs))

    if not resample:
        return start + best_step * vec

    def err_at(p: np.ndarray) -> float:
        patch = _bilinear_patch(
            target,
            np.array([p[0]], np.float32),
            np.array([p[1]], np.float32),
            th,
            tw,
        )[0]
        return float(np.sum(np.abs(patch - tile_blurred)))

    solver_start = start + (best_step - 1) * vec
    solver_end = start + (best_step + 1) * vec
    solver_center = (solver_start + solver_end) / 2
    last_center = np.copy(solver_end)

    for _ in range(resample_max_steps):
        err_start = err_at(solver_start)
        err_middle = err_at(solver_center)
        err_end = err_at(solver_end)

        if abs(err_middle - err_start) > abs(err_middle - err_end):
            solver_start = solver_center
        else:
            solver_end = solver_center

        solver_center = (solver_start + solver_end) / 2
        if np.all(solver_center == last_center):
            break
        last_center = np.copy(solver_center)

    return solver_center


def _bilinear_patches(image: Tensor, py: Tensor, px: Tensor, th: int, tw: int) -> Tensor:
    """Bilinear (..., th, tw) patches of ``image`` (H, W) with fractional
    corners ``(py, px)`` of shape (...): the device twin of ``_bilinear_patch``,
    in the JAX package's operation order."""
    h, w = image.shape
    rows = torch.arange(th, dtype=torch.float32, device=image.device)
    cols = torch.arange(tw, dtype=torch.float32, device=image.device)
    ys = py[..., None, None] + rows[:, None]
    xs = px[..., None, None] + cols[None, :]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0c = y0.long().clamp(0, h - 1)
    y1c = (y0.long() + 1).clamp(0, h - 1)
    x0c = x0.long().clamp(0, w - 1)
    x1c = (x0.long() + 1).clamp(0, w - 1)
    flat = image.reshape(-1)

    def at(yi, xi):
        return flat[yi * w + xi]

    return (
        (1 - fx) * (1 - fy) * at(y0c, x0c)
        + fx * (1 - fy) * at(y0c, x1c)
        + (1 - fx) * fy * at(y1c, x0c)
        + fx * fy * at(y1c, x1c)
    )


def _tile_errors(target: Tensor, tiles: Tensor, p: Tensor) -> Tensor:
    """L1 error of each tile (N, th, tw) against ``target`` sampled at its
    positions ``p`` (N, S, 2): (N, S).

    The sum runs in one float32 accumulator over the tile in row-major order,
    the order of the JAX package's reduction run op by op. The refinement's
    decisions compare errors that differ by a few ulp near a symmetric
    minimum, so a sum in another order moves some tiles by up to a bisection
    step (``tools/ca_fit_report.py`` measures it: up to 0.04 px)."""
    th, tw = tiles.shape[-2:]
    patches = _bilinear_patches(target, p[..., 0], p[..., 1], th, tw)
    d = torch.abs(patches - tiles[:, None]).reshape(*p.shape[:-1], th * tw)
    err = d[..., 0]
    for k in range(1, th * tw):
        err = err + d[..., k]
    return err


def template_match_batch(target, tiles, pos, step_mask, vecs, refine_steps: int = 8) -> Tensor:
    """Every tile's coarse scan and interval-halving refinement at once
    (the reference loops tiles x steps in Python,
    tiled_template_matcher.py:60-97).

    target (H, W); tiles (N, th, tw); pos (N, S, 2) coarse scan positions
    (padded); step_mask (N, S) True for real steps; vecs (N, 2) quarter-pixel
    step vectors. Runs on ``target``'s device (a NumPy target is a CPU tensor)
    in float32, the JAX package's precision: the host path is float64, and the
    two differ by about 1e-4 px. The refinement runs ``refine_steps`` trips,
    with no early exit. Returns (N, 2) refined positions."""
    if not isinstance(target, Tensor):
        target = torch.as_tensor(np.asarray(target, np.float32))
    target = target.to(torch.float32)
    dev = target.device

    tiles, pos, vecs = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                        for x in (tiles, pos, vecs))
    step_mask = torch.as_tensor(step_mask, dtype=torch.bool, device=dev)

    errs = _tile_errors(target, tiles, pos)
    errs = torch.where(step_mask, errs, torch.full_like(errs, float("inf")))
    best = torch.argmin(errs, dim=1)
    best_pos = pos[torch.arange(pos.shape[0], device=dev), best]

    # interval-halving refinement (tiled_template_matcher.py:82-97), fixed-trip
    s_start = best_pos - vecs
    s_end = best_pos + vecs
    s_center = (s_start + s_end) * 0.5
    for _ in range(refine_steps):
        e_s, e_m, e_e = _tile_errors(
            target, tiles, torch.stack([s_start, s_center, s_end], dim=1)).unbind(1)
        move_start = (torch.abs(e_m - e_s) > torch.abs(e_m - e_e))[:, None]
        s_start = torch.where(move_start, s_center, s_start)
        s_end = torch.where(move_start, s_end, s_center)
        s_center = (s_start + s_end) * 0.5
    return s_center
