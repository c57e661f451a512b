"""Radial scale-pair extraction glue: ROI bins -> template matches -> (Rd, Ru) pairs.

A copy of ``pysp_tpu/correct/ca/solver.py`` (host NumPy) whose ``device=True``
branch calls the port's ``template_match_batch`` on the device of the
reference channel, which may be a tensor (the card's instability plane) or a
NumPy array.

Reference behavior: pySP's corr_ca/solver/radial_offset_solver.py:10-67.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .matcher import template_match, template_match_batch
from .roi import PooledChannel, RoiDetector, TileResult


def get_start_end_points_from_centers(
    center_feature: np.ndarray,
    offset_actual_feature: np.ndarray,
    center_image: np.ndarray,
    radius_percent: float,
):
    """Scan segment endpoints around the feature radius (radial_offset_solver.py:10-12)."""
    delta = center_feature + offset_actual_feature - center_image
    return (
        center_image + delta * (1 + radius_percent) - offset_actual_feature,
        center_image + delta * (1 - radius_percent) - offset_actual_feature,
    )


def _gaussian_blur3_sigma033(img: np.ndarray) -> np.ndarray:
    """3x3 Gaussian, sigma=0.33, reflect-101 border (cv2.GaussianBlur equivalent)."""
    k1 = np.exp(-0.5 * (np.array([-1.0, 0.0, 1.0]) / 0.33) ** 2)
    k1 = k1 / k1.sum()
    pad = np.pad(img, 1, mode="reflect")
    tmp = (
        k1[0] * pad[:, :-2] + k1[1] * pad[:, 1:-1] + k1[2] * pad[:, 2:]
    )
    return k1[0] * tmp[:-2] + k1[1] * tmp[1:-1] + k1[2] * tmp[2:]


def get_radius_scale_factors_from_bins(
    detector: RoiDetector,
    pool: PooledChannel,
    reference_channel: np.ndarray,
    top_n: int = 16,
    max_reach: float = 0.004,
    device: bool = True,
) -> np.ndarray:
    """(N, 2) array of normalized (r_distorted, r_undistorted) pairs
    (radial_offset_solver.py:14-61).

    ``device=True`` runs every tile's template match in one batch
    (matcher.template_match_batch) on ``reference_channel``'s device instead
    of the reference's per-tile Python loop; coarse-scan lengths are padded to
    a 64-step bucket, as in the JAX package, so the positions are the same.
    ``device=False`` runs the host loop on a NumPy copy."""
    if tuple(pool.source.shape) != tuple(reference_channel.shape):
        raise ValueError(
            "Reference and pooled channel shapes are not identical. "
            "No mapping can be formed."
        )

    tiles: List[TileResult] = []
    for bin_tiles in detector.bins:
        tiles.extend(bin_tiles[: min(top_n, len(bin_tiles))])

    if len(tiles) <= 4:
        raise ValueError("Not enough tiles to compute max quality model (PTLens).")

    idx_center = (np.array(pool.source.shape[:2]) - 1) / 2
    max_r = float(np.sqrt(np.sum(idx_center**2)))

    source_blurred = _gaussian_blur3_sigma033(np.asarray(pool.source, np.float32))

    tw = pool.get_tile_width()
    graphics, starts, ends, vecs, n_steps = [], [], [], [], []
    for tile in tiles:
        graphics.append(source_blurred[
            tile.offset_real_tl[0] : tile.offset_real_tl[0] + tw,
            tile.offset_real_tl[1] : tile.offset_real_tl[1] + tw,
        ])
        start, end = get_start_end_points_from_centers(
            tile.offset_real_tl, tile.offset_average_n, idx_center, max_reach
        )
        delta = end - start
        mag = float(np.sqrt(np.sum(delta**2)))
        starts.append(start)
        ends.append(end)
        vecs.append(delta / mag / 4.0 if mag > 0 else np.zeros(2))
        n_steps.append(int(np.floor(mag * 4.0)))

    if device and max(n_steps) > 0:
        # coarse positions padded to a 64-step bucket (clamped to each tile's
        # last real step so the pad gathers stay in-bounds)
        S = -(-max(n_steps) // 64) * 64
        pos = np.stack([
            st[None, :] + np.minimum(np.arange(S), max(n - 1, 0))[:, None] * v[None, :]
            for st, v, n in zip(starts, vecs, n_steps)
        ]).astype(np.float64)
        mask = np.arange(S)[None, :] < np.maximum(np.asarray(n_steps), 1)[:, None]
        corrected_all = template_match_batch(
            reference_channel, np.stack(graphics), pos, mask, np.stack(vecs)
        ).cpu().numpy().astype(np.float64)
        # n_steps <= 0: the reference returns start unrefined
        for i, n in enumerate(n_steps):
            if n <= 0:
                corrected_all[i] = starts[i]
    else:
        host = _host(reference_channel)
        corrected_all = np.stack([
            template_match(host, g, st, en) if n > 0 else st
            for g, st, en, n in zip(graphics, starts, ends, n_steps)
        ])

    radius_distorted = []
    radius_undistorted = []
    for tile, corrected in zip(tiles, corrected_all):
        feature = tile.offset_real_tl + tile.offset_average_n
        feature_corrected = corrected + tile.offset_average_n

        r_d = float(np.sqrt(np.sum((feature - idx_center) ** 2)))
        r_ud = float(np.sqrt(np.sum((feature_corrected - idx_center) ** 2)))

        radius_distorted.append(r_d / max_r)
        radius_undistorted.append(r_ud / max_r)

    return np.stack([radius_distorted, radius_undistorted], axis=1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_scale_pairs_using_pooled_tiler(
    channel_distorted: np.ndarray,
    channel_undistorted: np.ndarray,
    threshold: float = 16,
    max_reach: float = 0.004,
) -> np.ndarray:
    """End-to-end pair extraction for one channel (radial_offset_solver.py:63-67).

    The ROI screening runs on a host copy of ``channel_distorted``; the
    template matches on ``channel_undistorted`` where it lies."""
    pool = PooledChannel(_host(channel_distorted))
    detector = RoiDetector(pool, default_threshold=threshold)
    return get_radius_scale_factors_from_bins(
        detector, pool, channel_undistorted, max_reach=max_reach
    )
