"""Tile pooling + ROI detection for the blind CA solver (host-side NumPy).

A copy of ``pysp_tpu/correct/ca/roi.py``: it imports NumPy only, so the port
carries it unchanged rather than importing the JAX package.

Reference behavior: pySP's corr_ca/roi/ — additive tile pooling
(tiled/tile_pooler.py:5-30), radial-bin lookup and per-tile feature screening
(tiled/tile_roi_finder.py:21-206), plus the small helpers (helper.py:5-36).

The reference's ROI detector is dead on arrival as shipped: it imports 2D line
primitives from an external, unbundled project (`pipeline.border_control.linework`,
tile_roi_finder.py:5) and uses the removed ``np.bool`` alias (:28). This module supplies
its own line primitives and implements the intended behavior with one consistent (y, x)
coordinate convention (the reference mixes (x, y)/(y, x) around its midpoint flip,
tile_roi_finder.py:140-160 — the stated intent, a perpendicularity test between the
feature line and the radius, is preserved).

This runs once per image on a ~(H/16, W/16) tile grid with scalar fits — host NumPy
territory, not device work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def quarter_res_pool(image: np.ndarray) -> np.ndarray:
    """2x2 additive pooling; odd edges cropped (roi/helper.py:5-21)."""
    my, mx = image.shape[0] // 2, image.shape[1] // 2
    return (
        image[0::2, 0::2][:my, :mx]
        + image[1::2, 0::2][:my, :mx]
        + image[0::2, 1::2][:my, :mx]
        + image[1::2, 1::2][:my, :mx]
    )


def remove_radial_content(
    channel: np.ndarray, fill_val: float = 0.0, radial_percent: float = 0.3
) -> np.ndarray:
    """Fill a central disc of the channel (roi/helper.py:23-36; cv2.circle replaced by
    a direct radius mask). Returns a new array."""
    out = np.array(channel, copy=True)
    cy, cx = channel.shape[0] // 2, channel.shape[1] // 2
    max_radius = np.hypot(cx, cy)
    yy, xx = np.mgrid[0 : channel.shape[0], 0 : channel.shape[1]]
    mask = np.hypot(yy - cy, xx - cx) <= round(max_radius * radial_percent)
    out[mask] = fill_val
    return out


class PooledChannel:
    """Tile-grid pooling of a channel (tile_pooler.py:5-30)."""

    def __init__(self, channel: np.ndarray, tile_pow: int = 4):
        self._tile_width = 2**tile_pow
        self._extra_yx = np.array(channel.shape[:2]) % self._tile_width

        shape = np.array(channel.shape[:2]) - self._extra_yx
        pooled = channel[
            self._extra_yx[0] // 2 : shape[0] + self._extra_yx[0] // 2,
            self._extra_yx[1] // 2 : shape[1] + self._extra_yx[1] // 2,
        ]
        self.source_cropped = np.copy(pooled)
        for _ in range(tile_pow):
            pooled = quarter_res_pool(pooled)
        self.source = channel
        self.pooled = pooled

    def get_tile_width(self) -> int:
        return self._tile_width

    def tile_offset_to_real_coords(self, point) -> np.ndarray:
        return np.array(point) * self._tile_width + (self._extra_yx // 2)


@dataclass
class TileResult:
    offset_real_tl: np.ndarray     # (y, x) of the tile's top-left in source coords
    average_n: float               # mean of the top-n feature samples
    offset_average_n: np.ndarray   # (y, x) feature midpoint relative to the tile


def _fit_line(xs: np.ndarray, ys: np.ndarray) -> Tuple[float, np.ndarray]:
    """Degree-1 least squares ys ~ m*xs + c; returns (residual, [c, m])."""
    a = np.stack([np.ones_like(xs, dtype=np.float64), xs.astype(np.float64)], axis=1)
    coef, residual, _rank, _sv = np.linalg.lstsq(a, ys.astype(np.float64), rcond=None)
    err = float(residual[0]) if residual.size else (
        float("inf") if np.ptp(xs) == 0 and np.ptp(ys) > 0 else 0.0
    )
    return err, coef


def _project_onto_line(point_yx, coef, rows_as_fn_of_cols: bool) -> np.ndarray:
    """Perpendicular foot of a (y, x) point on the fitted line."""
    c, m = float(coef[0]), float(coef[1])
    py, px = float(point_yx[0]), float(point_yx[1])
    if rows_as_fn_of_cols:
        # y = m x + c; direction (dy, dx) = (m, 1)
        t = ((px - 0.0) * 1.0 + (py - c) * m) / (1.0 + m * m)
        return np.array([m * t + c, t])
    # x = m y + c; direction (dy, dx) = (1, m)
    t = ((py - 0.0) * 1.0 + (px - c) * m) / (1.0 + m * m)
    return np.array([t, m * t + c])


class RoiDetector:
    """Feature screening + radial binning over thresholded tiles
    (tile_roi_finder.py:21-206)."""

    def __init__(
        self,
        pooled_resource: PooledChannel,
        remove_percent: float = 0.3,
        bins: int = 16,
        highest_n: int = 6,
        acceptable_error: float = 5.0,
        acceptable_edge_proximity: float = 0.8,
        acceptable_cos_angle: float = 0.5,
        default_threshold: float = 0,
    ):
        self._resource = pooled_resource
        self._resource.pooled = remove_radial_content(
            self._resource.pooled, 0, remove_percent
        )

        self._max_bin_count = bins
        self._threshold: Optional[float] = None
        self._threshold_map = np.ones(self._resource.pooled.shape, bool)
        self._map_tile_idx = np.full(self._resource.pooled.shape, -1, np.int32)

        self._detector_n_sample = highest_n
        self._detector_max_error = acceptable_error
        self._detector_edge_prox = acceptable_edge_proximity
        self._detector_max_angle = acceptable_cos_angle

        self._central_point_idx = (np.array(self._resource.source.shape[:2]) - 1) / 2

        self._tiles: List[TileResult] = []
        self.bins: List[List[TileResult]] = []

        # Radial lookup over the tile grid: bin index per tile, mirrored quadrants
        # (tile_roi_finder.py:41-62). Computed directly from tile-center radii.
        th, tw = self._resource.pooled.shape[:2]
        cy, cx = (th - 1) / 2.0, (tw - 1) / 2.0
        yy, xx = np.mgrid[0:th, 0:tw]
        radius = np.hypot(yy - cy, xx - cx)
        corner = np.hypot(cy, cx)
        radius = radius / (corner + np.spacing(corner))
        self._radial_lookup = (radius * self._max_bin_count).astype(np.uint16)

        self.apply_threshold(default_threshold)

    # -- internals --------------------------------------------------------------
    def _update_bins(self) -> None:
        self.bins = []
        lookup = np.copy(self._radial_lookup)
        lookup[~self._threshold_map] = self._max_bin_count

        for b in range(self._max_bin_count):
            group = np.argwhere(lookup == b)
            bin_tiles = [
                self._tiles[self._map_tile_idx[pt[0], pt[1]]] for pt in group
            ]
            bin_tiles.sort(key=lambda t: t.average_n, reverse=True)
            self.bins.append(bin_tiles)

    def _extract_feature_from_tile(self, tile_index) -> Optional[TileResult]:
        """Screen one tile: strong, line-like, interior, radius-perpendicular feature
        (tile_roi_finder.py:88-176)."""
        width = self._resource.get_tile_width()
        offset = self._resource.tile_offset_to_real_coords(tile_index).astype(np.int64)
        tile = self._resource.source[
            offset[0] : offset[0] + width, offset[1] : offset[1] + width
        ]

        flat = tile.flatten()
        n = self._detector_n_sample
        samples = np.argpartition(flat, -n)[-n:]
        rows, cols = np.unravel_index(samples, tile.shape)

        y_err, y_fit = _fit_line(cols, rows)   # rows as fn of cols
        x_err, x_fit = _fit_line(rows, cols)   # cols as fn of rows
        is_y = y_err < x_err
        fit, err = (y_fit, y_err) if is_y else (x_fit, x_err)

        if err > self._detector_max_error:
            return None

        midpoint = np.array([np.mean(rows), np.mean(cols)])  # (y, x) in tile
        offset_midpoint = np.copy(midpoint)

        # Reject features hugging the tile edge (likely truncated)
        ratio = np.abs(0.5 - midpoint / np.array(tile.shape)) / 0.5
        if (
            ratio[0] >= self._detector_edge_prox
            or ratio[1] >= self._detector_edge_prox
        ):
            return None

        # Closest point on the fitted line, then absolute coords
        midpoint = _project_onto_line(midpoint, fit, rows_as_fn_of_cols=is_y)
        midpoint_abs = midpoint + offset

        # Perpendicularity: feature direction vs center->midpoint radius
        m = float(fit[1])
        vec_ab = np.array([m, 1.0]) if is_y else np.array([1.0, m])
        vec_ab = vec_ab / np.linalg.norm(vec_ab)
        vec_cm = midpoint_abs - self._central_point_idx
        norm = np.linalg.norm(vec_cm)
        if norm == 0:
            return None
        vec_cm = vec_cm / norm

        if abs(float(np.dot(vec_cm, vec_ab))) >= self._detector_max_angle:
            return None

        return TileResult(
            offset_real_tl=offset,
            average_n=float(np.mean(tile[rows, cols])),
            offset_average_n=offset_midpoint,
        )

    # -- public -----------------------------------------------------------------
    def apply_threshold(self, threshold: float) -> None:
        if threshold == self._threshold:
            return
        self._threshold = threshold
        self._threshold_map = self._resource.pooled >= threshold

        for pt in np.argwhere(self._threshold_map):
            if self._map_tile_idx[pt[0], pt[1]] != -1:
                continue
            result = self._extract_feature_from_tile(pt)
            if result is None:
                # Feature extraction is threshold-independent: invalidate for good
                self._resource.pooled[pt[0], pt[1]] = -1
                self._threshold_map[pt[0], pt[1]] = False
                continue
            self._map_tile_idx[pt[0], pt[1]] = len(self._tiles)
            self._tiles.append(result)

        self._update_bins()
