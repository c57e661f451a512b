"""Radial lens-distortion models for chromatic-aberration correction.

Counterpart of ``pysp_tpu/correct/ca/models.py`` (pySP's corr_ca/model/:
the abstract model and its radial coordinate fields, Poly3 ``Rd = k1 Ru^3 +
(1-k1) Ru`` with a median fit, Poly5 ``Rd = Ru + h1 Ru^3 + h2 Ru^5`` and PTLens
``Rd = a Ru^4 + b Ru^3 + c Ru^2 + (1-a-b-c) Ru`` by least squares, and the
generic Newton-Raphson inversion).

- Coefficient fits: host NumPy, the JAX package's code unchanged.
- Coordinate fields: torch, on the device of the tensor given (the ``*_window``
  forms and ``radius_field`` take a ``device``, the card unless the caller asks
  for another). The field is ``|pos - center|`` at full resolution, as in the
  JAX package.
- Newton inversion: 8 iterations from zero, a Python loop with no early exit,
  as the JAX package's fixed-trip loop (DIVERGENCES.md, "Newton/bisection
  early exits").
- The remap kernel's own coordinates: each of the three Newton models states
  its radial form in ``kernel_form()`` (the form's name and the float32
  constants of its expressions), from which the remap kernel computes the
  coordinate fields in registers, bit for bit as these methods compute them
  on the card (``correct/ca/removal.py``). Any other model gives None and
  keeps the plain fields.
- The centre pixel: where the radius is exactly 0 (both sizes of the plane
  odd), ``f(r) / r`` is 0/0. The port takes the scale there as 1, so the offset
  is ``0 * 1 = 0``, the continuous limit; the JAX package returns NaN there.
  The same rule holds for ``lensfun_poly3_remap_coords``'s ratio.

Also includes the standalone lensfun Poly3 remap (pySP's corr_ca_poly3.py:5-72).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.device import CARD, resolve_device

Tensor = torch.Tensor


def radius_field(shape: Tuple[int, int], device=CARD) -> Tensor:
    """Normalized radius at every pixel center; 1.0 at the image corner."""
    h, w = shape
    device = resolve_device(device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.abs(torch.arange(h, dtype=torch.float32, device=device) - cy)[:, None]
    xs = torch.abs(torch.arange(w, dtype=torch.float32, device=device) - cx)[None, :]
    r = torch.sqrt(ys * ys + xs * xs)
    r_corner = float(np.hypot(cy, cx))
    return r / r_corner


def radial_scale(r: Tensor, radial_fn) -> Tensor:
    """``radial_fn(r) / r``, and 1 where ``r == 0``.

    ``radial_fn`` is evaluated at radius 1 there instead of 0, so that neither
    the value nor a gradient through it meets 0/0."""
    centre = r == 0
    r_safe = torch.where(centre, torch.ones_like(r), r)
    return torch.where(centre, torch.ones_like(r), radial_fn(r_safe) / r_safe)


class CaCorrectionModel(ABC):
    """Abstract radial model (generic.py:41-55)."""

    @abstractmethod
    def compute_coefficients(self, r_distorted_undistorted: np.ndarray) -> bool:
        ...

    @abstractmethod
    def get_coefficients(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_distorted(self, undistorted: Tensor) -> Tensor:
        ...

    def kernel_form(self) -> Optional[Tuple[str, np.ndarray]]:
        """The radial form whose coordinates the remap kernel computes itself
        (``ops.cuda_kernels.remap_radial_kernel``): its name and the float32
        constants PyTorch rounds this model's Python scalars to against a
        float32 tensor, in the order ``ops.cuda_kernels.radial_plain`` reads
        them. None here: CA removal then builds this model's coordinate
        fields with plain PyTorch."""
        return None

    def get_distorted_coordinates(self, image: Tensor) -> Tensor:
        """(H, W, 2) center-relative (dy, dx) offsets mapping undistorted sampling
        points to their distorted locations, on ``image``'s device."""
        return self._coordinates(image, self.get_distorted)

    def get_distorted_coordinates_window(
        self, n_rows: int, row0: int, full_shape: Tuple[int, int], device=CARD
    ) -> Tensor:
        """Forward offsets for output rows [row0, row0+n_rows) of a FULL frame:
        ``get_distorted_coordinates(full_image)[row0:row0+n_rows]`` computed at
        the absolute rows."""
        return self._coordinates_window(n_rows, row0, full_shape, self.get_distorted, device)

    def _coordinates_window(
        self, n_rows: int, row0: int, full_shape: Tuple[int, int], radial_fn, device
    ) -> Tensor:
        h, w = full_shape
        device = resolve_device(device)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        r_corner = float(np.hypot(cy, cx))

        ys = (torch.arange(n_rows, dtype=torch.float32, device=device) + row0 - cy)[:, None]
        xs = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, :]
        r = torch.sqrt(ys * ys + xs * xs) / r_corner

        scale = radial_scale(r, radial_fn)
        dy = ys.expand(n_rows, w) * scale
        dx = xs.expand(n_rows, w) * scale
        return torch.stack([dy, dx], dim=-1)

    def _coordinates(self, image: Tensor, radial_fn) -> Tensor:
        h, w = image.shape[-2], image.shape[-1]
        return self._coordinates_window(h, 0, (h, w), radial_fn, image.device)


class ReversibleModelMixin(ABC):
    """Any correction whose radial map can be inverted (generic.py:103-159)."""

    @abstractmethod
    def estimate_undistorted(
        self, distorted: Tensor, max_iterations: int = 8, max_epsilon: float = 1e-5
    ) -> Tensor:
        ...

    def get_undistorted_coordinates(self, image: Tensor) -> Tensor:
        """(H, W, 2) offsets mapping distorted sampling points to undistorted
        locations, on ``image``'s device."""
        return self._coordinates(image, self.estimate_undistorted)

    def get_undistorted_coordinates_window(
        self, n_rows: int, row0: int, full_shape: Tuple[int, int], device=CARD
    ) -> Tensor:
        """Inverse offsets for output rows [row0, row0+n_rows) of a FULL frame
        (see get_distorted_coordinates_window)."""
        return self._coordinates_window(
            n_rows, row0, full_shape, self.estimate_undistorted, device
        )


class NewtonRaphsonModel(CaCorrectionModel, ReversibleModelMixin):
    """Polynomial models inverted with Newton-Raphson (generic.py:161-204)."""

    @abstractmethod
    def _undistorted_to_distorted(self, undistorted: Tensor) -> Tensor:
        ...

    @abstractmethod
    def _undistorted_to_distorted_prime(self, undistorted: Tensor) -> Tensor:
        ...

    def get_distorted(self, undistorted: Tensor) -> Tensor:
        return self._undistorted_to_distorted(undistorted)

    def estimate_undistorted(
        self, distorted: Tensor, max_iterations: int = 8, max_epsilon: float = 1e-5
    ) -> Tensor:
        """Newton from zero, ``max_iterations`` steps (no early exit at
        ``max_epsilon``). A tensor keeps its dtype and device; anything else
        becomes a float32 CPU tensor."""
        if not isinstance(distorted, Tensor):
            distorted = torch.as_tensor(np.asarray(distorted, np.float32))
        und = torch.zeros_like(distorted)
        for _ in range(max_iterations):
            und = und - (
                (self._undistorted_to_distorted(und) - distorted)
                / self._undistorted_to_distorted_prime(und)
            )
        return und


class Poly3CorrectionModel(NewtonRaphsonModel):
    """Rd = k1 Ru^3 + (1 - k1) Ru (poly3.py:7-46). Closed-form median fit.

    The constructor clamps k1 to the model's validity domain (-0.5, 1] (the
    monotonicity of Rd(Ru) on [0, 1]), not to [0, 1] as pySP does, so that a
    fitted negative k1 survives a sidecar round trip (DIVERGENCES.md).
    """

    def __init__(self, initial_k1: float = 0.0):
        self._k1 = min(1.0, max(float(initial_k1), -0.499))

    def _undistorted_to_distorted(self, und):
        return self._k1 * und**3 + (1.0 - self._k1) * und

    def _undistorted_to_distorted_prime(self, und):
        return 3.0 * self._k1 * und**2 + (1.0 - self._k1)

    def get_coefficients(self):
        return np.array((self._k1,))

    def kernel_form(self):
        k1 = self._k1
        return "poly3", np.float32([k1, 1.0 - k1, 3.0 * k1])

    def compute_coefficients(self, r_distorted_undistorted: np.ndarray) -> bool:
        r_d = np.asarray(r_distorted_undistorted)[:, 0]
        r_ud = np.asarray(r_distorted_undistorted)[:, 1]
        # (Rd/Ru - 1) / (Ru^2 - 1) = k1; samples at Ru == 1 are indeterminate
        with np.errstate(divide="ignore", invalid="ignore"):
            k1 = ((r_d / r_ud) - 1.0) / (r_ud**2 - 1.0)
        self._k1 = float(np.nanmedian(k1))
        return True


class Poly5CorrectionModel(NewtonRaphsonModel):
    """Rd = Ru + h1 Ru^3 + h2 Ru^5 (poly5.py:4-79). Least-squares fit."""

    def __init__(self, h1: float = 0.0, h2: float = 0.0):
        self._h1 = float(h1)
        self._h2 = float(h2)

    def _undistorted_to_distorted(self, und):
        r2 = und * und
        return und * (1.0 + r2 * (self._h1 + r2 * self._h2))

    def _undistorted_to_distorted_prime(self, und):
        r2 = und * und
        return 1.0 + r2 * (3.0 * self._h1 + 5.0 * self._h2 * r2)

    def get_coefficients(self):
        return np.array((self._h1, self._h2))

    def kernel_form(self):
        return "poly5", np.float32([self._h1, self._h2, 3.0 * self._h1, 5.0 * self._h2])

    def compute_coefficients(self, r_distorted_undistorted: np.ndarray) -> bool:
        r_d = np.asarray(r_distorted_undistorted)[:, 0]
        r_ud = np.asarray(r_distorted_undistorted)[:, 1]
        g = r_d - r_ud
        m = np.stack([r_ud**3, r_ud**5], axis=1)
        try:
            solution, *_ = np.linalg.lstsq(m, g, rcond=None)
            self._h1, self._h2 = (float(v) for v in solution)
            return True
        except np.linalg.LinAlgError:
            return False


class PtLensCorrectionModel(NewtonRaphsonModel):
    """Rd = a Ru^4 + b Ru^3 + c Ru^2 + (1-a-b-c) Ru (ptlens.py:17-92)."""

    def __init__(self, a: float = 0.0, b: float = 0.0, c: float = 0.0):
        self._a = float(a)
        self._b = float(b)
        self._c = float(c)

    def _undistorted_to_distorted(self, und):
        d = 1.0 - self._a - self._b - self._c
        return und * (d + und * (self._c + und * (self._b + und * self._a)))

    def _undistorted_to_distorted_prime(self, und):
        d = 1.0 - self._a - self._b - self._c
        return d + und * (2.0 * self._c + und * (3.0 * self._b + und * 4.0 * self._a))

    def get_coefficients(self):
        return np.array((self._a, self._b, self._c))

    def kernel_form(self):
        d = 1.0 - self._a - self._b - self._c
        return "ptlens", np.float32([self._a, self._b, self._c, d, 3.0 * self._b,
                                     2.0 * self._c])

    def compute_coefficients(self, r_distorted_undistorted: np.ndarray) -> bool:
        r_d = np.asarray(r_distorted_undistorted)[:, 0]
        r_ud = np.asarray(r_distorted_undistorted)[:, 1]
        g = (r_d / r_ud) - 1.0
        m = np.stack([r_ud**3 - 1.0, r_ud**2 - 1.0, r_ud - 1.0], axis=1)
        try:
            solution, *_ = np.linalg.lstsq(m, g, rcond=None)
            self._a, self._b, self._c = (float(v) for v in solution)
            return True
        except np.linalg.LinAlgError:
            return False


def lensfun_poly3_remap_coords(
    shape: Tuple[int, int],
    poly3_b: float,
    poly3_c: float,
    poly3_v: float,
    max_iterations: int = 8,
    device=CARD,
) -> Tuple[Tensor, Tensor]:
    """Lensfun Poly3 ``Rd = b Ru^3 + c Ru^2 + v Ru`` inverse remap field
    (corr_ca_poly3.py:5-72), on ``device`` (the card unless the caller asks for
    another). Returns (map_x, map_y) for remap_bilinear; the centre pixel of an
    odd-by-odd frame maps to itself."""
    h, w = shape
    device = resolve_device(device)
    c_y, c_x = (h - 1) / 2.0, (w - 1) / 2.0
    max_radius = float(np.hypot(c_y, c_x))

    ys = (torch.arange(h, dtype=torch.float32, device=device) - c_y)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=device) - c_x)[None, :]
    r_dist = torch.sqrt(ys.expand(h, w) * ys.expand(h, w)
                        + xs.expand(h, w) * xs.expand(h, w)) / max_radius

    def f(r):
        return poly3_b * r**3 + poly3_c * r**2 + poly3_v * r

    def f_prime(r):
        return 3.0 * poly3_b * r**2 + 2.0 * poly3_c * r + poly3_v

    centre = r_dist == 0
    r_safe = torch.where(centre, torch.ones_like(r_dist), r_dist)
    r_undist = torch.zeros_like(r_safe)
    for _ in range(max_iterations):
        r_undist = r_undist - (f(r_undist) - r_safe) / f_prime(r_undist)

    ratio = torch.where(centre, torch.ones_like(r_dist), r_safe / r_undist)
    new_x = xs.expand(h, w) * ratio + c_x
    new_y = ys.expand(h, w) * ratio + c_y
    return new_x, new_y
