"""Gradient-based CA model fitting and refinement.

Counterpart of ``pysp_tpu/correct/ca/gradfit.py``. The whole correction
operator (Newton model inversion + bilinear remap) is differentiable almost
everywhere, so the coefficients of a radial model (Poly3, Poly5 or PTLens) can
be fitted, or a template-match fit refined, by gradient descent on a direct
channel-alignment loss, with no ROI features needed. The loss aligns a
``moving`` channel against a ``reference`` channel on an interior window
(clipped samples at the borders are non-differentiable plateaus).

The port runs on ``torch.autograd`` through the plain gather remap
(``ops.resample.remap_bilinear``): the remap kernel defines no backward, and
the JAX package differentiates its plain gather too. The optimiser is
``torch.optim.Adam`` with optax's defaults (betas 0.9 and 0.999, eps 1e-8): the
same update as ``optax.adam``, rounded in another order. Each step is a Python
loop iteration on the planes' device, where the JAX package scans in one
jitted program. The centre pixel of an odd-by-odd plane keeps its place
(``models.radial_scale``), where the JAX package's field is NaN.

The frame-level fits (``fit_ca_models_gradient``, ``refine_ca_models_gradient``)
align the mean G plane onto the R (or B) plane: ``G(U_theta(p)) ~ R(p)`` is the
warp that ``remove_ca_from_raw`` applies to G for a model, so the fitted model
removes the CA, with the sign that the template fit finds. The JAX package
aligns R onto G instead, which fits the inverse model: its gradient-fitted
models, applied by ``remove_ca_from_raw``, double the CA (ROADMAP.md queue C).
The channel-level functions (``radial_correct_channel``, the losses,
``fit_radial_gradient``) are the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ...core.bayer import bayer_to_rgbg
from ...core.device import CARD, resolve_device
from ...ops.resample import remap_bilinear
from .models import (
    NewtonRaphsonModel,
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
    radial_scale,
    radius_field,
)

Tensor = torch.Tensor


# kind -> (n_params, Rd(Ru, theta), dRd/dRu(Ru, theta), theta -> model). The
# polynomials are models.py's classes with the coefficients as a tensor.
def _poly3_fd(u, t):
    return t[0] * u * u * u + (1.0 - t[0]) * u


def _poly3_fdp(u, t):
    return 3.0 * t[0] * u * u + (1.0 - t[0])


def _poly5_fd(u, t):
    r2 = u * u
    return u * (1.0 + r2 * (t[0] + r2 * t[1]))


def _poly5_fdp(u, t):
    r2 = u * u
    return 1.0 + r2 * (3.0 * t[0] + 5.0 * t[1] * r2)


def _ptlens_fd(u, t):
    d = 1.0 - t[0] - t[1] - t[2]
    return u * (d + u * (t[2] + u * (t[1] + u * t[0])))


def _ptlens_fdp(u, t):
    d = 1.0 - t[0] - t[1] - t[2]
    return d + u * (2.0 * t[2] + u * (3.0 * t[1] + u * 4.0 * t[0]))


def _make_poly3(theta: np.ndarray) -> Poly3CorrectionModel:
    m = Poly3CorrectionModel()
    # direct assignment: the constructor clamps k1 to its validity domain, a
    # fitted coefficient is taken as it is
    m._k1 = float(theta[0])
    return m


_KINDS: Dict[str, Tuple[int, Callable, Callable, Callable]] = {
    "poly3": (1, _poly3_fd, _poly3_fdp, _make_poly3),
    "poly5": (2, _poly5_fd, _poly5_fdp,
              lambda t: Poly5CorrectionModel(float(t[0]), float(t[1]))),
    "ptlens": (3, _ptlens_fd, _ptlens_fdp,
               lambda t: PtLensCorrectionModel(*(float(v) for v in t))),
}


def _kind_of_model(model: NewtonRaphsonModel) -> str:
    if isinstance(model, Poly3CorrectionModel):
        return "poly3"
    if isinstance(model, Poly5CorrectionModel):
        return "poly5"
    if isinstance(model, PtLensCorrectionModel):
        return "ptlens"
    raise TypeError(f"No gradient-fit kind for {type(model).__name__}")


def _undistort_radii(r: Tensor, theta: Tensor, kind: str, iterations: int = 8) -> Tensor:
    """Newton-invert a radial model's map for tensor coefficients: the
    iteration of ``NewtonRaphsonModel.estimate_undistorted`` (zeros start,
    fixed trip count), so a gradient fit converges to the operator that the
    host model applies."""
    _, fd, fdp, _ = _KINDS[kind]
    und = torch.zeros_like(r)
    for _ in range(iterations):
        und = und - (fd(und, theta) - r) / fdp(und, theta)
    return und


def radial_correct_channel(channel: Tensor, theta: Tensor, kind: str) -> Tensor:
    """Apply a radial *correction* (inverse warp) with tensor coefficients:
    ``out(p) = channel(U_theta(p))`` where ``U_theta`` is the Newton-inverted
    radial map, what ``remove_ca_from_raw``'s G -> channel-grid warp does for a
    host model, differentiable with respect to ``theta``."""
    h, w = channel.shape[-2], channel.shape[-1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = radius_field((h, w), device=channel.device)
    scale = radial_scale(r, lambda rr: _undistort_radii(rr, theta, kind))
    ys = (torch.arange(h, dtype=torch.float32, device=channel.device) - cy)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=channel.device) - cx)[None, :]
    map_y = torch.clamp(ys * scale + cy, 0, h - 1)
    map_x = torch.clamp(xs * scale + cx, 0, w - 1)
    return remap_bilinear(channel, map_x, map_y)


def poly3_correct_channel(channel: Tensor, k1) -> Tensor:
    """Poly3 special case of :func:`radial_correct_channel`."""
    k1 = torch.as_tensor(k1, dtype=torch.float32, device=channel.device)
    return radial_correct_channel(channel, k1.reshape(1), "poly3")


def radial_alignment_loss(
    theta: Tensor, moving: Tensor, reference: Tensor, kind: str, margin: int = 8
) -> Tensor:
    """Interior MSE between the theta-corrected ``moving`` and ``reference``."""
    corrected = radial_correct_channel(moving, theta, kind)
    d = corrected[margin:-margin, margin:-margin] - reference[margin:-margin, margin:-margin]
    return torch.mean(d * d)


def poly3_alignment_loss(
    k1, moving: Tensor, reference: Tensor, margin: int = 8
) -> Tensor:
    """Poly3 special case of :func:`radial_alignment_loss`."""
    k1 = torch.as_tensor(k1, dtype=torch.float32, device=moving.device)
    return radial_alignment_loss(k1.reshape(1), moving, reference, "poly3", margin)


def _planes(moving, reference) -> Tuple[Tensor, Tensor]:
    """Both planes as float32 tensors on one device: that of whichever is a
    tensor, else the card."""
    device = next((x.device for x in (moving, reference) if isinstance(x, Tensor)), None)
    device = resolve_device(CARD if device is None else device)
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (moving, reference))


def fit_radial_gradient(
    moving,
    reference,
    kind: str = "poly3",
    theta_init=None,
    steps: int = 80,
    learning_rate: float = 2e-3,
    margin: int = 8,
) -> Tuple[np.ndarray, float]:
    """Fit a radial model's coefficients aligning ``moving`` onto ``reference``.

    Adam descent on the interior alignment MSE, ``steps`` steps on the planes'
    device; returns ``(theta, loss)``, the loss taken before the last step as
    the JAX package reports it. Typical use: the G plane of a CFA-split raw
    onto its R (or B) plane, from zero or seeded with a template-match fit's
    ``model.get_coefficients()``."""
    n, _, _, _ = _KINDS[kind]
    moving, reference = _planes(moving, reference)
    if theta_init is None:
        theta_init = np.zeros((n,), np.float32)
    theta = torch.tensor(np.asarray(theta_init, np.float32).reshape(n),
                         device=moving.device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    loss = None
    for _ in range(steps):
        opt.zero_grad()
        loss = radial_alignment_loss(theta, moving, reference, kind, margin)
        loss.backward()
        opt.step()
    final = float("nan") if loss is None else float(loss.detach())
    return theta.detach().cpu().numpy().astype(np.float64), final


def fit_poly3_gradient(
    moving,
    reference,
    k1_init: float = 0.0,
    steps: int = 80,
    learning_rate: float = 2e-3,
    margin: int = 8,
) -> Tuple[float, float]:
    """Poly3 special case of :func:`fit_radial_gradient`; returns ``(k1, loss)``."""
    theta, loss = fit_radial_gradient(
        moving, reference, "poly3", np.array([k1_init], np.float32),
        steps=steps, learning_rate=learning_rate, margin=margin,
    )
    return float(theta[0]), loss


def fit_ca_models_gradient(
    frame,
    k1_init_r: float = 0.0,
    k1_init_b: float = 0.0,
    steps: int = 80,
    learning_rate: float = 2e-3,
    kind: str = "poly3",
) -> Tuple[NewtonRaphsonModel, NewtonRaphsonModel]:
    """Gradient-fit R->G and B->G radial models straight from a RawFrame.

    Alternative to compute_ca_lens_models_for_raw: aligns the mean of the two G
    CFA planes onto the R and the B plane (quarter-res plane space, the grid
    relationship the template-match solver measures), on the frame's device,
    the direction in which ``remove_ca_from_raw`` warps G. Returns models for
    remove_ca_from_raw. ``kind`` selects poly3 (the default), poly5 or ptlens;
    the k1 seeds apply to the first coefficient."""
    n, _, _, make = _KINDS[kind]
    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    models = []
    for plane, k0 in ((r0, k1_init_r), (b0, k1_init_b)):
        t0 = np.zeros((n,), np.float32)
        t0[0] = k0
        theta, _ = fit_radial_gradient(
            g, plane, kind, t0, steps=steps, learning_rate=learning_rate
        )
        models.append(make(theta))
    return models[0], models[1]


def refine_ca_models_gradient(
    frame,
    model_r: NewtonRaphsonModel,
    model_b: NewtonRaphsonModel,
    steps: int = 40,
    learning_rate: float = 5e-4,
) -> Tuple[NewtonRaphsonModel, NewtonRaphsonModel]:
    """Polish template-match fits by gradient descent, keeping model kinds.

    Seeds each channel's fit with the host-fitted coefficients and runs a
    short low-rate descent on the direct alignment loss of G onto the channel
    (as :func:`fit_ca_models_gradient`), which removes the matcher's bisection
    quantization. Returns NEW models of the same classes (inputs untouched)."""
    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    out = []
    for plane, model in ((r0, model_r), (b0, model_b)):
        kind = _kind_of_model(model)
        _, _, _, make = _KINDS[kind]
        theta, _ = fit_radial_gradient(
            g, plane, kind, np.asarray(model.get_coefficients(), np.float32),
            steps=steps, learning_rate=learning_rate,
        )
        out.append(make(theta))
    return out[0], out[1]
