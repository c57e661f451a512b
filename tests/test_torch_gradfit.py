"""Gradient CA fits of pysp_tpu_torch (torch.autograd + torch.optim.Adam)
against pysp_tpu's (jax.value_and_grad + optax.adam).

Every input is built once in NumPy from a seed and handed to both packages;
the JAX functions run op by op (``jax.disable_jit()``) except the fits, which
the JAX package scans in one jitted program. Tolerances (measured beside
each):

- ``radial_alignment_loss`` and its gradient: within 1e-5 relative (4.3e-7
  measured);
- ``fit_radial_gradient`` over 10 steps for poly3, poly5 and ptlens: theta
  within 1e-4 absolute (the same Adam update, rounded in another order;
  1.1e-7 measured);
- on an odd 21x21 plane the port's correction is finite, equals JAX's
  everywhere but the centre pixel (NaN in JAX), and its loss is finite;
- the port alone: the recovery gates of ``tests/test_gradfit.py``, the
  frame-level ones with the CA planted as ``tests/test_ca.py`` plants it.

The frame-level fits align G onto the channel, where the JAX package aligns
the channel onto G and fits the inverse model (ROADMAP.md queue C); they are
held against the JAX package's ``fit_radial_gradient`` run in the port's
direction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.correct.ca import gradfit as JG
from pysp_tpu_torch.core.frame import RawFrame
from pysp_tpu_torch.correct.ca import gradfit as TG
from pysp_tpu_torch.correct.ca.models import (
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
    radial_scale,
    radius_field,
)
from pysp_tpu_torch.ops.resample import remap_bilinear

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
THETA_ATOL = 1e-4
THETAS = {"poly3": [0.012], "poly5": [0.01, -0.004], "ptlens": [0.0, 0.01, -0.003]}


def _smooth_scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Band-limited random field (``tests/test_gradfit.py``'s scene)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16, w // 16), np.float32)
    up = jax.image.resize(jnp.asarray(coarse), (h, w), method="cubic")
    return np.asarray(0.1 + 0.8 * up, np.float32)


def _distort_model(channel: np.ndarray, model) -> torch.Tensor:
    """Observed channel: the scene sampled at the model-distorted positions."""
    h, w = channel.shape
    r = radius_field((h, w), device="cpu")
    scale = radial_scale(r, model.get_distorted)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32) - cy)[:, None]
    xs = (torch.arange(w, dtype=torch.float32) - cx)[None, :]
    map_y = torch.clamp(ys * scale + cy, 0, h - 1)
    map_x = torch.clamp(xs * scale + cx, 0, w - 1)
    return remap_bilinear(torch.from_numpy(np.ascontiguousarray(channel)), map_x, map_y)


def _plant(channel: np.ndarray, k1: float) -> torch.Tensor:
    """The channel sampled through Poly3(k1)'s inverse field (tests/test_ca.py's
    CA): what ``remove_ca_from_raw`` with Poly3(k1) undoes."""
    h, w = channel.shape
    coords = Poly3CorrectionModel(k1).get_undistorted_coordinates(torch.zeros(h, w))
    mx = torch.clamp(coords[..., 1] + (w - 1) / 2.0, 0, w - 1)
    my = torch.clamp(coords[..., 0] + (h - 1) / 2.0, 0, h - 1)
    return remap_bilinear(torch.from_numpy(np.ascontiguousarray(channel)), mx, my)


def _distort(channel: np.ndarray, k1: float) -> torch.Tensor:
    model = Poly3CorrectionModel()
    model._k1 = k1
    return _distort_model(channel, model)


@pytest.fixture(scope="module")
def pair():
    """(moving, reference) planes: the scene and its Poly3(0.012) distortion."""
    scene = _smooth_scene(64, 80, seed=1)
    return _distort(scene, 0.012).numpy(), scene


# --- loss and gradient -------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(THETAS))
@pytest.mark.parametrize("scale", [0.0, 0.5, 1.3])
def test_loss_and_gradient_match_jax(pair, kind, scale):
    """Measured: the loss within 4.3e-7 relative, the gradient within 2.3e-7
    of its largest component."""
    moving, reference = pair
    theta = np.asarray(THETAS[kind], np.float32) * np.float32(scale)
    t = torch.tensor(theta, requires_grad=True)
    loss = TG.radial_alignment_loss(t, torch.from_numpy(moving), torch.from_numpy(reference),
                                    kind)
    loss.backward()
    with jax.disable_jit():
        want_loss, want_grad = jax.value_and_grad(JG.radial_alignment_loss)(
            jnp.asarray(theta), jnp.asarray(moving), jnp.asarray(reference), kind)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(np.asarray(want_grad)).max())


def test_poly3_special_cases_match_jax(pair):
    moving, reference = pair
    got = TG.poly3_correct_channel(torch.from_numpy(moving), 0.01).numpy()
    got_loss = float(TG.poly3_alignment_loss(0.01, torch.from_numpy(moving),
                                             torch.from_numpy(reference)))
    with jax.disable_jit():
        want = np.asarray(JG.poly3_correct_channel(jnp.asarray(moving), jnp.float32(0.01)))
        want_loss = float(JG.poly3_alignment_loss(jnp.float32(0.01), jnp.asarray(moving),
                                                  jnp.asarray(reference)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", list(THETAS))
def test_odd_plane_correction_is_finite(kind):
    """At r = 0 (both sizes odd) the JAX correction is NaN and so is its loss;
    the port keeps the centre pixel in place and equals JAX elsewhere."""
    rng = np.random.default_rng(2)
    plane = rng.random((21, 21)).astype(np.float32)
    theta = np.asarray(THETAS[kind], np.float32)
    got = TG.radial_correct_channel(torch.from_numpy(plane), torch.from_numpy(theta), kind)
    with jax.disable_jit():
        want = np.asarray(JG.radial_correct_channel(jnp.asarray(plane), jnp.asarray(theta),
                                                    kind))
        want_loss = float(JG.radial_alignment_loss(jnp.asarray(theta), jnp.asarray(plane),
                                                   jnp.asarray(plane), kind, margin=2))
    got = got.numpy()
    assert np.isfinite(got).all() and got[10, 10] == plane[10, 10]
    nan = ~np.isfinite(want)
    assert nan[10, 10] and nan.sum() == 1
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=1e-6)
    t = torch.tensor(theta, requires_grad=True)
    loss = TG.radial_alignment_loss(t, torch.from_numpy(plane), torch.from_numpy(plane), kind,
                                    margin=2)
    loss.backward()
    assert np.isnan(want_loss)
    assert np.isfinite(float(loss.detach())) and np.isfinite(t.grad.numpy()).all()


# --- fits --------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(THETAS))
def test_fit_radial_gradient_matches_jax(pair, kind):
    """Ten Adam steps from zero. Measured: theta within 1.1e-7, the loss
    within 3.3e-5 relative (printed; ``pytest -s`` shows it)."""
    moving, reference = pair
    got, got_loss = TG.fit_radial_gradient(torch.from_numpy(moving),
                                           torch.from_numpy(reference), kind, steps=10)
    want, want_loss = JG.fit_radial_gradient(moving, reference, kind, steps=10)
    print(f"{kind}: theta {np.abs(got - want).max():.3g} apart, loss "
          f"{abs(got_loss / want_loss - 1):.3g} relative")
    assert got.dtype == np.float64 and got.shape == (len(THETAS[kind]),)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_ATOL)
    # the jitted JAX loss sums in another order, near its minimum
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def _jax_frame_fit(frame, seeds, steps, learning_rate):
    """The JAX package's gradient fit of each R/B plane run the port's way:
    the mean G plane aligned onto the channel, ``JG.fit_radial_gradient(g,
    plane)`` (``JG.fit_ca_models_gradient`` aligns the channel onto G, which
    fits the inverse model; ROADMAP.md queue C)."""
    from pysp_tpu.core.bayer import bayer_to_rgbg

    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    return [JG.fit_radial_gradient(g, plane, kind, np.asarray(seed, np.float32), steps=steps,
                                   learning_rate=learning_rate)[0]
            for plane, (kind, seed) in zip((r0, b0), seeds)]


def test_frame_fits_match_jax():
    """``fit_ca_models_gradient`` and ``refine_ca_models_gradient`` on a frame,
    10 steps each, against the JAX package's ``fit_radial_gradient`` of G onto
    each channel. Measured: within 1.1e-7."""
    from pysp_tpu.core.frame import RawFrame as JaxFrame

    scene = _smooth_scene(96, 128, seed=3)
    r_full = _plant(scene, 0.02).numpy()
    bayer = scene.copy()
    bayer[0::2, 0::2] = r_full[0::2, 0::2]
    tf = RawFrame.synthetic(bayer, device="cpu")
    jf = JaxFrame.synthetic(jnp.asarray(bayer))
    got = TG.fit_ca_models_gradient(tf, steps=10)
    want = _jax_frame_fit(jf, [("poly3", [0.0])] * 2, 10, 2e-3)
    got_ref = TG.refine_ca_models_gradient(tf, Poly5CorrectionModel(0.01, 0.0),
                                           Poly3CorrectionModel(0.001), steps=10)
    want_ref = _jax_frame_fit(jf, [("poly5", [0.01, 0.0]), ("poly3", [0.001])], 10, 5e-4)
    assert [type(m) for m in got_ref] == [Poly5CorrectionModel, Poly3CorrectionModel]
    for g, w in zip(got + got_ref, want + want_ref):
        np.testing.assert_allclose(g.get_coefficients(), w, rtol=0, atol=THETA_ATOL)


def test_frame_fit_removes_the_ca_it_finds():
    """The gradient-fitted model, applied by ``remove_ca_from_raw``, brings R
    closer to the clean scene, as the template fit's does; the JAX package's
    frame fit gives the inverse model, which moves R further away."""
    from pysp_tpu.core.frame import RawFrame as JaxFrame
    from pysp_tpu_torch.correct.ca.removal import remove_ca_from_raw

    scene = _smooth_scene(128, 160, seed=8)
    bayer = scene.copy()
    bayer[0::2, 0::2] = _plant(scene, 0.03).numpy()[0::2, 0::2]
    frame = RawFrame.synthetic(bayer, device="cpu")
    model_r, _ = TG.fit_ca_models_gradient(frame, steps=120)
    jax_k1 = float(JG.fit_ca_models_gradient(JaxFrame.synthetic(jnp.asarray(bayer)),
                                             steps=120)[0].get_coefficients()[0])
    jax_model = Poly3CorrectionModel()
    jax_model._k1 = jax_k1

    def r_error(b):
        return np.abs(b[0::2, 0::2] - scene[0::2, 0::2])[8:-8, 8:-8].mean()

    before = r_error(bayer)
    after = r_error(remove_ca_from_raw(frame, model_r, None).bayer.numpy())
    after_jax = r_error(remove_ca_from_raw(frame, jax_model, None).bayer.numpy())
    assert float(model_r.get_coefficients()[0]) > 0 > jax_k1
    assert after < 0.5 * before < before < after_jax, (before, after, after_jax)


# --- the port alone: tests/test_gradfit.py's recovery gates ---------------------------------


def test_correct_channel_inverts_distortion():
    scene = _smooth_scene(160, 192)
    moving = _distort(scene, 0.012)
    corrected = TG.poly3_correct_channel(moving, 0.012).numpy()
    err = np.abs(corrected[12:-12, 12:-12] - scene[12:-12, 12:-12]).max()
    assert err < 2e-2


@pytest.mark.parametrize("k_true", [0.01, -0.008])
def test_gradient_fit_recovers_k1(k_true):
    scene = _smooth_scene(160, 192, seed=2)
    moving = _distort(scene, k_true)
    k_fit, loss = TG.fit_poly3_gradient(moving, torch.from_numpy(scene), steps=120)
    assert abs(k_fit - k_true) < 0.25 * abs(k_true) + 5e-4
    assert loss < float(TG.poly3_alignment_loss(0.0, moving, torch.from_numpy(scene)))


@pytest.mark.parametrize("kind,true", [
    ("poly5", Poly5CorrectionModel(0.012, -0.004)),
    ("ptlens", PtLensCorrectionModel(0.0, 0.01, -0.003)),
])
def test_multi_coefficient_fit_recovers_the_operator(kind, true):
    scene = _smooth_scene(160, 192, seed=4 if kind == "poly5" else 5)
    moving = _distort_model(scene, true)
    theta, loss = TG.fit_radial_gradient(moving, torch.from_numpy(scene), kind, steps=160)
    fit = TG._KINDS[kind][3](theta)
    rs = torch.linspace(0.1, 0.95, 64)
    map_err = (fit.get_distorted(rs) - true.get_distorted(rs)).abs().max().item()
    assert map_err < 2.5e-3
    zero = torch.zeros(len(theta))
    assert loss < float(TG.radial_alignment_loss(zero, moving, torch.from_numpy(scene), kind))


def _frame_with_distorted_r(seed, k_true):
    """R displaced as tests/test_ca.py plants CA, the displacement that
    Poly3(k_true) removes; G and B clean."""
    h, w = 192, 224
    scene = _smooth_scene(h, w, seed=seed)
    r_full = _plant(scene, k_true).numpy()
    bayer = scene.copy()
    bayer[0::2, 0::2] = r_full[0::2, 0::2]
    return RawFrame.synthetic(bayer, device="cpu")


def test_refine_improves_quantized_template_fit():
    k_true = 0.02
    frame = _frame_with_distorted_r(6, k_true)
    rough_r = Poly3CorrectionModel()
    rough_r._k1 = k_true * 1.4
    fine_r, fine_b = TG.refine_ca_models_gradient(frame, rough_r, Poly3CorrectionModel(),
                                                  steps=80, learning_rate=1e-3)
    assert isinstance(fine_r, Poly3CorrectionModel)
    assert abs(float(fine_r.get_coefficients()[0]) - k_true) < abs(k_true * 0.4)
    assert float(rough_r.get_coefficients()[0]) == k_true * 1.4


def test_frame_level_fit_recovers_r_channel_model():
    k_true = 0.02
    frame = _frame_with_distorted_r(3, k_true)
    model_r, model_b = TG.fit_ca_models_gradient(frame, steps=120)
    assert abs(float(model_r.get_coefficients()[0]) - k_true) < 0.5 * k_true
    assert abs(float(model_b.get_coefficients()[0])) < 0.35 * k_true
    rs = torch.linspace(0.05, 1.0, 64)
    assert (model_r.get_distorted(model_r.estimate_undistorted(rs)) - rs).abs().max() < 1e-4


def test_planes_follow_the_tensor_given():
    """NumPy planes beside a CPU tensor land on its device; the fit returns
    float64 NumPy coefficients and a float loss."""
    scene = _smooth_scene(48, 64, seed=7)
    theta, loss = TG.fit_radial_gradient(_distort(scene, 0.01), scene, "poly3", steps=2)
    assert theta.dtype == np.float64 and isinstance(loss, float)
