"""The port's examples against the JAX package's, on the CPU:
``examples/differentiable_isp_torch.py`` against
``examples/differentiable_isp.py`` and ``examples/full_pipeline_torch.py``
against ``examples/full_pipeline.py``, the JAX side op by op
(``jax.disable_jit``).

Tolerances:
- the scene: within 1e-6 (the same cubic weights, summed in float64 here and
  in float32 by JAX; measured 6e-8);
- the loss and its gradient at the initial parameters: within 1e-4 relative,
  the bound this repo holds the Adam fits to against ``optax`` (ROADMAP.md,
  queue C, "Not faults"; measured 2e-7 on the loss);
- the fit: the recovery gates of ``tests/test_differentiable_isp.py``;
- the full pipeline: the same DNG bytes, >= 50 dB on the PNG (the AHD
  tie-flip floor of DIVERGENCES.md; measured 88.3 dB) and R's fitted k1 within
  1e-3 relative, as ``tests/test_torch_ca.py`` holds the template fit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import differentiable_isp as jax_isp
from examples import differentiable_isp_torch as isp
from examples import full_pipeline as jax_full_pipeline
from examples import full_pipeline_torch
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu_torch import RawFrame, develop
from pysp_tpu_torch.utils.testing import psnr, read_png

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4
FIT_RTOL = 1e-3
MIN_PSNR = 50.0


def _small_frames():
    bayer, neutral_true = jax_isp.make_scene(128, 160, seed=1)
    ones = np.ones(3, np.float32)
    return (RawFrame.synthetic(bayer, wb_neutral=ones, device="cpu"),
            JaxFrame.synthetic(bayer, wb_neutral=ones), neutral_true)


@pytest.mark.parametrize("shape,seed", [((128, 160), 1), ((256, 320), 0)])
def test_scene_matches_the_jax_scene(shape, seed):
    got, got_neutral = isp.make_scene(*shape, seed=seed)
    want, want_neutral = jax_isp.make_scene(*shape, seed=seed)
    assert got.shape == want.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_neutral, want_neutral)


def test_loss_and_gradient_match_jax_value_and_grad():
    frame, jax_frame, _ = _small_frames()
    params = {k: v.requires_grad_() for k, v in isp.initial_params("cpu").items()}
    loss = isp.loss_fn(params, frame)
    loss.backward()
    p0 = {"log_gain": jnp.zeros(()), "neutral_rb": jnp.array([1.0, 1.0])}
    with jax.disable_jit():
        want, grads = jax.value_and_grad(jax_isp.loss_fn)(p0, jax_frame)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    for k in ("log_gain", "neutral_rb"):
        got = params[k].grad.numpy()
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-6
        np.testing.assert_allclose(got, np.asarray(grads[k]), rtol=RTOL, err_msg=k)


def test_gradient_descent_recovers_exposure_and_wb():
    """The gates of ``tests/test_differentiable_isp.py`` on the port."""
    frame, _, neutral_true = _small_frames()
    with torch.no_grad():
        l0 = isp.loss_fn(isp.initial_params("cpu"), frame).item()
    params, loss = isp.fit(frame, steps=80)
    assert loss < 0.05 * l0
    # gray-world pins the R/G ratio exactly on this gray-world scene
    assert abs(float(params["neutral_rb"][0]) - neutral_true[0]) < 0.08
    # the developed image actually sits at the exposure target
    with torch.no_grad():
        out = isp.develop_with_params(params, frame)
    assert abs(float(torch.mean(out[8:-8, 8:-8])) - 0.5) < 0.05


def test_grad_wrt_bayer_exists():
    """The photosites themselves are differentiable inputs."""
    frame, _, _ = _small_frames()
    bayer = frame.bayer.clone().requires_grad_()
    torch.mean(develop(frame.replace(bayer=bayer), isp.CFG) ** 2).backward()
    g = bayer.grad
    assert g.shape == frame.bayer.shape
    assert torch.isfinite(g).all() and g.abs().max().item() > 0.0


def test_the_differentiable_example_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "examples.differentiable_isp_torch", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert "recovered neutral R=" in proc.stdout


def _recording_fit(monkeypatch, module):
    """Record the CA models that ``module``'s pipeline fits."""
    fitted = []
    fit = module.compute_ca_lens_models_for_raw

    def recording(*args, **kw):
        fitted.append(fit(*args, **kw))
        return fitted[-1]

    monkeypatch.setattr(module, "compute_ca_lens_models_for_raw", recording)
    return fitted


def test_full_pipeline_matches_the_jax_example(tmp_path, monkeypatch):
    """Both examples' ``main`` at 256x256: the same burst files, the same
    image within the tie-flip floor, the same CA fit."""
    got_fit = _recording_fit(monkeypatch, full_pipeline_torch)
    want_fit = _recording_fit(monkeypatch, jax_full_pipeline)
    out = full_pipeline_torch.main(str(tmp_path / "torch"), device="cpu")
    with jax.disable_jit():
        want_out = jax_full_pipeline.main(str(tmp_path / "jax"))

    for i in range(3):
        name = f"burst_{i}.dng"
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = read_png(Path(out).read_bytes())
    want = read_png(Path(want_out).read_bytes())
    assert got.shape == want.shape == (256, 256, 3)
    assert psnr(got.astype(np.float64) / 255, want.astype(np.float64) / 255) >= MIN_PSNR
    (got_models,), (want_models,) = got_fit, want_fit
    for g, w in zip(got_models, want_models):
        assert type(g).__name__ == type(w).__name__
        np.testing.assert_allclose(g.get_coefficients(), w.get_coefficients(),
                                   rtol=FIT_RTOL, atol=0)
    assert 0.02 < got_models[0].get_coefficients()[0] < 0.08


def test_full_pipeline_run_returns_the_saved_image(tmp_path):
    paths, vignette = full_pipeline_torch.make_burst(str(tmp_path))
    srgb, model_r = full_pipeline_torch.run(paths, vignette, str(tmp_path / "o.png"),
                                            device="cpu")
    png = read_png((tmp_path / "o.png").read_bytes())
    assert srgb.shape == png.shape == (256, 256, 3)
    np.testing.assert_array_equal(
        png, np.clip(srgb.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8))
    assert model_r.get_coefficients()[0] > 0


def test_the_full_pipeline_example_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "examples.full_pipeline_torch", str(tmp_path), "--device",
         "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert read_png((tmp_path / "developed.png").read_bytes()).shape == (256, 256, 3)


def test_the_examples_default_to_the_card(tmp_path):
    """Without a device both examples run on the card; with no GPU they raise."""
    if torch.cuda.is_available():
        assert isp.main()["frame"].bayer.is_cuda
        assert os.path.exists(full_pipeline_torch.main(str(tmp_path)))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isp.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_pipeline_torch.main(str(tmp_path))
