"""The port's examples against the JAX package's, on the CPU:
``examples/differentiable_isp_torch.py`` against
``examples/differentiable_isp.py`` and ``examples/full_pipeline_torch.py``
against ``examples/full_pipeline.py``, the JAX side op by op
(``jax.disable_jit``); ``examples/burst_production_torch.py`` and
``examples/large_frame_sharded_torch.py`` on a mesh of four CPU shards
against ``examples/burst_production.py`` and ``examples/large_frame_sharded.py``
on four of tests/conftest.py's virtual devices, jitted (as the JAX sharded
functions run).

Tolerances:
- the scene: within 1e-6 (the same cubic weights, summed in float64 here and
  in float32 by JAX; measured 6e-8);
- the loss and its gradient at the initial parameters: within 1e-4 relative,
  the bound this repo holds the Adam fits to against ``optax`` (ROADMAP.md,
  queue C, "Not faults"; measured 2e-7 on the loss);
- the fit: the recovery gates of ``tests/test_differentiable_isp.py``;
- the full pipeline: the same DNG bytes, >= 50 dB on the PNG (the AHD
  tie-flip floor of DIVERGENCES.md; measured 88.3 dB) and R's fitted k1 within
  1e-3 relative, as ``tests/test_torch_ca.py`` holds the template fit;
- the burst: both run on the JAX example's files (the port's own hold the
  same counts but at under 0.1% of the sites, one count apart: the baked CA
  truncates a float32 value 2.4e-7 from JAX's), the CA models within 1e-3
  relative (the JAX example's gradient fit taken in the port's direction, G
  onto the channel: ROADMAP.md queue C, C4), >= 50 dB on each PNG (measured
  90.8 dB to identical);
- the large frame: the same DNG bytes, >= 40 dB between the two sharded Best
  develops (JAX's jitted Best is 41 dB from op by op, ROADMAP.md), and each
  example's own interior check against its monolithic pipeline.
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

from examples import burst_production as jax_burst
from examples import burst_production_torch
from examples import differentiable_isp as jax_isp
from examples import differentiable_isp_torch as isp
from examples import full_pipeline as jax_full_pipeline
from examples import full_pipeline_torch
from examples import large_frame_sharded as jax_large_frame
from examples import large_frame_sharded_torch
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu_torch import RawFrame, develop
from pysp_tpu_torch.utils.testing import psnr, read_png

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4
FIT_RTOL = 1e-3
MIN_PSNR = 50.0
BEST_MIN_PSNR = 40.0
SHARDS = ["cpu"] * 4


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


def test_the_sharded_examples_default_to_the_card(tmp_path):
    """Without devices the sharded examples take the visible cards (one card:
    a (1, 1) mesh); with no GPU they raise."""
    if torch.cuda.is_available():
        assert burst_production_torch.main(str(tmp_path)).is_cuda
        assert large_frame_sharded_torch.main()[0].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        burst_production_torch.main(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        large_frame_sharded_torch.main()


def _jax_fit_in_the_ports_direction(frame, steps=80, learning_rate=2e-3):
    """The JAX package's Poly3 gradient fit of the mean G plane onto each of
    R and B, the direction of the port's ``fit_ca_models_gradient`` (the JAX
    function aligns the channel onto G and fits the inverse model: C4)."""
    from pysp_tpu.core.bayer import bayer_to_rgbg
    from pysp_tpu.correct.ca import gradfit as JG

    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    return tuple(JG._make_poly3(JG.fit_radial_gradient(
        g, plane, "poly3", np.zeros(1, np.float32), steps=steps,
        learning_rate=learning_rate)[0]) for plane in (r0, b0))


def _recording(monkeypatch, owner, name, fn=None):
    """Record what ``owner.name`` (or ``fn`` in its place) returns."""
    seen = []
    call = fn or getattr(owner, name)

    def recording(*args, **kw):
        seen.append(call(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(owner, name, recording)
    return seen


def test_burst_production_matches_the_jax_example(tmp_path, monkeypatch):
    """Both examples' ``main`` with a four-shard batch mesh on the JAX
    example's burst files: the same CA fit, the same PNGs within the stated
    floor. The port's own burst files hold the same counts but where the
    truncation of the baked CA (float32, 2.4e-7 from JAX's) crosses an
    integer: there one count apart, on under 0.1% of the sites."""
    import shutil
    import tempfile

    from pysp_tpu_torch import load_raw

    jax_dir, own_dir, run_dir = tmp_path / "jax", tmp_path / "own", tmp_path / "torch"
    for d in (jax_dir, own_dir, run_dir):
        d.mkdir()
    want_fit = _recording(monkeypatch, jax_burst, "fit_ca_models_gradient",
                          _jax_fit_in_the_ports_direction)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(jax_dir))
    jax_burst.main()

    own = burst_production_torch.make_burst(str(own_dir))
    for path in own:
        a = load_raw(path, device="cpu").bayer
        b = load_raw(str(jax_dir / Path(path).name), device="cpu").bayer
        off = (a - b).abs() * (4095 - 256)
        assert off.max().item() <= 1.0 + 1e-3 and (off > 0.5).float().mean().item() < 1e-3

    def jax_files(tmpdir, n=4, h=96, w=128):
        return [shutil.copy(jax_dir / f"burst_{i:02d}.dng", tmpdir) for i in range(n)]

    monkeypatch.setattr(burst_production_torch, "make_burst", jax_files)
    got_fit = _recording(monkeypatch, burst_production_torch, "fit_ca_models_gradient")
    out = burst_production_torch.main(str(run_dir), device="cpu", devices=SHARDS)
    assert out.shape == (4, 96, 128, 3)
    (got_models,), (want_models,) = got_fit, want_fit
    for g, w in zip(got_models, want_models):
        np.testing.assert_allclose(g.get_coefficients(), w.get_coefficients(),
                                   rtol=FIT_RTOL, atol=0)
    for i in range(4):
        got = read_png((run_dir / f"out_{i:02d}.png").read_bytes())
        want = read_png((jax_dir / f"out_{i:02d}.png").read_bytes())
        p = psnr(got.astype(np.float64) / 255, want.astype(np.float64) / 255)
        print(f"burst frame {i}: PNG {p:.2f} dB from the JAX example's")
        assert p >= MIN_PSNR


def test_large_frame_sharded_matches_the_jax_example(monkeypatch):
    """Both examples' ``main`` on four spatial shards: the same DNG, each
    example's interior check, and the two sharded develops within the Best
    gate."""
    import pysp_tpu.io.tiff as jax_tiff
    import pysp_tpu.parallel.spatial_pipeline as jax_spatial
    import pysp_tpu_torch.io.tiff as tiff

    got_dng = _recording(monkeypatch, tiff, "write_synthetic_dng")
    want_dng = _recording(monkeypatch, jax_tiff, "write_synthetic_dng")
    want_out = _recording(monkeypatch, jax_spatial, "develop_frame_spatial")
    out, err = large_frame_sharded_torch.main("cpu", SHARDS)
    jax_large_frame.main()

    assert got_dng == want_dng
    assert out.shape == (512, 96, 3) and err <= large_frame_sharded_torch.ATOL
    p = psnr(out.numpy(), np.asarray(want_out[0]))
    print(f"large frame: the port's sharded develop {p:.2f} dB from the JAX example's")
    assert p >= BEST_MIN_PSNR


def test_the_sharded_examples_run_as_modules(tmp_path, monkeypatch, capsys):
    """Each as a script, run in this process (``runpy``) with two CPU shards."""
    import runpy

    for args in (["burst_production_torch", str(tmp_path), "--device", "cpu", "--shards", "2"],
                 ["large_frame_sharded_torch", "--device", "cpu", "--shards", "2"]):
        monkeypatch.setattr(sys, "argv", args)
        runpy.run_path(str(REPO / "examples" / f"{args[0]}.py"), run_name="__main__")
    assert len(list(tmp_path.glob("out_*.png"))) == 4
    out = capsys.readouterr().out
    assert "on a 2-shard mesh" in out and "over 2 spatial shards" in out and "OK" in out
