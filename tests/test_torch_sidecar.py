"""Develop-parameter sidecars, WB from a colour temperature, and the CLI flags
that use them (``--save-params``, ``--params``, ``--hdr --params``,
``--temperature``) in pysp_tpu_torch, against pysp_tpu.

Tolerances (measured beside each):

- sidecars: a JAX-written file loads in the port and a port-written one in
  JAX, with the same models and values, and the two packages write the same
  bytes; a negative Poly3 k1 survives;
- ``controller_for_source`` + ``update_by_temperature`` + ``frame_from_parts``:
  ``cam_mat``, ``cam_white`` and ``wb_neutral`` within 1e-6 of JAX's (the
  same float64 NumPy, then float32: measured equal);
- the CLI on the CPU: ``--save-params`` then ``--params`` writes the same TIFF
  bit for bit; every branch >= 50 dB against the same chain composed from the
  JAX package's functions run op by op, the AHD tie-flip floor of
  DIVERGENCES.md.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu.correct.ca import models as JMod
from pysp_tpu.correct.ca.removal import remove_ca_from_raw as jax_remove_ca
from pysp_tpu.io import raw_loader as JL
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop as jax_develop
from pysp_tpu.pipeline.pipeline import PipelineConfig as JaxPipelineConfig
from pysp_tpu.pipeline.pipeline import develop_pipeline as jax_develop_pipeline
from pysp_tpu.utils import sidecar as JSide
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.correct.ca import models as TMod
from pysp_tpu_torch.io import raw_loader as TL
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.io.image_out import to_uint16
from pysp_tpu_torch.utils import sidecar as TSide
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

torch.set_num_threads(1)

MIN_PSNR = 50.0
FIELD_ATOL = 1e-6
PORT_MODELS = [
    TMod.Poly3CorrectionModel(0.012),
    # NEGATIVE k1: real CA fits routinely produce it (one of R/B scales below G)
    TMod.Poly3CorrectionModel(-0.006),
    TMod.Poly5CorrectionModel(0.01, -0.004),
    TMod.PtLensCorrectionModel(0.008, -0.015, 0.01),
]


def _jax_twin(model):
    return getattr(JMod, type(model).__name__)(*model.get_coefficients())


# --- sidecars ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", PORT_MODELS, ids=lambda m: type(m).__name__)
def test_ca_model_round_trip(model):
    d = TSide.ca_model_to_dict(model)
    assert d == JSide.ca_model_to_dict(_jax_twin(model))
    back = TSide.ca_model_from_dict(d)
    assert type(back) is type(model)
    np.testing.assert_array_equal(back.get_coefficients(), model.get_coefficients())


def test_poly3_negative_k1_survives_constructor():
    m = TMod.Poly3CorrectionModel(-0.006)
    assert float(m.get_coefficients()[0]) == -0.006
    r = torch.linspace(0.05, 1.0, 64)
    rd = m.get_distorted(r)
    assert bool((torch.diff(rd) > 0).all())
    np.testing.assert_allclose(m.estimate_undistorted(rd).numpy(), r.numpy(), atol=1e-5)


SIDECARS = {
    "full": dict(model_r=0, model_b=1, wb=(0.48, 1.0, 0.66), temperature=5200.0,
                 extra={"note": "fit on frame 0"}),
    "ca_only": dict(model_r=2, model_b=None, wb=None, temperature=None, extra=None),
    "wb_only": dict(model_r=None, model_b=None, wb=(0.51, 1.0, 0.7), temperature=None,
                    extra=None),
    "b_ptlens": dict(model_r=None, model_b=3, wb=None, temperature=6500.0, extra=None),
}


def _save(save, models, case, path):
    spec = SIDECARS[case]
    return save(str(path),
                ca_model_r=None if spec["model_r"] is None else models[spec["model_r"]],
                ca_model_b=None if spec["model_b"] is None else models[spec["model_b"]],
                wb_neutral=None if spec["wb"] is None else np.asarray(spec["wb"]),
                temperature=spec["temperature"], extra=spec["extra"])


def _same_loaded(a, b):
    for key in ("ca_model_r", "ca_model_b"):
        assert (a[key] is None) == (b[key] is None)
        if a[key] is not None:
            assert type(a[key]).__name__ == type(b[key]).__name__
            np.testing.assert_array_equal(a[key].get_coefficients(), b[key].get_coefficients())
    assert (a["wb_neutral"] is None) == (b["wb_neutral"] is None)
    if a["wb_neutral"] is not None:
        np.testing.assert_array_equal(a["wb_neutral"], b["wb_neutral"])
    assert a["temperature_k"] == b["temperature_k"] and a["extra"] == b["extra"]


@pytest.mark.parametrize("case", list(SIDECARS))
def test_sidecars_cross_load(case, tmp_path):
    """JAX-written loads in the port, port-written loads in JAX, same bytes."""
    jax_models = [_jax_twin(m) for m in PORT_MODELS]
    _save(JSide.save_sidecar, jax_models, case, tmp_path / "jax.json")
    _save(TSide.save_sidecar, PORT_MODELS, case, tmp_path / "port.json")
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    in_port = TSide.load_sidecar(str(tmp_path / "jax.json"))
    in_jax = JSide.load_sidecar(str(tmp_path / "port.json"))
    for key in ("ca_model_r", "ca_model_b"):
        if in_port[key] is not None:
            assert isinstance(in_port[key], TMod.CaCorrectionModel)
            assert isinstance(in_jax[key], JMod.CaCorrectionModel)
    _same_loaded(in_port, in_jax)
    _same_loaded(in_port, TSide.load_sidecar(str(tmp_path / "port.json")))
    assert TSide.fitted_models_tuple(in_port) == (in_port["ca_model_r"], in_port["ca_model_b"])


def test_load_rejects_foreign_json(tmp_path):
    p = tmp_path / "other.json"
    p.write_text(json.dumps({"hello": 1}))
    with pytest.raises(ValueError, match="sidecar"):
        TSide.load_sidecar(str(p))
    p.write_text(json.dumps({"pysp_tpu_sidecar": 1, "ca": {"model_r": {"type": "Nope",
                                                                      "coefficients": []}}}))
    with pytest.raises(ValueError, match="unknown CA model type"):
        TSide.load_sidecar(str(p))
    with pytest.raises(ValueError, match="unsupported CA model type"):
        TSide.ca_model_to_dict(object())


# --- WB from a colour temperature ---------------------------------------------------------


def _dng(path, h=96, w=128, seed=3, pattern=(0, 1, 1, 2), **tags):
    u16 = (200 + mosaic_rggb(make_scene(h, w, seed=seed)) * 3800).astype(np.uint16)
    path.write_bytes(T.write_synthetic_dng(u16, cfa_pattern=pattern, **tags))
    return path


@pytest.mark.parametrize("temperature", [2900.0, 5000.0, 7500.0])
@pytest.mark.parametrize("pattern", [(0, 1, 1, 2), (2, 1, 1, 0)], ids=["rggb", "bggr"])
def test_frame_at_temperature_matches_jax(tmp_path, temperature, pattern):
    """Measured: the three fields equal."""
    path = str(_dng(tmp_path / "shot.dng", pattern=pattern))
    frame = TL.load_raw(path, device="cpu")
    ctrl = TL.controller_for_source(path, frame)
    ctrl.update_by_temperature(temperature, allow_cross_blend=True)
    from pysp_tpu_torch.core.bayer import reversible_transform_rggb

    sensor = reversible_transform_rggb(frame.bayer, frame.source_pattern).numpy()
    got = TL.frame_from_parts(sensor, frame.source_pattern, ctrl, float(frame.ev),
                              device="cpu")

    jframe = JL.load_raw(path)
    jctrl = JL.controller_for_source(path, jframe)
    jctrl.update_by_temperature(temperature, allow_cross_blend=True)
    from pysp_tpu.core.bayer import reversible_transform_rggb as jax_rtr

    jsensor = np.asarray(jax_rtr(jframe.bayer, jframe.source_pattern))
    want = JL.frame_from_parts(jsensor, jframe.source_pattern, jctrl, float(jframe.ev))
    for key in ("cam_mat", "cam_white", "wb_neutral"):
        diff = np.abs(getattr(got, key).numpy() - np.asarray(getattr(want, key))).max()
        print(f"{key}: {diff:.3g} apart")
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   rtol=0, atol=FIELD_ATOL)
    np.testing.assert_array_equal(got.bayer.numpy(), np.asarray(want.bayer))
    assert not np.allclose(got.wb_neutral.numpy(), frame.wb_neutral.numpy())


def test_controller_without_exif_matrices_uses_the_frames(tmp_path):
    """A source with no EXIF matrices (here: not a TIFF) falls through to the
    frame's single matrix and neutral, as the JAX package does when its
    registry knows no matrix."""
    path = str(_dng(tmp_path / "shot.dng"))
    frame = TL.load_raw(path, device="cpu")
    jframe = JL.load_raw(path)
    ctrl = TL.controller_for_source(b"not a tiff", frame)
    jctrl = JL.controller_for_source(b"not a tiff", jframe)
    np.testing.assert_array_equal(ctrl.get_neutral(), jctrl.get_neutral())
    np.testing.assert_allclose(ctrl.get_neutral(), frame.wb_neutral.numpy(), rtol=1e-7)
    ctrl.update_by_temperature(5000.0, allow_cross_blend=True)
    jctrl.update_by_temperature(5000.0, allow_cross_blend=True)
    np.testing.assert_allclose(ctrl.get_matrix().mat, jctrl.get_matrix().mat, rtol=0,
                               atol=FIELD_ATOL)
    np.testing.assert_allclose(ctrl.get_neutral(), jctrl.get_neutral(), rtol=0,
                               atol=FIELD_ATOL)


# --- the CLI -------------------------------------------------------------------------------


def _read_rgb16(path) -> np.ndarray:
    tf = T.read_tiff(str(path))
    ifd = tf.ifds[0]
    h = ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    w = ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    (offset,) = ifd.require(T.TAG_STRIP_OFFSETS).as_ints()
    data = np.frombuffer(tf.data, dtype=tf.endian + "u2", count=h * w * 3, offset=offset)
    return data.reshape(h, w, 3)


def _close(got_path, img):
    got = _read_rgb16(got_path).astype(np.float64) / 65535
    want = to_uint16(np.asarray(img)).astype(np.float64) / 65535
    assert got.shape == want.shape
    assert psnr(got, want) >= MIN_PSNR


def test_cli_temperature_matches_the_jax_chain(tmp_path):
    path = _dng(tmp_path / "shot.dng")
    out = tmp_path / "t.tif"
    assert main(["develop", str(path), "-o", str(out), "--device", "cpu",
                 "--quality", "fast", "--temperature", "5000"]) == 0
    with jax.disable_jit():
        frame = JL.load_raw(str(path))
        ctrl = JL.controller_for_source(str(path), frame)
        ctrl.update_by_temperature(5000.0, allow_cross_blend=True)
        frame = JL.frame_from_parts(np.asarray(frame.bayer), frame.source_pattern, ctrl,
                                    float(frame.ev))
        img = jax_develop(frame, JaxConfig(quality=JaxQuality.Fast))
    _close(out, img)


def test_cli_params_from_a_jax_sidecar_matches_the_jax_chain(tmp_path):
    """A sidecar written by the JAX package (CA models, WB neutral) applied by
    the port's ``--params``, against the JAX CLI's chain."""
    path = _dng(tmp_path / "shot.dng")
    params = tmp_path / "p.json"
    model_r, model_b = JMod.Poly3CorrectionModel(0.01), JMod.Poly3CorrectionModel(-0.006)
    wb = np.array([0.48, 1.0, 0.66])
    JSide.save_sidecar(str(params), ca_model_r=model_r, ca_model_b=model_b, wb_neutral=wb)
    out = tmp_path / "p.tif"
    assert main(["develop", str(path), "-o", str(out), "--device", "cpu", "--params",
                 str(params)]) == 0
    with jax.disable_jit():
        frame = JL.load_raw(str(path))
        frame = frame.replace(wb_neutral=jnp.asarray(wb, jnp.float32))
        img = jax_develop(jax_remove_ca(frame, model_r, model_b), JaxConfig())
    _close(out, img)


@pytest.mark.parametrize("mode", ["gradient", "template"])
def test_cli_save_params_then_params_writes_the_same_tiff(tmp_path, mode):
    """``--ca MODE --save-params`` then ``--params``: the same TIFF bit for bit
    (the fit's models go through their JSON form before they are applied), and
    the sidecar loads in the JAX package."""
    from pysp_tpu_torch.utils.testing import ring_chart

    img = ring_chart(256, 384, radii=(58, 84, 104), amp=0.6, base=0.1) + 0.1
    u16 = (200 + mosaic_rggb(np.dstack([img] * 3)) * 3800).astype(np.uint16)
    path = tmp_path / "rings.dng"
    path.write_bytes(T.write_synthetic_dng(u16))
    params, fit, replay = tmp_path / "fit.json", tmp_path / "fit.tif", tmp_path / "replay.tif"
    common = ["--device", "cpu", "--quality", "draft"]
    assert main(["develop", str(path), "-o", str(fit), *common, "--ca", mode,
                 "--save-params", str(params)]) == 0
    saved = JSide.load_sidecar(str(params))
    assert saved["ca_model_r"] is not None and saved["ca_model_b"] is not None
    assert saved["wb_neutral"] is not None and saved["temperature_k"] is None
    assert main(["develop", str(path), "-o", str(replay), *common, "--params",
                 str(params)]) == 0
    assert fit.read_bytes() == replay.read_bytes()


def test_cli_params_replays_the_temperature(tmp_path):
    """A sidecar's ``temperature_k`` goes through the ``--temperature`` branch."""
    path = _dng(tmp_path / "shot.dng")
    params = tmp_path / "t.json"
    TSide.save_sidecar(str(params), temperature=6100.0)
    a, b = tmp_path / "a.tif", tmp_path / "b.tif"
    common = ["--device", "cpu", "--quality", "draft"]
    assert main(["develop", str(path), "-o", str(a), *common, "--temperature", "6100"]) == 0
    assert main(["develop", str(path), "-o", str(b), *common, "--params", str(params)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_cli_hdr_params_matches_the_jax_chain(tmp_path):
    """``--hdr --params``: the sidecar's WB and CA applied to every bracket
    before the fuse, against the JAX CLI's chain."""
    inputs = []
    for k in range(3):
        u16 = (200 + np.clip(mosaic_rggb(make_scene(96, 128, seed=3)) * 2.0 ** (k - 1), 0, 1)
               * 3800).astype(np.uint16)
        p = tmp_path / f"b{k}.dng"
        p.write_bytes(T.write_synthetic_dng(u16, exposure_time=(1, 200 // 2 ** k)))
        inputs.append(p)
    params = tmp_path / "p.json"
    model_r, model_b = TMod.Poly5CorrectionModel(0.01, -0.003), TMod.Poly3CorrectionModel(-0.008)
    wb = np.array([0.5, 1.0, 0.62])
    TSide.save_sidecar(str(params), ca_model_r=model_r, ca_model_b=model_b, wb_neutral=wb)
    out = tmp_path / "hdr.tif"
    assert main(["develop", *map(str, inputs), "--hdr", "-o", str(out), "--device", "cpu",
                 "--params", str(params), "--save-params", str(tmp_path / "x.json")]) == 0
    assert not (tmp_path / "x.json").exists()

    loaded = JSide.load_sidecar(str(params))
    with jax.disable_jit():
        frames = [JL.load_raw(str(p)) for p in inputs]
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
        batch = batch.replace(wb_neutral=jnp.broadcast_to(
            jnp.asarray(wb, jnp.float32), batch.wb_neutral.shape))
        batch = jax_remove_ca(batch, loaded["ca_model_r"], loaded["ca_model_b"])
        img = jax_develop_pipeline(batch, JaxPipelineConfig(fuse_hdr=True))
    _close(out, img)
