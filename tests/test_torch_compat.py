"""pysp_tpu_torch.compat, the reference-name class API, against
pysp_tpu.compat on the same files and arrays: the seven cases of
``tests/test_compat.py``, each held against the JAX class.

The JAX classes run op by op (``jax.disable_jit``). Tolerances: the Best
demosaic at ``test_torch_develop.py``'s 50 dB (the AHD tie-flip floor) and
Fast and Draft within ``test_torch_tiers.py``'s 1e-6 (linear camera RGB)."""
import sys
import types

import jax
import numpy as np
import pytest
import torch

from pysp_tpu import compat as jax_compat
from pysp_tpu.const import BayerPattern as JaxPattern
from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu_torch import compat
from pysp_tpu_torch.const import BayerPattern, QualityDemosaic
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

torch.set_num_threads(1)

MIN_PSNR = 50.0
ATOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _controllers(scales):
    """The same dual-illuminant WB controller in both packages."""
    from pysp_tpu.colorimetry import illuminants as jax_ill
    from pysp_tpu.colorimetry import spaces as jax_spaces
    from pysp_tpu.colorimetry import wb as jax_wb
    from pysp_tpu_torch.colorimetry import illuminants, spaces, wb

    xys = [(0.3457, 0.3585), (0.31272, 0.32903)]
    neutral = np.array([0.5, 1.0, 0.7])
    ours = wb.CameraWhiteBalanceController(
        [spaces.MatXyzToCamera(np.eye(3) * s, illuminants.xy_to_xyz(xy),
                               illuminants.StandardIlluminantSeries.SERIES_DAYLIGHT)
         for s, xy in zip(scales, xys)], neutral)
    theirs = jax_wb.CameraWhiteBalanceController(
        [jax_spaces.MatXyzToCamera(np.eye(3) * s, jax_ill.xy_to_xyz(xy),
                                   jax_ill.StandardIlluminantSeries.SERIES_DAYLIGHT)
         for s, xy in zip(scales, xys)], neutral)
    return ours, theirs


def test_readme_flow_from_synthetic_dng():
    """The reference README pipeline (README.md:55-63) on one synthetic DNG."""
    rng = np.random.default_rng(0)
    blob = T.write_synthetic_dng(rng.integers(300, 3900, (64, 64)).astype(np.uint16))

    image = compat.RawBayerDataFromRaw(blob, device="cpu")
    ref = jax_compat.RawBayerDataFromRaw(blob)
    assert image.sensor_pattern == BayerPattern.Rggb
    assert image.current_ev == ref.current_ev and np.isfinite(image.current_ev)
    np.testing.assert_array_equal(_np(image.sensor_scaled), _np(ref.sensor_scaled))

    dem = image.demosaic(QualityDemosaic.Best)
    assert isinstance(dem, compat.RawDemosaicData) and dem.is_valid()
    srgb = _np(compat.lin_srgb_to_srgb(dem.to_lin_srgb()))
    with jax.disable_jit():
        want = _np(jax_compat.lin_srgb_to_srgb(
            ref.demosaic(JaxQuality.Best).to_lin_srgb()))
    assert srgb.shape == want.shape == (64, 64, 3)
    assert srgb.min() >= 0 and srgb.max() <= 1
    assert psnr(srgb, want) >= MIN_PSNR


def test_readme_flow_against_the_ports_develop():
    """The class API's Best image against ``develop`` of the same file: the
    same plain AHD and colour tail, within the tail's rounding."""
    from pysp_tpu_torch import develop, load_raw

    blob = T.write_synthetic_dng(
        (200 + mosaic_rggb(make_scene(64, 80, seed=5)) * 3800).astype(np.uint16))
    dem = compat.RawBayerDataFromRaw(blob, device="cpu").demosaic(QualityDemosaic.Best)
    got = compat.lin_srgb_to_srgb(dem.to_lin_srgb())
    want = develop(load_raw(blob, device="cpu"))
    assert (got - want).abs().max().item() <= 12.92 * ATOL


def test_wb_controller_accessible_for_retemperature():
    rng = np.random.default_rng(1)
    blob = T.write_synthetic_dng(rng.integers(300, 3900, (32, 32)).astype(np.uint16))
    image = compat.RawBayerDataFromRaw(blob, device="cpu")
    ref = jax_compat.RawBayerDataFromRaw(blob)

    before = np.asarray(image.cam_wb.get_reciprocal_multipliers())
    image.cam_wb.update_by_temperature(6500, allow_cross_blend=True)
    ref.cam_wb.update_by_temperature(6500, allow_cross_blend=True)
    after = np.asarray(image.cam_wb.get_reciprocal_multipliers())
    assert not np.allclose(before, after)
    np.testing.assert_array_equal(after, np.asarray(ref.cam_wb.get_reciprocal_multipliers()))

    # re-demosaic picks up the new WB
    dem = image.demosaic(QualityDemosaic.Draft)
    assert dem.is_valid()
    with jax.disable_jit():
        want = _np(ref.demosaic(JaxQuality.Draft).image)
    assert np.abs(_np(dem.image) - want).max() <= ATOL


def test_wb_undo_apply_cycle():
    bayer = mosaic_rggb(make_scene(32, 32))
    ctrl, jax_ctrl = _controllers((1.1, 0.95))
    dem = compat.RawRggbBayerData(bayer, ctrl, shot_ev=10.0, device="cpu").demosaic(
        QualityDemosaic.Fast)
    with jax.disable_jit():
        ref = jax_compat.RawRggbBayerData(bayer, jax_ctrl, shot_ev=10.0).demosaic(
            JaxQuality.Fast)

    img_before = _np(dem.image)
    assert np.abs(img_before - _np(ref.image)).max() <= ATOL
    dem.wb_undo()
    ref.wb_undo()
    assert not np.allclose(_np(dem.image), img_before)
    assert np.abs(_np(dem.image) - _np(ref.image)).max() <= ATOL
    dem.wb_apply()
    np.testing.assert_allclose(_np(dem.image), img_before, rtol=1e-5)
    lin = _np(dem.to_lin_srgb())
    with jax.disable_jit():
        ref.wb_apply()
        want = _np(ref.to_lin_srgb())
    assert np.abs(lin - want).max() <= ATOL


def test_pattern_roundtrip_through_compat():
    bayer = mosaic_rggb(make_scene(32, 32))
    ctrl, jax_ctrl = _controllers((1.0, 1.0))

    # the same canonical content behind a BGGR wrapper: the output flips back
    rggb = compat.RawBayerData(bayer, ctrl, 10.0, sensor_pattern=BayerPattern.Rggb,
                               device="cpu")
    bggr = compat.RawBayerData(bayer[::-1, ::-1].copy(), ctrl.copy(), 10.0,
                               sensor_pattern=BayerPattern.Bggr, device="cpu")
    out_rggb = _np(rggb.demosaic(QualityDemosaic.Draft).image)
    out_bggr = _np(bggr.demosaic(QualityDemosaic.Draft).image)
    np.testing.assert_allclose(out_bggr, out_rggb[::-1, ::-1], atol=1e-6)

    jax_bggr = jax_compat.RawBayerData(bayer[::-1, ::-1].copy(), jax_ctrl.copy(), 10.0,
                                       sensor_pattern=JaxPattern.Bggr)
    with jax.disable_jit():
        want = _np(jax_bggr.demosaic(JaxQuality.Draft).image)
    assert np.abs(out_bggr - want).max() <= ATOL
    rg = bggr.to_rggb()
    assert isinstance(rg, compat.RawRggbBayerData) and rg.source_pattern == BayerPattern.Bggr
    np.testing.assert_array_equal(_np(rg.sensor_scaled),
                                  _np(jax_bggr.to_rggb().sensor_scaled))


def _fake_rawpy(bayer):
    class FakeRaw:
        raw_image = bayer
        black_level_per_channel = [256, 256, 256, 256]
        camera_white_level_per_channel = [4095] * 4
        raw_pattern = np.array([[0, 1], [3, 2]])
        color_desc = b"RGBG"
        daylight_whitebalance = (2.0, 1.0, 1.5, 0.0)

        def postprocess(self, **kw):
            assert kw["no_auto_bright"] and kw["use_camera_wb"]
            return np.full((32, 32, 3), 1 << 15, np.uint16)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    fake = types.ModuleType("rawpy")
    fake.imread = lambda reader: FakeRaw()
    fake.DemosaicAlgorithm = types.SimpleNamespace(AHD=1)
    fake.FBDDNoiseReductionMode = types.SimpleNamespace(Full=1)
    fake.ColorSpace = types.SimpleNamespace(raw=1)
    fake.HighlightMode = types.SimpleNamespace(Clip=1)
    return fake


def test_rawpy_loader_paths_with_mock(monkeypatch):
    """The rawpy-gated branches (``load_raw``'s fall-through and
    ``RawDebayerDataFromRaw``, image.py:309-357) against a mock libraw in
    both packages; without rawpy the port raises the JAX ``ValueError``."""
    from pysp_tpu.io import raw_loader as jax_raw_loader
    from pysp_tpu_torch.io import raw_loader

    rng = np.random.default_rng(8)
    bayer = rng.integers(300, 3900, (32, 32)).astype(np.uint16)
    data = T.write_synthetic_dng(bayer)

    if "rawpy" not in sys.modules:
        with pytest.raises(ValueError, match="needs rawpy/libraw"):
            compat.RawDebayerDataFromRaw(data, device="cpu")

    monkeypatch.setitem(sys.modules, "rawpy", _fake_rawpy(bayer))
    # force the fallback: pretend the built-in DNG path cannot read this file
    for module in (raw_loader, jax_raw_loader):
        monkeypatch.setattr(module, "load_raw_dng",
                            lambda src, **kw: (_ for _ in ()).throw(ValueError("forced")))

    frame = raw_loader.load_raw(data, device="cpu")
    want = np.clip(bayer.astype(np.float64) - 256, 0, 4095) / 4095.0
    np.testing.assert_allclose(frame.bayer.numpy(), want.astype(np.float32), atol=1e-6)
    np.testing.assert_array_equal(frame.bayer.numpy(),
                                  np.asarray(jax_raw_loader.load_raw(data).bayer))

    dem = compat.RawDebayerDataFromRaw(data, device="cpu")
    ref = jax_compat.RawDebayerDataFromRaw(data)
    img = _np(dem.image)
    assert img.shape == (32, 32, 3)
    np.testing.assert_allclose(img, (1 << 15) / (2**16 - 1), atol=1e-6)
    np.testing.assert_array_equal(img, _np(ref.image))
    assert dem.current_ev == ref.current_ev and np.isfinite(dem.current_ev)
    np.testing.assert_array_equal(dem.mat_xyz.mat, ref.mat_xyz.mat)
    assert dem.is_valid()


def _check_native_format(data, quality, jax_quality, shape):
    raw = compat.RawBayerDataFromRaw(data, device="cpu")
    ref = jax_compat.RawBayerDataFromRaw(data)
    assert _np(raw.sensor_scaled).shape == shape
    np.testing.assert_array_equal(_np(raw.sensor_scaled), _np(ref.sensor_scaled))
    img = _np(raw.demosaic(quality).to_lin_srgb())
    with jax.disable_jit():
        want = _np(ref.demosaic(jax_quality).to_lin_srgb())
    assert img.shape == shape + (3,) and np.isfinite(img).all()
    assert np.abs(img - want).max() <= ATOL
    return raw, ref


def test_raw_bayer_from_cr2_and_nef():
    """The class API opens the built-in non-DNG formats: no EXIF colour
    matrices there, so the controller falls back to the loader's."""
    from pysp_tpu_torch.io import native
    from pysp_tpu_torch.io.cr2 import write_synthetic_cr2
    from pysp_tpu_torch.io.nef import write_synthetic_nef

    assert native.available()
    rng = np.random.default_rng(12)
    mosaic = rng.integers(100, 16000, (64, 96)).astype(np.uint16)
    for data in (write_synthetic_cr2(mosaic), write_synthetic_nef(mosaic)):
        _check_native_format(data, QualityDemosaic.Fast, JaxQuality.Fast, (64, 96))


def test_class_api_on_rw2_and_orf():
    """The class API (image.py:199-307) opens RW2, ORF and PEF too: the WB
    controller rebuilt from the file, then the demosaic."""
    from pysp_tpu_torch.io.orf import write_synthetic_orf
    from pysp_tpu_torch.io.pef import write_synthetic_pef
    from pysp_tpu_torch.io.rw2 import write_synthetic_rw2

    rng = np.random.default_rng(13)
    vals = np.clip(
        600 + np.cumsum(rng.integers(-20, 21, (32, 56)), axis=1), 30, 4000
    ).astype(np.uint16)
    rw2, _ = write_synthetic_rw2(vals)
    for data in (rw2, write_synthetic_orf(vals), write_synthetic_pef(vals)):
        raw, ref = _check_native_format(data, QualityDemosaic.Fast, JaxQuality.Fast, (32, 56))
        # update_by_* works through the rebuilt controller
        raw.cam_wb.update_by_temperature(5000.0, allow_cross_blend=True)
        ref.cam_wb.update_by_temperature(5000.0, allow_cross_blend=True)
        np.testing.assert_array_equal(raw.cam_wb.get_neutral(), ref.cam_wb.get_neutral())


def test_file_constructors_default_to_the_card():
    blob = T.write_synthetic_dng(np.full((16, 16), 1000, np.uint16))
    if torch.cuda.is_available():
        assert compat.RawBayerDataFromRaw(blob).sensor_scaled.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.RawBayerDataFromRaw(blob)
