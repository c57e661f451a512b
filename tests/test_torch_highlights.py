"""Highlight reconstruction of pysp_tpu_torch against pysp_tpu, op by op.

The JAX functions run under ``jax.disable_jit()``; the same seeded NumPy
inputs go through both. Tolerances:

- ``masked_fill_pyramid``: 1e-6 abs (measured bit-equal: the 2x2 sums are
  taken in the JAX reduction's row-major order);
- ``reconstruct_highlights_channels``: 1e-6 abs;
- ``compress_highlights``: 2 ulp (``exp`` of two libraries);
- ``develop(..., highlights="reconstruct")``: 1e-5 abs for Best, Fast and
  Draft, RGGB and BGGR, single exposures and HDR frames (the AHD develop's
  H/V picks agree on these scenes; the gamma's ``pow`` and the matrix
  inverse differ in the last places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.const import BayerPattern as JaxPattern
from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.correct import highlights as JH
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop as jax_develop
from pysp_tpu_torch import (
    BayerPattern,
    DevelopConfig,
    QualityDemosaic,
    RawFrame,
    develop,
    develop_to_image,
    stack_frames,
)
from pysp_tpu_torch.correct import highlights as TH
from pysp_tpu_torch.correct.hdr import fuse_exposures_to_raw
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
DEVELOP_ATOL = 1e-5


def _f(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- masked_fill_pyramid -----------------------------------------------------------------

# (64, 96) halves evenly; (61, 97) is odd at the first level; (250, 375) is a
# 4000x6000 frame's fourth level, odd from there on; (37, 23) reaches a side
# of 1 before the sixth level.
@pytest.mark.parametrize("shape", [(64, 96), (61, 97), (250, 375), (37, 23), (1, 9)])
def test_masked_fill_pyramid_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x = rng.random(shape).astype(np.float32) + 2.0
    valid = rng.random(shape) > 0.3
    valid[shape[0] // 4 : shape[0] // 2, shape[1] // 5 : shape[1] // 2] = False
    with jax.disable_jit():
        want = np.asarray(JH.masked_fill_pyramid(jnp.asarray(x), jnp.asarray(valid)))
    got = TH.masked_fill_pyramid(_f(x), _f(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[valid], x[valid])


def test_masked_fill_pyramid_without_valid_pixels_takes_the_global_mean():
    x = np.full((12, 10), 3.0, np.float32)
    valid = np.zeros((12, 10), bool)
    with jax.disable_jit():
        want = np.asarray(JH.masked_fill_pyramid(jnp.asarray(x), jnp.asarray(valid)))
    got = TH.masked_fill_pyramid(_f(x), _f(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 0.0)


# ---- reconstruct_highlights_channels -------------------------------------------------------

def _blown_scene(h=96, w=128, peak=3.0):
    """Constant-chroma scene with a smooth blob blowing out the middle (the
    JAX tests' scene): WB'd camera-space truth, its clipped version, gains."""
    gains = np.array([2.0, 1.0, 1.6], np.float32)
    rho = np.array([1.2, 1.0, 0.8], np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bump = np.exp(-(((yy - h / 2) / (h / 5)) ** 2 + ((xx - w / 2) / (w / 5)) ** 2))
    intensity = 0.15 + (peak - 0.15) * bump
    truth = [rho[c] * intensity for c in range(3)]
    clipped = [np.minimum(truth[c], gains[c]).astype(np.float32) for c in range(3)]
    return truth, clipped, gains


@pytest.mark.parametrize("lim_sat", [1.0, 1.7])
@pytest.mark.parametrize("shape", [(96, 128), (75, 101)])
def test_reconstruct_matches_jax(shape, lim_sat):
    _, clipped, gains = _blown_scene(*shape, peak=3.0 * lim_sat)
    clipped = [np.minimum(c * lim_sat, g * lim_sat) for c, g in zip(clipped, gains)]
    rng = np.random.default_rng(7)
    clipped = [(c * (1 + rng.normal(0, 0.01, c.shape))).astype(np.float32) for c in clipped]
    with jax.disable_jit():
        want = JH.reconstruct_highlights_channels(
            *(jnp.asarray(c) for c in clipped), jnp.asarray(gains),
            jnp.asarray(lim_sat, jnp.float32))
    got = TH.reconstruct_highlights_channels(
        *(_f(c) for c in clipped), _f(gains), torch.tensor(lim_sat, dtype=torch.float32))
    for c, gain, g, w in zip(clipped, gains, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
        unclipped = c < 0.95 * gain * lim_sat
        assert unclipped.sum() > 100
        # unclipped pixels are bit-untouched
        np.testing.assert_array_equal(g.numpy()[unclipped], c[unclipped])


def test_reconstruct_recovers_constant_chroma_blob():
    """The JAX test's gate on the port: the witnessed clipped region's error
    collapses, the fully clipped core improves."""
    truth, clipped, gains = _blown_scene()
    rec = [t.numpy() for t in TH.reconstruct_highlights_channels(
        *(_f(c) for c in clipped), _f(gains), torch.tensor(1.0))]
    any_clip = np.zeros(clipped[0].shape, bool)
    core = np.ones(clipped[0].shape, bool)
    for c in range(3):
        m = clipped[c] >= 0.95 * gains[c]
        any_clip |= m
        core &= m
        assert np.all(rec[c] >= clipped[c] - 1e-6)
    witnessed = any_clip & (clipped[2] < 0.95 * gains[2])
    err_in = sum(np.abs(clipped[c] - truth[c])[witnessed].mean() for c in range(3))
    err_out = sum(np.abs(rec[c] - truth[c])[witnessed].mean() for c in range(3))
    assert err_out < 0.15 * err_in
    assert core.sum() > 0
    err_in = sum(np.abs(clipped[c] - truth[c])[core].mean() for c in range(3))
    err_out = sum(np.abs(rec[c] - truth[c])[core].mean() for c in range(3))
    assert err_out < err_in


def test_reconstruct_takes_strided_views():
    """The AHD kernel's planes are views of one (3, H, W) tensor, and the
    channels of an (H, W, 3) image are strided: the result is the same."""
    _, clipped, gains = _blown_scene(64, 80)
    planes = _f(np.stack(clipped))
    image = planes.permute(1, 2, 0).contiguous()
    want = TH.reconstruct_highlights_channels(*planes.clone().unbind(0), _f(gains),
                                              torch.tensor(1.0))
    for chans in (planes.unbind(0), image.unbind(-1)):
        got = TH.reconstruct_highlights_channels(*chans, _f(gains), torch.tensor(1.0))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---- compress_highlights ---------------------------------------------------------------------

def test_compress_highlights_within_two_ulp():
    x = np.linspace(0.0, 6.0, 4001, dtype=np.float32)
    with jax.disable_jit():
        want = np.asarray(JH.compress_highlights(jnp.asarray(x)))
    got = TH.compress_highlights(_f(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    below = x <= 0.85
    np.testing.assert_array_equal(got[below], x[below])
    assert np.all(got <= 1.0 + 1e-6) and np.all(np.diff(got) >= -1e-7)


# ---- develop(..., highlights="reconstruct") -----------------------------------------------------

def _blown_mosaic(h, w, seed):
    """A structured scene brightened by a blob until part of it clips: the
    blob's core clips in all three channels, its ring only in G."""
    rgb = make_scene(h, w, seed=seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((yy - h / 2) / (h / 6)) ** 2 + ((xx - w / 3) / (w / 6)) ** 2))
    return mosaic_rggb((rgb * (1 + 1.5 * blob[..., None])).astype(np.float32))


def _frames(pattern, hdr, seed=3, h=96, w=128):
    lim = 2.0 if hdr else 1.0
    bayer = np.clip(_blown_mosaic(h, w, seed) * (1.7 if hdr else 1.0), 0, lim)
    jax_pattern = JaxPattern.Bggr if pattern == "bggr" else JaxPattern.Rggb
    jf = JaxFrame.synthetic(bayer.astype(np.float32), cam_mat=CAM, wb_neutral=WB,
                            lim_sat=lim, is_hdr=hdr, source_pattern=jax_pattern)
    return jf, _to_port(jf)


def _to_port(jf):
    return RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS), is_hdr=jf.is_hdr,
                               source_pattern=BayerPattern(int(jf.source_pattern)),
                               device="cpu")


def _to_jax(tf):
    return JaxFrame(**{k: jnp.asarray(getattr(tf, k).numpy()) for k in FIELDS},
                    is_hdr=tf.is_hdr, source_pattern=JaxPattern(int(tf.source_pattern)))


def _develop_both(jf, tf, quality, **kw):
    with jax.disable_jit():
        want = np.asarray(jax_develop(jf, JaxConfig(quality=getattr(JaxQuality, quality),
                                                    highlights="reconstruct", **kw)))
    got = develop(tf, DevelopConfig(quality=getattr(QualityDemosaic, quality),
                                    highlights="reconstruct", **kw))
    return got, want


@pytest.mark.parametrize("hdr", [False, True])
@pytest.mark.parametrize("pattern", ["rggb", "bggr"])
@pytest.mark.parametrize("quality", ["Best", "Fast", "Draft"])
def test_develop_reconstruct_matches_jax(quality, pattern, hdr):
    jf, tf = _frames(pattern, hdr)
    got, want = _develop_both(jf, tf, quality)
    assert got.shape == (96, 128, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=DEVELOP_ATOL, rtol=0)
    # the scene clips: every channel somewhere, and G alone around the core
    clip = [np.asarray(jf.bayer)[dy::2, dx::2] >= 0.95 * float(jf.lim_sat)
            for dy, dx in ((0, 0), (0, 1), (1, 1))]
    assert all(c.sum() > 20 for c in clip)


@pytest.mark.parametrize("gamma", [True, False])
def test_develop_reconstruct_without_gamma_and_stages(gamma):
    jf, tf = _frames("rggb", False, seed=5)
    got, want = _develop_both(jf, tf, "Best", gamma_encode=gamma, postprocess_stages=2)
    np.testing.assert_allclose(got.numpy(), want, atol=DEVELOP_ATOL, rtol=0)


def test_develop_reconstruct_of_a_fused_bracket():
    """An HDR frame fused from three brackets by the port's correct/hdr
    (lim_sat = 4, the HDR CIELAB branch of the AHD), developed with
    reconstruction: the JAX develop of the same fused frame."""
    mosaic = _blown_mosaic(80, 112, seed=6)
    frames = [RawFrame.synthetic(np.clip(mosaic * 2.0 ** (k - 1), 0, 1), cam_mat=CAM,
                                 wb_neutral=WB, ev=10.0 + k, device="cpu") for k in range(3)]
    hdr, _ = fuse_exposures_to_raw(stack_frames(frames, device="cpu"))
    assert hdr.is_hdr and float(hdr.lim_sat) > 1.0
    got, want = _develop_both(_to_jax(hdr), hdr, "Best")
    np.testing.assert_allclose(got.numpy(), want, atol=DEVELOP_ATOL, rtol=0)


@pytest.mark.parametrize("quality", [QualityDemosaic.Draft, QualityDemosaic.Best])
def test_develop_reconstruct_renders_the_blown_core_below_white(quality):
    """The JAX test's integration gate (tests/test_highlights.py) on the port,
    on its frame: the core that clipping renders white keeps tonal separation,
    the output lies in [0, 1], and the dark corner matches the clip develop."""
    gains = np.array([2.0, 1.0, 1.6], np.float32)
    _, clipped, _ = _blown_scene(64, 96, peak=2.5)
    rgb_sensor = np.dstack([clipped[c] / gains[c] for c in range(3)])
    frame = RawFrame.synthetic(mosaic_rggb(np.clip(rgb_sensor, 0, 1)), wb_neutral=1.0 / gains,
                               device="cpu")
    out_clip = develop(frame, DevelopConfig(quality=quality)).numpy()
    out_rec = develop(frame, DevelopConfig(quality=quality, highlights="reconstruct")).numpy()
    assert out_rec.shape == out_clip.shape and np.all(np.isfinite(out_rec))
    assert out_rec.min() >= 0.0 and out_rec.max() <= 1.0 + 1e-6
    core = out_clip[..., 1] > 0.995
    assert core.sum() > 50
    assert out_rec[core].mean() < 0.995 and out_rec[core].std() > 1e-3
    h, w, _ = out_rec.shape
    np.testing.assert_allclose(out_rec[: h // 8, : w // 8], out_clip[: h // 8, : w // 8],
                               atol=2e-3)


def test_develop_to_image_ignores_the_highlight_mode():
    """As in the JAX package, develop_to_image does not reconstruct."""
    _, tf = _frames("bggr", False)
    got = develop_to_image(tf, DevelopConfig(highlights="reconstruct"))
    want = develop_to_image(tf, DevelopConfig())
    assert torch.equal(got.image, want.image)
