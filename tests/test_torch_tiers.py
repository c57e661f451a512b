"""The Draft and Fast tiers of pysp_tpu_torch against pysp_tpu, on the CPU.

The JAX functions run op by op (not under ``jax.jit``), the way the port runs,
on the same numpy scene. Neither tier has a transcendental before the colour
tail's gamma, a data-dependent branch (apart from Fast's flat-neighbourhood
``where``) or a reduction, so the port repeats the JAX package's float32
operations one for one: the demosaics before the tail are bit-exact.

Tolerance of the develops: 1e-6 absolute on the linear image. The one input of
the tail that differs is the cam->lin-sRGB matrix, a float32 3x3 inverse that
the two frameworks' LAPACKs round differently (up to 2.4e-7 per entry on this
metadata; tests/test_torch_transforms.py holds it to 1e-6), which moves a
linear value by up to 3.6e-7 here. The sRGB gamma multiplies that by its slope,
at most 12.92 (the linear toe), so the gamma-encoded image is held to 12.92e-6;
measured: 1.9e-6 (Draft) and below on these scenes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.const import BayerPattern as JaxPattern
from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.demosaic import demosaic as jax_demosaic
from pysp_tpu.demosaic import draft as jax_draft
from pysp_tpu.demosaic import eag as jax_eag
from pysp_tpu.ops import polyphase as jax_polyphase
from pysp_tpu.ops import stencil as jax_stencil
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop as jax_develop
from pysp_tpu.pipeline.develop import develop_to_image as jax_develop_to_image
from pysp_tpu.utils.testing import make_scene, mosaic_rggb
from pysp_tpu_torch import (
    BayerPattern,
    DevelopConfig,
    QualityDemosaic,
    RawFrame,
    develop,
    develop_burst,
    develop_to_image,
)
from pysp_tpu_torch.demosaic import demosaic, draft, eag
from pysp_tpu_torch.ops import polyphase
from pysp_tpu_torch.ops.stencil import upsample2x_bilinear_cv2

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
ATOL = 1e-6                 # linear image
GAMMA_ATOL = 12.92 * ATOL   # gamma-encoded image: the sRGB curve's largest slope
TAILS = [(True, True), (False, False), (True, False), (False, True)]
QUALITIES = ["Draft", "Fast"]


def _frames(pattern="Rggb", seed=0, h=96, w=128):
    """The same scene as a pysp_tpu frame and, from its NumPy leaves, a port frame."""
    jf = JaxFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=seed)), cam_mat=CAM,
                            wb_neutral=WB, source_pattern=getattr(JaxPattern, pattern))
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS),
                             source_pattern=getattr(BayerPattern, pattern), device="cpu")
    return jf, tf


def _assert_channels_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _atol(gamma_encode: bool) -> float:
    return GAMMA_ATOL if gamma_encode else ATOL


def _assert_channels_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= atol


@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 3), (2, 3, 5, 3)])
def test_upsample2x_bilinear_cv2_bit_exact(shape):
    x = np.random.default_rng(len(shape)).random(shape, dtype=np.float32)
    want = np.asarray(jax_stencil.upsample2x_bilinear_cv2(jnp.asarray(x)))
    got = upsample2x_bilinear_cv2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_quad_converters_bit_exact_and_round_trip():
    x = np.random.default_rng(1).random((2, 12, 16), dtype=np.float32)
    quad = polyphase.bayer_to_quad(torch.from_numpy(x))
    want = jax_polyphase.bayer_to_quad(jnp.asarray(x))
    for py in (0, 1):
        for px in (0, 1):
            np.testing.assert_array_equal(quad[py][px].numpy(), np.asarray(want[py][px]))
    back = polyphase.quad_to_bayer(quad)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_polyphase.quad_to_bayer(want)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("weighting", [True, False])
def test_resample_g_to_full_resolution_bit_exact(weighting):
    rng = np.random.default_rng(2)
    g1, g2 = rng.random((2, 24, 32), dtype=np.float32)
    g1[4:9, 5:11] = g2[4:9, 5:11] = 0.5     # a flat patch: the equal-weights branch
    want = jax_eag.resample_g_to_full_resolution(jnp.asarray(g1), jnp.asarray(g2), weighting)
    got = eag.resample_g_to_full_resolution(torch.from_numpy(g1), torch.from_numpy(g2),
                                            weighting)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resample_r_and_b_alone_equal_resample_rb():
    _, tf = _frames(seed=3)
    r_up, g_up, b_up = eag.demosaic_eag_channels(tf, tf.wb_reciprocal())
    planes = tf.bayer[0::2, 0::2] * tf.wb_reciprocal()[0], tf.bayer[1::2, 1::2] * tf.wb_reciprocal()[2]
    assert torch.equal(eag.resample_r(planes[0], g_up), r_up)
    assert torch.equal(eag.resample_b(planes[1], g_up), b_up)


def test_resample_rb_blurs_the_green_once_on_the_cpu(monkeypatch):
    """On CPU tensors R and B share one 3x3 blur of the full-resolution
    green, and each channel is ``resample_channel_plain``'s."""
    _, tf = _frames(seed=5)
    r, g1, b, g2 = eag.bayer_to_rgbg(tf.bayer)
    g_up = eag.resample_g_to_full_resolution(g1, g2)
    blurs = []
    blur = eag.gaussian_blur3
    monkeypatch.setattr(eag, "gaussian_blur3", lambda x: blurs.append(x) or blur(x))
    r_up, b_up = eag.resample_rb(r, b, g_up)
    assert len(blurs) == 1
    monkeypatch.setattr(eag, "gaussian_blur3", blur)
    P = eag.BayerPatternPosition
    assert torch.equal(r_up, eag.resample_channel_plain(r, g_up, P.TOP_LEFT))
    assert torch.equal(b_up, eag.resample_channel_plain(b, g_up, P.BOTTOM_RIGHT))


def test_the_eag_kernels_take_cuda_tensors_only():
    """The EAG kernels' wrappers launch on CUDA tensors alone; the plain
    versions of ``demosaic.eag`` serve the CPU."""
    from pysp_tpu_torch.ops import cuda_kernels as K

    g1 = torch.rand(4, 6)
    assert not eag.resamples_in_kernel(g1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.eag_fill_kernel(g1, g1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.eag_upsample_kernel(g1, torch.rand(8, 12), eag.BayerPatternPosition.TOP_LEFT)


@pytest.mark.parametrize("seed", [0, 1])
def test_demosaic_draft_channels_bit_exact(seed):
    jf, tf = _frames(seed=seed)
    _assert_channels_equal(draft.demosaic_draft_channels(tf, tf.wb_reciprocal()),
                           jax_draft.demosaic_draft_channels(jf))


@pytest.mark.parametrize("seed", [0, 1])
def test_demosaic_eag_channels_bit_exact(seed):
    jf, tf = _frames(seed=seed)
    _assert_channels_equal(eag.demosaic_eag_channels(tf, tf.wb_reciprocal()),
                           jax_eag.demosaic_eag_channels(jf))


def _mat_wb(tf):
    """The cam->lin-sRGB matrix and the reciprocal WB gains, as develop computes them."""
    from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix

    return cam_to_lin_srgb_matrix(tf.cam_mat, tf.cam_white), tf.wb_reciprocal()


@pytest.mark.parametrize("tail", TAILS)
def test_develop_channels_draft_matches_jax(tail):
    """The fused Draft develop against its own JAX function (it differs from
    the ``*_channels`` form by one association order)."""
    jf, tf = _frames(seed=4)
    _assert_channels_close(draft.develop_channels_draft(tf, *_mat_wb(tf), *tail),
                           jax_draft.develop_channels_draft(jf, *tail), _atol(tail[1]))


@pytest.mark.parametrize("tail", TAILS)
def test_develop_channels_eag_matches_jax(tail):
    jf, tf = _frames(seed=5)
    _assert_channels_close(eag.develop_channels_eag(tf, *_mat_wb(tf), *tail),
                           jax_eag.develop_channels_eag(jf, *tail), _atol(tail[1]))


@pytest.mark.parametrize("quality", QUALITIES)
def test_fused_develop_is_close_to_the_channels_form(quality):
    """The fused forms are the ``*_channels`` forms plus the tail up to
    association order: within 1e-6 of each other before the gamma."""
    from pysp_tpu_torch.colorimetry.transforms import color_tail_channels

    _, tf = _frames(seed=6)
    mat, wb = _mat_wb(tf)
    if quality == "Draft":
        fused = draft.develop_channels_draft(tf, mat, wb, True, False)
        staged = color_tail_channels(*draft.demosaic_draft_channels(tf, wb), mat, True, False)
    else:
        fused = eag.develop_channels_eag(tf, mat, wb, True, False)
        staged = color_tail_channels(*eag.demosaic_eag_channels(tf, wb), mat, True, False)
    for f, s in zip(fused, staged):
        assert (f - s).abs().max().item() <= ATOL


@pytest.mark.parametrize("tail", TAILS)
@pytest.mark.parametrize("pattern", ["Rggb", "Bggr", "Grbg"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_develop_matches_jax(quality, pattern, tail):
    jf, tf = _frames(pattern)
    kw = dict(clip_highlights=tail[0], gamma_encode=tail[1])
    want = np.asarray(jax_develop.__wrapped__(
        jf, JaxConfig(quality=getattr(JaxQuality, quality), **kw)))
    got = develop(tf, DevelopConfig(quality=getattr(QualityDemosaic, quality), **kw))
    assert got.shape == (96, 128, 3) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= _atol(tail[1])


@pytest.mark.parametrize("pattern", ["Rggb", "Gbrg"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_develop_to_image_and_demosaic_match_jax(quality, pattern):
    jf, tf = _frames(pattern, seed=1)
    want = jax_develop_to_image(jf, JaxConfig(quality=getattr(JaxQuality, quality)))
    got = develop_to_image(tf, DevelopConfig(quality=getattr(QualityDemosaic, quality)))
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    for k in ("wb_coeff", "cam_mat", "cam_white", "ev"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert (got.wb_applied, got.wb_normalized) == (want.wb_applied, want.wb_normalized)
    plain = demosaic(tf, getattr(QualityDemosaic, quality))
    np.testing.assert_array_equal(
        plain.image.numpy(), np.asarray(jax_demosaic(jf, getattr(JaxQuality, quality)).image))


@pytest.mark.parametrize("quality", QUALITIES)
def test_develop_burst_is_a_loop_of_develops(quality):
    """A burst develops frame by frame, each a 2-D frame through the fused form."""
    cfg = DevelopConfig(quality=getattr(QualityDemosaic, quality))
    frames = [_frames(seed=s, h=32, w=48)[1] for s in (2, 3)]
    burst = frames[0].replace(**{
        k: torch.stack([getattr(f, k) for f in frames]) for k in FIELDS
    })
    got = develop_burst(burst, cfg)
    assert got.shape == (2, 32, 48, 3)
    for i, f in enumerate(frames):
        assert torch.equal(got[i], develop(f, cfg))
