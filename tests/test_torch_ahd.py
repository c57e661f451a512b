"""AHD of pysp_tpu_torch against pysp_tpu.demosaic.ahd, and the kernel dispatch.

The JAX functions run op by op (not under ``jax.jit``), the way the port runs.
A jitted XLA program fuses CIELAB's pow and cbrt and rounds them differently:
on the 160x192 develop scene of test_torch_develop.py the jitted
``pysp_tpu.develop`` is 41 dB from its own op-by-op run (18% of pixels off by
more than 1e-4), the cross-compilation tie-flip class of DIVERGENCES.md.

Gate: >= 50 dB PSNR with < 5% of pixels off by > 1e-4 (H/V picks that flip at
exact homogeneity ties, test_ahd_mega.py's gate). Measured: all six cases
below are bit-exact; the flips that the port's cube root (see
test_torch_transforms.py) can cause showed on the seed-3 scene in HDR mode, at
0.005-0.06% of pixels per channel.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.demosaic import ahd as jax_ahd_module
from pysp_tpu.demosaic import homogeneity as jax_homogeneity
from pysp_tpu.demosaic.ahd import demosaic_ahd_channels as jax_ahd
from pysp_tpu.demosaic.ahd import postprocess_color as jax_postprocess_image
from pysp_tpu.demosaic.ahd import postprocess_color_channels as jax_postprocess
from pysp_tpu.utils.testing import make_scene, mosaic_rggb, psnr
from pysp_tpu_torch.colorimetry import transforms
from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix, color_tail_channels
from pysp_tpu_torch.const import QualityDemosaic
from pysp_tpu_torch.core.frame import RawFrame
from pysp_tpu_torch.demosaic import Route, develop_route, homogeneity
from pysp_tpu_torch.demosaic.ahd import (
    ahd_candidates,
    ahd_channels,
    ahd_decision,
    ahd_decision_plain,
    demosaic_ahd_channels,
    postprocess_color,
    postprocess_color_channels,
)
from pysp_tpu_torch.ops.stencil import median5
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.pipeline import develop as develop_module
from pysp_tpu_torch.pipeline.develop import DevelopConfig, develop

torch.set_num_threads(1)
mega = importlib.import_module("pysp_tpu_torch.demosaic.ahd_mega")

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _frames(h, w, seed, is_hdr=False):
    """The same scene as a pysp_tpu frame and, from its NumPy leaves, a port frame."""
    jf = JaxFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=seed)), cam_mat=CAM,
                            wb_neutral=WB, is_hdr=is_hdr)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS), is_hdr=is_hdr,
                             device="cpu")
    return jf, tf


@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_demosaic_ahd_channels_matches_jax(is_hdr, stages):
    jf, tf = _frames(128, 160, seed=stages, is_hdr=is_hdr)
    want = np.stack([np.asarray(c) for c in jax_ahd(jf, stages)])
    got = torch.stack(demosaic_ahd_channels(tf, stages)).numpy()
    flipped = np.mean(np.abs(got - want) > 1e-4)
    assert psnr(got, want) >= 50
    assert flipped < 0.05
    if not is_hdr:
        np.testing.assert_array_equal(got, want)


def test_postprocess_color_channels_bit_exact():
    rgb = make_scene(96, 112, seed=4)
    want = jax_postprocess(*(jnp.asarray(rgb[..., k]) for k in range(3)))
    got = postprocess_color_channels(*(torch.from_numpy(rgb[..., k].copy()) for k in range(3)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", [(96, 112), (37, 50), (3, 5)])
def test_postprocess_color_image_bit_exact(shape, use_pallas):
    """One chroma-median stage of an (H, W, 3) image, the JAX package's
    ``postprocess_color`` run op by op; on CPU tensors ``use_pallas`` changes
    nothing (the kernel's entry runs the plain stage)."""
    rgb = make_scene(*shape, seed=shape[0])
    want = np.asarray(jax_postprocess_image(jnp.asarray(rgb)))
    got = postprocess_color(torch.from_numpy(rgb), use_pallas=use_pallas)
    assert got.shape == (*shape, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(160, 192), (96, 160), (8, 12)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_stitch_on_cpu_equals_plain_whole_frame(is_hdr, stages, shape):
    """On CPU the kernel wrapper runs the plain version and nothing is
    stitched over it: the dispatch returns ``ahd_plain`` exactly, for the
    planes and for the developed image, down to frames of a few pixels."""
    _, tf = _frames(*shape, seed=7, is_hdr=is_hdr)
    mat = cam_to_lin_srgb_matrix(tf.cam_mat, tf.cam_white)
    wb = tf.wb_reciprocal()
    want = demosaic_ahd_channels(tf, stages)
    got = mega.demosaic_ahd_mega(tf, mat, wb, stages)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got, K.ahd_plain(tf.bayer, mat, wb, is_hdr, stages))

    for tail in ((True, True), (False, False), (True, False)):
        want_img = torch.stack(color_tail_channels(*want, mat, *tail), dim=-1)
        got_img = mega.demosaic_ahd_mega(tf, mat, wb, stages, tail)
        assert torch.equal(got_img, want_img)
        assert torch.equal(got_img, K.ahd_plain(tf.bayer, mat, wb, is_hdr, stages, tail))


def test_frames_outside_the_kernel_path_fall_back():
    """More stages than the kernel takes go whole to the staged route; so do
    frames with a side under ``AHD_MIN_SIDE``, which the gate refuses. The
    wrapper refuses them itself."""
    _, big = _frames(256, 256, seed=8)
    best = QualityDemosaic.Best
    assert develop_route(best, True, "cuda", (256, 256), K.AHD_MAX_STAGES + 1) is Route.AHD_STAGED
    assert develop_route(best, True, "cuda", (2, 64), 1) is Route.AHD_STAGED
    assert develop_route(best, True, "cuda", (256, 256), K.AHD_MAX_STAGES) is Route.AHD_KERNEL
    mat = cam_to_lin_srgb_matrix(big.cam_mat, big.cam_white)
    staged = ahd_channels(big.bayer, mat, big.wb_reciprocal(), False, 3, staged=True)
    for g, w in zip(staged, demosaic_ahd_channels(big, 3)):
        assert torch.equal(g, w)
    meta = [t.to("meta") for t in (big.bayer, mat, big.wb_reciprocal())]
    with pytest.raises(ValueError, match="stages"):
        K.ahd_kernel(*meta, False, K.AHD_MAX_STAGES + 1)
    assert K.AHD_MIN_SIDE == 4
    assert K.ahd_kernel_admits((4, 6), 2) and K.ahd_kernel_admits((4000, 6000), 0)
    assert not K.ahd_kernel_admits((2, 64), 1) and not K.ahd_kernel_admits((64, 2), 1)
    assert not K.ahd_kernel_admits((64, 64), K.AHD_MAX_STAGES + 1)
    assert not K.ahd_kernel_admits((5, 64, 64), 1) and not K.ahd_kernel_admits((63, 64), 1)


def _launch_counts():
    return tuple(K.launch_counts[name]
                 for name in ("ahd", "postprocess", "median5", "homogeneity", "decision"))


def test_kernel_wrappers_take_the_plain_version_on_cpu_only():
    _, tf = _frames(64, 80, seed=9)
    mat = cam_to_lin_srgb_matrix(tf.cam_mat, tf.cam_white)
    wb = tf.wb_reciprocal()
    before = _launch_counts()
    planes = K.ahd_kernel(tf.bayer, mat, wb, False, 1)
    assert torch.equal(planes, torch.stack(demosaic_ahd_channels(tf, 1)))
    chans = [planes[k] for k in range(3)]
    for g, w in zip(K.postprocess_color_kernel(*chans), postprocess_color_channels(*chans)):
        assert torch.equal(g, w)
    image = planes.permute(1, 2, 0).contiguous()
    assert torch.equal(K.postprocess_color_image_kernel(image),
                       torch.stack(postprocess_color_channels(*chans), dim=-1))
    assert torch.equal(K.median5_kernel(chans[0]), median5(chans[0]))
    for vertical in (False, True):
        assert torch.equal(K.homogeneity_kernel(*chans, vertical),
                           homogeneity.homogeneity_map_channels(*chans, vertical))
    fields = ahd_candidates(tf.bayer, wb)
    want = ahd_decision_plain(*fields, mat, wb, False)
    assert torch.equal(K.decision_kernel(*fields, mat, wb, False), want)
    assert torch.equal(ahd_decision(*fields, mat, wb, False), want)
    assert _launch_counts() == before

    meta = [t.to("meta") for t in (tf.bayer, mat, wb)]
    with pytest.raises(ValueError, match="CUDA"):
        K.ahd_kernel(*meta, False, 1)
    with pytest.raises(ValueError, match="CUDA"):
        K.postprocess_color_kernel(*(c.to("meta") for c in chans))
    with pytest.raises(ValueError, match="CUDA"):
        K.postprocess_color_image_kernel(image.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        K.median5_kernel(chans[0].to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        K.homogeneity_kernel(*(c.to("meta") for c in chans), False)
    with pytest.raises(ValueError, match="CUDA"):
        K.decision_kernel(*(f.to("meta") for f in fields), meta[1], meta[2], False)


@pytest.mark.parametrize("is_vertical", [False, True])
@pytest.mark.parametrize("shape", [(96, 112), (5, 7), (1, 6)])
def test_homogeneity_map_bit_exact(shape, is_vertical):
    """``homogeneity_map`` and ``homogeneity_map_channels`` against the JAX
    package, through which it reaches ``homogeneity_map_pallas`` off the TPU."""
    rng = np.random.default_rng(shape[0])
    lab = make_scene(*shape, seed=shape[1]) * np.float32(100.0)
    lab = (lab + rng.normal(0, 2.0, lab.shape)).astype(np.float32)
    want = np.asarray(jax_homogeneity.homogeneity_map(jnp.asarray(lab), is_vertical))
    got = homogeneity.homogeneity_map(torch.from_numpy(lab), is_vertical)
    np.testing.assert_array_equal(got.numpy(), want)
    planes = [torch.from_numpy(lab[..., k].copy()) for k in range(3)]
    got = homogeneity.homogeneity_map_channels(*planes, is_vertical)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 3.0 <= want.min() and want.max() <= 9.0
    with pytest.raises(ValueError, match="odd"):
        homogeneity.homogeneity_map_channels(*planes, is_vertical, domain_k=4)


# Share of picks that may differ in HDR mode, where the port's cube root
# (within 1 ulp of the exact root, as jnp.cbrt is within 2) flips exact ties.
# Measured: 0 picks on seeds 0-2 and 1 of 20480 (0.005%) on seed 3, the scene
# whose develop showed 0.005-0.06% of output pixels off; 0 on the non-HDR ones.
MAX_HDR_PICK_FLIPS = 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_decision_plain_matches_the_jax_chain(is_hdr, seed):
    """The plain pick against the JAX package's chain (homogeneity maps of both
    directions, box sums, compare), the plain reference through which the JAX
    package reaches ``ahd_decision_pallas`` off the TPU, on the same six
    candidate fields."""
    jf, tf = _frames(128, 160, seed=seed, is_hdr=is_hdr)
    mat = cam_to_lin_srgb_matrix(tf.cam_mat, tf.cam_white)
    fields = ahd_candidates(tf.bayer, tf.wb_reciprocal())
    got = ahd_decision_plain(*fields, mat, tf.wb_reciprocal(), is_hdr).numpy()

    jfields = [jnp.asarray(f.numpy()) for f in fields]
    map_h = jax_ahd_module.box_sum3(
        jax_ahd_module._build_homogeneity_map(*jfields[:3], jf, False))
    map_v = jax_ahd_module.box_sum3(
        jax_ahd_module._build_homogeneity_map(*jfields[3:], jf, True))
    want = np.asarray((map_h < map_v).astype(jnp.float32))
    assert set(np.unique(got)) <= {0.0, 1.0}
    if is_hdr:
        assert np.mean(got != want) <= MAX_HDR_PICK_FLIPS
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stages", [1, 3])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_staged_route_with_use_pallas_equals_plain_on_cpu(is_hdr, stages):
    """On CPU tensors ``use_pallas`` changes nothing: every wrapper of the
    staged route runs its plain version and no launch is counted."""
    _, tf = _frames(64, 96, seed=5, is_hdr=is_hdr)
    before = _launch_counts()
    got = demosaic_ahd_channels(tf, stages, use_pallas=True)
    want = demosaic_ahd_channels(tf, stages, use_pallas=False)
    mat = cam_to_lin_srgb_matrix(tf.cam_mat, tf.cam_white)
    staged = ahd_channels(tf.bayer, mat, tf.wb_reciprocal(), is_hdr, stages, staged=True)
    for g, s, w in zip(got, staged, want):
        assert torch.equal(g, w) and torch.equal(s, w)
    assert _launch_counts() == before


# --- the develop's route and its colour matrix -------------------------------------


def _cascade_route(quality, use_pallas, device, shape, stages, highlights, tail):
    """The route of a develop (``tail``) or of ``demosaic`` alone, written out
    apart from the route function as a cascade of tests: Best with the kernels
    on a CUDA (H, W) frame takes the AHD kernel where its gate admits the
    frame and the stages, and the staged route otherwise; Draft and Fast
    develop fused on an (H, W) frame unless they reconstruct."""
    on_card = use_pallas and device == "cuda"
    best = quality == QualityDemosaic.Best
    if not tail:
        return (Route.AHD_STAGED if on_card else Route.AHD_PLAIN) if best else Route.CHANNELS
    use_kernel = best and on_card and len(shape) == 2
    admits = len(shape) == 2 and stages <= K.AHD_MAX_STAGES and all(
        n % 2 == 0 and n >= K.AHD_MIN_SIDE for n in shape)
    if use_kernel and admits:
        return Route.AHD_KERNEL_PLANES if highlights == "reconstruct" else Route.AHD_KERNEL
    if not best:
        flat = len(shape) == 2 and highlights != "reconstruct"
        return Route.FUSED if flat else Route.CHANNELS
    return Route.AHD_STAGED if on_card else Route.AHD_PLAIN


@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("highlights", ["clip", "reconstruct"])
@pytest.mark.parametrize("stages", [1, K.AHD_MAX_STAGES + 1])
@pytest.mark.parametrize("shape", [(64, 96), (2, 64), (63, 96), (3, 64, 96)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("quality", list(QualityDemosaic))
def test_develop_route_matches_the_cascade(quality, use_pallas, device, shape, stages,
                                           highlights, tail):
    """Every combination of what the route function observes picks the
    cascade's route. It needs no card: it reads the device's type only."""
    want = _cascade_route(quality, use_pallas, device, shape, stages, highlights, tail)
    got = develop_route(quality, use_pallas, device, shape, stages, highlights, tail)
    assert got is want
    assert got.uses_kernels == (quality == QualityDemosaic.Best and use_pallas
                                and device == "cuda")


# A develop's route on a CPU frame, forced where the CPU would not take it (the
# kernel wrappers run their plain versions there), with its config.
ROUTE_CASES = {
    Route.AHD_KERNEL: DevelopConfig(),
    Route.AHD_KERNEL_PLANES: DevelopConfig(highlights="reconstruct"),
    Route.AHD_STAGED: DevelopConfig(postprocess_stages=3),
    Route.AHD_PLAIN: DevelopConfig(),
    Route.FUSED: DevelopConfig(quality=QualityDemosaic.Draft),
    Route.CHANNELS: DevelopConfig(quality=QualityDemosaic.Fast, highlights="reconstruct"),
}


@pytest.mark.parametrize("route", list(Route), ids=lambda r: r.name)
def test_a_develop_computes_the_colour_matrix_once(monkeypatch, route):
    """Every route takes the matrix and the WB gains that ``develop`` computed
    (one ``cam_to_lin_srgb_matrix`` a develop), and a forced route gives the
    plain route's image on the CPU."""
    _, tf = _frames(32, 48, seed=11)
    cfg = ROUTE_CASES[route]
    want = develop(tf, cfg)
    calls = []
    matrix = transforms.cam_to_rgb_norm_matrix
    monkeypatch.setattr(transforms, "cam_to_rgb_norm_matrix",
                        lambda *a: calls.append(1) or matrix(*a))
    monkeypatch.setattr(develop_module, "develop_route", lambda *a: route)
    got = develop(tf, cfg)
    assert len(calls) == 1
    assert torch.equal(got, want)
