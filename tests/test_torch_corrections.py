"""The corrections path of pysp_tpu_torch against pysp_tpu.

Every input is built once in NumPy from a seed and handed to both packages;
the JAX functions run op by op (``jax.disable_jit()``), as the port runs. The
tolerance of each test is stated where it is checked:

- plane (de)interleave, ``shift2d``, ``median2``, the threshold detector,
  ``find_shared_pixels``, dark and bias subtraction: equal;
- the median detector: its threshold within 1e-6 relative, its masks equal
  except at sites within that margin of the threshold (XLA and PyTorch sum
  the float32 noise floor in different orders);
- the masked fill (the heal kernel's plain version): bit-exact against the
  JAX dense fill, the JAX sparse fill and the interpret-mode Pallas heal
  wherever the fill sweeps reach; sites seeded from the plane mean, and the
  smoothing that follows them, within 1e-6 (the float32 mean again);
- the flat field: within 1e-6 relative (per-phase means in another order);
- the HDR fuses: within 1e-5, the repo's gate (``correct/hdr.py``), counts equal;
- the wavelet denoise: within 1e-5;
- ``develop_pipeline`` (BASELINE configs 3 and 4 at 64x96): >= 50 dB PSNR,
  the AHD tie-flip floor of DIVERGENCES.md.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.core import bayer as JB
from pysp_tpu.core.frame import DevelopedImage as JaxImage
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.correct import bad_pixels as JP
from pysp_tpu.correct import denoise as JD
from pysp_tpu.correct import flat_field as JF
from pysp_tpu.correct import hdr as JH
from pysp_tpu.ops import stencil as JS
from pysp_tpu.pipeline import pipeline as JPL
from pysp_tpu.utils.testing import make_scene, mosaic_rggb, psnr
from pysp_tpu_torch.core import bayer as TB
from pysp_tpu_torch.core.frame import DevelopedImage, RawFrame, stack_frames, unstack_frames
from pysp_tpu_torch.correct import bad_pixels as TP
from pysp_tpu_torch.correct import denoise as TD
from pysp_tpu_torch.correct import flat_field as TF
from pysp_tpu_torch.correct import hdr as TH
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.ops import stencil as TS
from pysp_tpu_torch.pipeline import pipeline as TPL

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
MIN_PSNR = 50.0


def _pair(bayer, **meta):
    """The same frame for both packages: (JAX frame, port frame on the CPU)."""
    jf = JaxFrame.synthetic(jnp.asarray(bayer), **meta)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS),
                             is_hdr=jf.is_hdr, device="cpu")
    return jf, tf


def _mosaic(h, w, seed, hot=0):
    """A structured mosaic with ``hot`` photosites planted at 1.0 where the
    scene is dark."""
    bayer = mosaic_rggb(make_scene(h, w, seed=seed))
    rng = np.random.default_rng(seed + 100)
    dark = np.argwhere(bayer < 0.3)
    for y, x in dark[rng.choice(len(dark), size=hot, replace=False)]:
        bayer[y, x] = 1.0
    return bayer


def _jax_burst(frames):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)


# --- planes and stencils ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 20), (3, 12, 8)])
def test_planes_round_trip_equal(shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(JB.bayer_to_planes(jnp.asarray(x)))
    got = TB.bayer_to_planes(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    back = TB.planes_to_bayer(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JB.planes_to_bayer(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("pad", ["pad_reflect", "pad_reflect101", "pad_replicate"])
@pytest.mark.parametrize("dy,dx", [(-1, 0), (1, 0), (0, -1), (0, 1), (2, -3), (-4, 0)])
def test_shift2d_equal(dy, dx, pad):
    x = np.random.default_rng(1).normal(0.4, 0.3, (4, 13, 17)).astype(np.float32)
    want = JS.shift2d(jnp.asarray(x), dy, dx, getattr(JS, pad))
    got = TS.shift2d(torch.from_numpy(x), dy, dx, getattr(TS, pad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
def test_median2_equal(ties):
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 4, (4, 15, 18)) if ties else rng.random((4, 15, 18))).astype(np.float32)
    np.testing.assert_array_equal(TS.median2(torch.from_numpy(x)).numpy(),
                                  np.asarray(JS.median2(jnp.asarray(x))))


# --- detection ----------------------------------------------------------------------


@pytest.mark.parametrize("min_delta,count", [(0.025, 5), (0.1, 6), (0.01, 3)])
def test_threshold_detector_masks_equal(min_delta, count):
    jf, tf = _pair(_mosaic(64, 96, seed=3, hot=12))
    want = np.asarray(JP.find_erroneous_pixels_threshold(jf, min_delta, count))
    got = TP.find_erroneous_pixels_threshold(tf, min_delta, count)
    assert got.dtype == torch.bool and got.shape == (4, 32, 48)
    np.testing.assert_array_equal(got.numpy(), want)


def _median_deltas(jf, tf):
    """The detector's final delta planes in both packages, for its threshold."""
    jp = JB.bayer_to_planes(jf.bayer)
    jd = jnp.abs(jp - JS.median2(jp))
    jd = jnp.abs(jd - jnp.mean(jd, axis=(-2, -1), keepdims=True))
    tp = TB.bayer_to_planes(tf.bayer)
    td = torch.abs(tp - TS.median2(tp))
    td = torch.abs(td - td.mean(dim=(-2, -1), keepdim=True))
    return jd, td


@pytest.mark.parametrize("quantile,multiplier", [(0.9999, 1.5), (0.999, 1.5), (0.99, 2.0)])
@pytest.mark.parametrize("seed,hot", [(4, 6), (5, 0)])
def test_median_detector_threshold_and_masks(seed, hot, quantile, multiplier):
    with jax.disable_jit():
        jf, tf = _pair(_mosaic(96, 128, seed=seed, hot=hot))
        jd, td = _median_deltas(jf, tf)
        want_q = np.asarray(JP._bisect_quantile(jd, quantile))
        want = np.asarray(JP.find_erroneous_pixels_median(jf, multiplier, quantile))
    got_q = TP._bisect_quantile(td, quantile).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-6, atol=0)
    got = TP.find_erroneous_pixels_median(tf, multiplier, quantile).numpy()
    strong = (want_q * multiplier).reshape(4, 1, 1)
    near = np.abs(np.asarray(jd) - strong) <= 1e-6 * strong
    np.testing.assert_array_equal(got[~near], want[~near])


def test_median_detector_on_cpu_planes_never_loads_the_kernels(monkeypatch):
    """On CPU planes the detector's quantile is the plain multisection: with
    the kernels' library unloadable it still runs, and equals the JAX
    package's threshold and masks."""
    from pysp_tpu_torch.ops import cuda_kernels as K

    def no_library():
        raise AssertionError("the CPU detector loaded the CUDA kernels")

    monkeypatch.setattr(K, "load_library", no_library)
    before = K.launch_counts["multisection"]
    with jax.disable_jit():
        jf, tf = _pair(_mosaic(96, 128, seed=4, hot=6))
        jd, td = _median_deltas(jf, tf)
        want_q = np.asarray(JP._bisect_quantile(jd, 0.9999))
        want = np.asarray(JP.find_erroneous_pixels_median(jf, 1.5, 0.9999))
    np.testing.assert_allclose(TP._bisect_quantile(td, 0.9999).numpy(), want_q, rtol=1e-6,
                               atol=0)
    got = TP.find_erroneous_pixels_median(tf, 1.5, 0.9999).numpy()
    strong = (want_q * 1.5).reshape(4, 1, 1)
    near = np.abs(np.asarray(jd) - strong) <= 1e-6 * strong
    np.testing.assert_array_equal(got[~near], want[~near])
    assert K.launch_counts["multisection"] == before


def test_find_shared_pixels_equal():
    rng = np.random.default_rng(6)
    masks = [rng.random((4, 8, 12)) < 0.3 for _ in range(5)]
    for ratio in (0.1, 0.4, 0.5, 1.0):
        want = np.asarray(JP.find_shared_pixels([jnp.asarray(m) for m in masks], ratio))
        got = TP.find_shared_pixels([torch.from_numpy(m) for m in masks], ratio)
        np.testing.assert_array_equal(got.numpy(), want)
    assert TP.find_shared_pixels([]) is None
    assert TP.find_shared_pixels([torch.from_numpy(masks[0]), torch.zeros(4, 8, 10)]) is None


# --- the heal -------------------------------------------------------------------------


def _heal_case(unreachable: bool):
    """``test_heal_pallas_interpret_matches_dense``'s case (tests/test_corrections.py):
    scattered sites, plane corners, a 3x3 cluster and (optionally) a 13x13 blob
    that four fill sweeps cannot reach."""
    rng = np.random.default_rng(17)
    h2, w2 = 16, 256
    chan = rng.random((4, h2, w2)).astype(np.float32)
    mask = np.zeros((4, h2, w2), bool)
    mask[(rng.random((4, h2, w2)) < 3e-3)] = True
    mask[0, 0, 0] = mask[1, h2 - 1, w2 - 1] = mask[2, 0, 30] = mask[3, 10, 0] = True
    mask[0, 5:8, 10:13] = True
    if unreachable:
        mask[1, 2:15, 20:33] = True
    return chan, mask


def _mean_seeded(mask, fill=4, smooth=2):
    """Sites whose value depends on a plane-mean seed: the sites the fill
    sweeps leave unreached, and the masked sites the smoothing sweeps reach
    from them."""
    v = ~mask
    for _ in range(fill):
        p = np.pad(v, ((0, 0), (1, 1), (1, 1)), mode="edge")
        v = v | p[:, :-2, 1:-1] | p[:, 2:, 1:-1] | p[:, 1:-1, :-2] | p[:, 1:-1, 2:]
    seeded = ~v
    for _ in range(smooth):
        p = np.pad(seeded, ((0, 0), (1, 1), (1, 1)), mode="edge")
        grown = seeded | p[:, :-2, 1:-1] | p[:, 2:, 1:-1] | p[:, 1:-1, :-2] | p[:, 1:-1, 2:]
        seeded = grown & mask
    return seeded


@pytest.mark.parametrize("reference", ["dense", "sparse", "pallas_interpret"])
@pytest.mark.parametrize("unreachable", [False, True])
def test_masked_fill_matches_the_jax_fills(unreachable, reference):
    from pysp_tpu.ops.pallas_kernels import masked_fill_pallas

    chan, mask = _heal_case(unreachable)
    jc, jm = jnp.asarray(chan), jnp.asarray(mask)
    with jax.disable_jit():
        if reference == "dense":
            want = JP.masked_fill_inpaint(jc, jm)
        elif reference == "sparse":
            want = JP.masked_fill_inpaint_sparse(jc, jm, max_sites=2048)
        else:
            want = masked_fill_pallas(jc, jm, tile_h=8, interpret=True)
    want = np.asarray(want)
    got = TP.masked_fill_inpaint(torch.from_numpy(chan), torch.from_numpy(mask)).numpy()
    assert np.array_equal(got == got, want == want)
    seeded = _mean_seeded(mask)
    assert seeded.any() == unreachable
    np.testing.assert_array_equal(got[~seeded], want[~seeded])
    np.testing.assert_allclose(got[seeded], want[seeded], rtol=0, atol=1e-6)


@pytest.mark.parametrize("iterations", [4, 2, 7])
def test_repair_bad_pixels_matches_jax(iterations):
    """On a frame with hot photosites found by the median detector; 7 fill
    sweeps (9 in all) lie outside the heal kernel's gate and take the dense
    fill, as the JAX package's do."""
    bayer = _mosaic(64, 96, seed=7, hot=8)
    bayer[10:16, 20:30] = 1.0                       # a blob: clusters in every plane
    jf, tf = _pair(bayer)
    masks = np.array(JP.find_erroneous_pixels_median(jf, quantile=0.99))
    masks[:, 5:8, 10:15] = True
    with jax.disable_jit():
        want = np.asarray(JB.bayer_to_planes(JP.repair_bad_pixels(jf, jnp.asarray(masks),
                                                                   iterations).bayer))
    got = TB.bayer_to_planes(TP.repair_bad_pixels(tf, masks, iterations).bayer).numpy()
    seeded = _mean_seeded(masks, fill=iterations)
    np.testing.assert_array_equal(got[~seeded], want[~seeded])
    np.testing.assert_allclose(got[seeded], want[seeded], rtol=0, atol=1e-6)
    assert K.heal_kernel_admits(iterations, 2) == (iterations + 2 <= 8)


def test_repair_ignores_masks_that_are_not_four_planes():
    _, tf = _pair(_mosaic(16, 16, seed=8))
    assert TP.repair_bad_pixels(tf, np.zeros((3, 8, 8), bool)) is tf


def test_diffusion_inpaint_within_float32():
    chan, mask = _heal_case(False)
    with jax.disable_jit():
        want = np.asarray(JP.diffusion_inpaint(jnp.asarray(chan), jnp.asarray(mask), 8))
    got = TP.diffusion_inpaint(torch.from_numpy(chan), torch.from_numpy(mask), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- flat field, dark, bias -------------------------------------------------------------


def _flat(h, w, kind):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2
    flat = (1.0 - 0.8 * r2).astype(np.float32)
    if kind == "zeros":
        flat[3, 5] = flat[10, 20] = flat[7, 7] = 0.0
    elif kind == "dead_plane":
        flat[0::2, 1::2] = 0.0                      # the G1 plane is all zero
    return flat


@pytest.mark.parametrize("clamp_high", [False, True])
@pytest.mark.parametrize("kind", ["positive", "zeros", "dead_plane"])
def test_flat_field_matches_jax(kind, clamp_high):
    bayer = _mosaic(32, 48, seed=9) * 1.3
    bayer[4, 4] = 0.0                               # 0 / 0 where the flat has a zero too
    flat = _flat(32, 48, kind)
    flat[4, 4] = 0.0 if kind != "positive" else flat[4, 4]
    jf, tf = _pair(bayer)
    jflat, tflat = _pair(flat)
    with jax.disable_jit():
        want = np.asarray(JF.flat_frame_correction(jf, jflat, clamp_high).bayer)
    got = TF.flat_frame_correction(tf, tflat, clamp_high).bayer.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kind == "dead_plane":
        np.testing.assert_array_equal(got[0::2, 1::2], bayer[0::2, 1::2])


def test_dark_and_bias_subtraction_equal():
    jf, tf = _pair(_mosaic(32, 48, seed=10))
    noise = np.random.default_rng(10).random((32, 48)).astype(np.float32) * 0.1
    jd, td = _pair(noise)
    for jfn, tfn in ((JF.dark_frame_subtraction, TF.dark_frame_subtraction),
                     (JF.bias_frame_subtraction, TF.bias_frame_subtraction)):
        np.testing.assert_array_equal(tfn(tf, td).bayer.numpy(), np.asarray(jfn(jf, jd).bayer))


# --- HDR ------------------------------------------------------------------------------


def _brackets(h, w, n=5, seed=11):
    """n exposures of one scene a stop apart (EV falls as the exposure grows)."""
    scene = mosaic_rggb(make_scene(h, w, seed=seed))
    return [np.clip(scene * 2.0 ** (k - 2), 0.0, 1.0).astype(np.float32) for k in range(n)], \
        [12.0 - k for k in range(n)]


@pytest.mark.parametrize("target_ev", [None, 9.5])
def test_stack_frames_and_fuse_to_raw(target_ev):
    bayers, evs = _brackets(32, 48)
    pairs = [_pair(b, cam_mat=CAM, wb_neutral=WB, ev=ev) for b, ev in zip(bayers, evs)]
    jburst = _jax_burst([p[0] for p in pairs])
    tburst = stack_frames([p[1] for p in pairs], device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tburst, k).numpy(), np.asarray(getattr(jburst, k)))
    with jax.disable_jit():
        jhdr, jcounts = JH.fuse_exposures_to_raw(jburst, target_ev)
    thdr, tcounts = TH.fuse_exposures_to_raw(tburst, target_ev)
    np.testing.assert_allclose(thdr.bayer.numpy(), np.asarray(jhdr.bayer), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    for k in ("cam_mat", "cam_white", "wb_neutral"):
        np.testing.assert_array_equal(getattr(thdr, k).numpy(), np.asarray(getattr(jhdr, k)))
    np.testing.assert_allclose(float(thdr.ev), float(jhdr.ev), rtol=1e-6)
    np.testing.assert_allclose(float(thdr.lim_sat), float(jhdr.lim_sat), rtol=1e-6)
    assert thdr.is_hdr and float(thdr.lim_sat) > 1.0
    assert [f.bayer.data_ptr() for f in unstack_frames(tburst)][1] != tburst.bayer.data_ptr()


def test_stack_frames_defaults_to_the_card():
    _, tf = _pair(_mosaic(8, 8, seed=12))
    if torch.cuda.is_available():
        assert stack_frames([tf, tf]).bayer.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stack_frames([tf, tf])
    with pytest.raises(ValueError, match="disagree"):
        stack_frames([tf, tf.replace(bayer=tf.bayer[:4])], device="cpu")


def test_fuse_from_debayer_matches_jax():
    rng = np.random.default_rng(13)
    n, h, w = 4, 12, 16
    base = make_scene(h, w, seed=13)
    image = np.stack([np.clip(base * 2.0 ** (k - 1.5), 0, 1) for k in range(n)]).astype(np.float32)
    wb = (1.0 / WB)[None].repeat(n, 0).astype(np.float32)
    image = image * wb[:, None, None, :]
    cam = CAM[None].repeat(n, 0)
    white = np.array([0.95043, 1.0, 1.0889], np.float32)[None].repeat(n, 0)
    ev = (10.0 - np.arange(n) + rng.random(n) * 0.1).astype(np.float32)
    jimg = JaxImage(image=jnp.asarray(image), wb_coeff=jnp.asarray(wb), cam_mat=jnp.asarray(cam),
                    cam_white=jnp.asarray(white), ev=jnp.asarray(ev))
    timg = DevelopedImage(image=torch.from_numpy(image), wb_coeff=torch.from_numpy(wb),
                          cam_mat=torch.from_numpy(cam), cam_white=torch.from_numpy(white),
                          ev=torch.from_numpy(ev))
    with jax.disable_jit():
        want, wcounts = JH.fuse_exposures_from_debayer(jimg)
    got, gcounts = TH.fuse_exposures_from_debayer(timg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gcounts.numpy(), np.asarray(wcounts))


# --- denoise --------------------------------------------------------------------------


@pytest.mark.parametrize("strength,levels", [(1.0, 3), (0.5, 2), (2.0, 1), (0.0, 3)])
def test_denoise_matches_jax(strength, levels):
    rng = np.random.default_rng(14)
    bayer = _mosaic(64, 96, seed=14) + rng.normal(0, 0.02, (64, 96)).astype(np.float32)
    jf, tf = _pair(np.clip(bayer, 0, 1).astype(np.float32))
    with jax.disable_jit():
        want = np.asarray(JD.denoise_bayer_wavelet(jf, strength, levels).bayer)
    got = TD.denoise_bayer_wavelet(tf, strength, levels).bayer.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- the pipeline: BASELINE configs 3 and 4 at 64x96 -----------------------------------


def test_config_3_pipeline_matches_jax():
    """Flat field, hot-pixel detect and heal, Best develop on one frame."""
    jf, tf = _pair(_mosaic(64, 96, seed=15, hot=6), cam_mat=CAM, wb_neutral=WB)
    jflat, tflat = _pair(_flat(64, 96, "positive"))
    with jax.disable_jit():
        want = np.asarray(JPL.develop_pipeline(
            jf, JPL.PipelineConfig(flat_field=True, repair_hot_pixels=True), flat=jflat))
    got = TPL.develop_pipeline(
        tf, TPL.PipelineConfig(flat_field=True, repair_hot_pixels=True), flat=tflat)
    assert got.shape == (64, 96, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.numpy(), want) >= MIN_PSNR


def _burst_pair(hot_every_frame=0):
    bayers, evs = _brackets(64, 96, seed=16)
    rng = np.random.default_rng(16)
    sites = [(int(y), int(x)) for y, x in zip(rng.integers(0, 64, hot_every_frame),
                                            rng.integers(0, 96, hot_every_frame))]
    for b in bayers:
        for y, x in sites:
            b[y, x] = 1.0
    pairs = [_pair(b, cam_mat=CAM, wb_neutral=WB, ev=ev) for b, ev in zip(bayers, evs)]
    return _jax_burst([p[0] for p in pairs]), stack_frames([p[1] for p in pairs], device="cpu")


@pytest.mark.parametrize("shared", [None, 0.5])
def test_config_4_pipeline_matches_jax(shared):
    """Five brackets, per-frame (or consensus) hot-pixel heal, the Bayer-domain
    fuse, Best develop of the HDR frame."""
    jburst, tburst = _burst_pair(hot_every_frame=4)
    kw = dict(fuse_hdr=True, repair_hot_pixels=True, hot_pixel_shared_ratio=shared)
    with jax.disable_jit():
        want = np.asarray(JPL.develop_pipeline(jburst, JPL.PipelineConfig(**kw)))
    got = TPL.develop_pipeline(tburst, TPL.PipelineConfig(**kw))
    assert got.shape == (64, 96, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.numpy(), want) >= MIN_PSNR


@pytest.mark.parametrize("kw", [
    dict(),
    dict(repair_hot_pixels=True, hot_pixel_shared_ratio=0.5, denoise_strength=1.0),
])
def test_burst_pipeline_without_fuse_matches_jax(kw):
    jburst, tburst = _burst_pair(hot_every_frame=2)
    with jax.disable_jit():
        want = np.asarray(JPL.develop_pipeline(jburst, JPL.PipelineConfig(**kw)))
    got = TPL.develop_pipeline(tburst, TPL.PipelineConfig(**kw))
    assert got.shape == (5, 64, 96, 3)
    for i in range(5):
        assert psnr(got[i].numpy(), want[i]) >= MIN_PSNR


def test_dark_and_denoise_pipeline_matches_jax():
    jf, tf = _pair(_mosaic(64, 96, seed=17, hot=3) + 0.02, cam_mat=CAM, wb_neutral=WB)
    jdark, tdark = _pair(np.full((64, 96), 0.02, np.float32))
    kw = dict(dark_frame=True, repair_hot_pixels=True, denoise_strength=1.0)
    with jax.disable_jit():
        want = np.asarray(JPL.develop_pipeline(jf, JPL.PipelineConfig(**kw), dark=jdark))
    got = TPL.develop_pipeline(tf, TPL.PipelineConfig(**kw), dark=tdark)
    assert psnr(got.numpy(), want) >= MIN_PSNR


def test_pipeline_config_mirrors_jax():
    import dataclasses

    tf = {f.name: f.default for f in dataclasses.fields(TPL.PipelineConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(JPL.PipelineConfig)}
    assert tf.keys() == jf.keys()
    assert {k: v for k, v in tf.items() if k != "develop"} == \
        {k: v for k, v in jf.items() if k != "develop"}
    for flag in ("dark_frame", "flat_field", "repair_hot_pixels"):
        assert TPL.PipelineConfig(**{flag: True}).enables_per_frame_corrections
    assert TPL.PipelineConfig(denoise_strength=0.5).enables_per_frame_corrections
    assert not TPL.PipelineConfig(fuse_hdr=True).enables_per_frame_corrections
    _, tf1 = _pair(_mosaic(16, 16, seed=18))
    with pytest.raises(ValueError, match="burst"):
        TPL.develop_pipeline(tf1, TPL.PipelineConfig(fuse_hdr=True))
