"""Chromatic-aberration correction of pysp_tpu_torch against pysp_tpu.

Every input is built once in NumPy from a seed and handed to both packages;
the JAX functions run op by op (``jax.disable_jit()``). The tolerance of each
test is stated where it is checked (the measured value beside it):

- model fits: equal (the same NumPy code);
- radius field, coordinate fields, Newton inversion and
  ``lensfun_poly3_remap_coords``: within 1e-5 px on even shapes (the
  coordinate fields measured bit-equal);
- on an odd 21x21 plane the port is finite, equals JAX everywhere but the
  centre pixel (r = 0, NaN in JAX) and its offset there is 0;
- structural instability: equal;
- ``template_match_batch``: within 2e-4 px of JAX's and of the port's own host
  ``template_match`` (measured bit-equal to JAX's);
- scale pairs and ``compute_ca_lens_models_for_raw``'s coefficients: within
  1e-3 relative;
- ``remove_ca_from_raw``: within 1e-6 of JAX's (measured bit-equal), a burst
  equal to its frames;
- the port alone: the recovery gates of ``tests/test_ca.py``;
- the CLI's ``--ca template|gradient|refine`` on the CPU: >= 50 dB against the
  JAX chain, the AHD tie-flip floor of DIVERGENCES.md.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.correct.ca import gradfit as JG
from pysp_tpu.correct.ca import instability as JI
from pysp_tpu.correct.ca import matcher as JM
from pysp_tpu.correct.ca import models as JMod
from pysp_tpu.correct.ca import removal as JR
from pysp_tpu.correct.ca import solver as JS
from pysp_tpu.correct.ca.roi import PooledChannel as JPooled
from pysp_tpu.correct.ca.roi import RoiDetector as JRoi
from pysp_tpu.io.raw_loader import load_raw_dng as jax_load_raw_dng
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop as jax_develop
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.core.frame import RawFrame, stack_frames, unstack_frames
from pysp_tpu_torch.correct.ca import instability as TI
from pysp_tpu_torch.correct.ca import matcher as TM
from pysp_tpu_torch.correct.ca import models as TMod
from pysp_tpu_torch.correct.ca import removal as TR
from pysp_tpu_torch.correct.ca import solver as TS
from pysp_tpu_torch.correct.ca.roi import PooledChannel, RoiDetector
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.io.image_out import to_uint16
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.ops.resample import remap_bilinear
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr, ring_chart

torch.set_num_threads(1)

FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
WB = np.array([0.5, 1.0, 0.6], np.float32)
COORD_ATOL = 1e-5      # px
MATCH_ATOL = 2e-4      # px, and in normalized radius for the scale pairs (tests/test_ca.py)
FIT_RTOL = 1e-3
REMOVE_ATOL = 1e-6
MIN_PSNR = 50.0

MODELS = {
    "poly3": ((0.02,), TMod.Poly3CorrectionModel, JMod.Poly3CorrectionModel),
    "poly3_neg": ((-0.01,), TMod.Poly3CorrectionModel, JMod.Poly3CorrectionModel),
    "poly5": ((0.015, -0.008), TMod.Poly5CorrectionModel, JMod.Poly5CorrectionModel),
    "ptlens": ((0.01, -0.02, 0.015), TMod.PtLensCorrectionModel,
               JMod.PtLensCorrectionModel),
}


def _models(name):
    coeffs, tcls, jcls = MODELS[name]
    return tcls(*coeffs), jcls(*coeffs)


def _pair(bayer, wb=WB):
    """The same frame for both packages: (JAX frame, port frame on the CPU)."""
    jf = JaxFrame.synthetic(jnp.asarray(bayer), wb_neutral=wb)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS), device="cpu")
    return jf, tf


# --- models ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["poly3", "poly5", "ptlens"])
def test_model_fits_equal(name):
    rng = np.random.default_rng(0)
    r_ud = np.sort(rng.uniform(0.1, 1.0, 40))
    r_d = r_ud * (1 + 0.01 * r_ud**2) + rng.normal(0, 1e-5, 40)
    pairs = np.stack([r_d, r_ud], axis=1)
    got, want = (cls() for cls in MODELS[name][1:])
    assert got.compute_coefficients(pairs) and want.compute_coefficients(pairs)
    np.testing.assert_array_equal(got.get_coefficients(), want.get_coefficients())


def test_radius_field_matches():
    """Within 1e-7, a float32 ulp at 1 (measured 6.0e-8 on 12 of 6144 pixels,
    printed: XLA divides by the constant corner radius as a multiply)."""
    worst = 0.0
    for shape in ((12, 16), (21, 21), (64, 96)):
        got = TMod.radius_field(shape, device="cpu").numpy()
        want = np.asarray(JMod.radius_field(shape))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"radius field: {worst:.3g} apart at most")


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("direction", ["distorted", "undistorted"])
@pytest.mark.parametrize("shape", [(16, 20), (64, 96)])
def test_coordinate_fields_match(name, direction, shape):
    """Measured: bit-equal."""
    tm, jm = _models(name)
    attr = f"get_{direction}_coordinates"
    got = getattr(tm, attr)(torch.zeros(shape)).numpy()
    with jax.disable_jit():
        want = np.asarray(getattr(jm, attr)(jnp.zeros(shape)))
    assert got.shape == shape + (2,)
    print(f"{name} {direction} {shape}: {np.abs(got - want).max():.3g} px apart")
    np.testing.assert_allclose(got, want, rtol=0, atol=COORD_ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_newton_inversion_matches(name):
    tm, jm = _models(name)
    r = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    got = tm.estimate_undistorted(torch.from_numpy(r)).numpy()
    with jax.disable_jit():
        want = np.asarray(jm.estimate_undistorted(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=0, atol=COORD_ATOL)
    np.testing.assert_allclose(tm.get_distorted(torch.from_numpy(got)).numpy(), r, atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_coordinate_windows_are_rows_of_the_field(name):
    tm, _ = _models(name)
    full = tm.get_distorted_coordinates(torch.zeros(40, 52))
    inv = tm.get_undistorted_coordinates(torch.zeros(40, 52))
    for row0, n in ((0, 8), (13, 9), (32, 8)):
        np.testing.assert_array_equal(
            tm.get_distorted_coordinates_window(n, row0, (40, 52), device="cpu").numpy(),
            full[row0:row0 + n].numpy())
        np.testing.assert_array_equal(
            tm.get_undistorted_coordinates_window(n, row0, (40, 52), device="cpu").numpy(),
            inv[row0:row0 + n].numpy())


# The remap kernel's radial forms: MODELS, the mf102 configuration's k1 and a
# strong Poly3 either way.
KERNEL_FORM_MODELS = {
    **{name: (coeffs, tcls) for name, (coeffs, tcls, _) in MODELS.items()},
    "poly3_mf102_r": ((0.000714,), TMod.Poly3CorrectionModel),
    "poly3_mf102_b": ((-0.000714,), TMod.Poly3CorrectionModel),
    "poly3_strong": ((0.3,), TMod.Poly3CorrectionModel),
    "poly3_strong_neg": ((-0.3,), TMod.Poly3CorrectionModel),
}


def _kernel_form_model(name):
    coeffs, tcls = KERNEL_FORM_MODELS[name]
    return tcls(*coeffs)


def _scalar_rounded(value: float) -> float:
    """What PyTorch multiplies a float32 tensor by for the Python scalar
    ``value``."""
    return (torch.ones(1) * value).item()


@pytest.mark.parametrize("name", list(KERNEL_FORM_MODELS))
def test_kernel_form_constants_are_pytorchs_scalar_rounding(name):
    """Each Newton model's constants are the float32 values PyTorch rounds the
    Python scalars of its expressions to, in ``radial_plain``'s order."""
    model = _kernel_form_model(name)
    kind, got = model.kernel_form()
    assert got.dtype == np.float32 and len(got) == K.RADIAL_FORMS[kind]
    c = [float(v) for v in model.get_coefficients()]
    want = {"poly3": lambda k1: (k1, 1.0 - k1, 3.0 * k1),
            "poly5": lambda h1, h2: (h1, h2, 3.0 * h1, 5.0 * h2),
            "ptlens": lambda a, b, c: (a, b, c, 1.0 - a - b - c, 3.0 * b, 2.0 * c)}[kind](*c)
    assert [float(v) for v in got] == [_scalar_rounded(v) for v in want]


@pytest.mark.parametrize("name", list(KERNEL_FORM_MODELS))
def test_kernel_form_evaluates_as_the_model(name):
    """The form's plain f and its Newton inverse, from the float32 constants in
    the kernel's order of operations, equal the model's own methods bit for
    bit on radii from 0 to past the corner."""
    model = _kernel_form_model(name)
    form = model.kernel_form()
    u = torch.from_numpy(np.linspace(0.0, 1.25, 4001, dtype=np.float32))
    assert torch.equal(K.radial_plain(form, u), model.get_distorted(u))
    assert torch.equal(K.radial_inverse_plain(form, u), model.estimate_undistorted(u))


def _card_rounded_model_maps(model, inverse, h, w):
    """``_maps_from_offsets(model.get_*_coordinates(...))`` with the card's
    rounding of the radius: PyTorch on the card divides by the Python scalar
    ``r_corner`` as a multiply by the float32 rounding of its reciprocal
    (taken in double), on the CPU it divides; the card's float32 square root
    is IEEE's, the CPU's vectorised one not always."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32) - cy)[:, None]
    xs = (torch.arange(w, dtype=torch.float32) - cx)[None, :]
    inv = float(np.float32(1.0 / np.hypot(cy, cx)))
    r = torch.sqrt((ys * ys + xs * xs).double()).float() * inv
    fn = model.estimate_undistorted if inverse else model.get_distorted
    scale = TMod.radial_scale(r, fn)
    coords = torch.stack([ys.expand(h, w) * scale, xs.expand(h, w) * scale], dim=-1)
    return TR._maps_from_offsets(coords, h, w)


@pytest.mark.parametrize("name", list(KERNEL_FORM_MODELS))
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(21, 21), (37, 50), (24, 71), (64, 96)])
def test_radial_maps_plain_are_the_model_maps(name, inverse, shape):
    """The radial kernel's plain maps from a model's form are the model's own
    coordinate maps as the card rounds them, bit for bit, the centre pixel of
    the odd-by-odd plane included; on the CPU they lie within a float32
    rounding of the radius of the CPU's own maps."""
    model = _kernel_form_model(name)
    got = K.radial_maps_plain(model.kernel_form(), inverse, *shape, "cpu")
    for g, want in zip(got, _card_rounded_model_maps(model, inverse, *shape)):
        assert torch.equal(g, want)
    h, w = shape
    fn = model.get_undistorted_coordinates if inverse else model.get_distorted_coordinates
    for g, want in zip(got, TR._maps_from_offsets(fn(torch.zeros(shape)), h, w)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_the_base_model_has_no_kernel_form():
    """A reversible model that states no radial form gives None."""

    class Scaled(TMod.CaCorrectionModel, TMod.ReversibleModelMixin):
        def compute_coefficients(self, r_distorted_undistorted):
            return True

        def get_coefficients(self):
            return np.array((1.01,))

        def get_distorted(self, undistorted):
            return undistorted * 1.01

        def estimate_undistorted(self, distorted, max_iterations=8, max_epsilon=1e-5):
            return distorted / 1.01

    assert Scaled().kernel_form() is None


@pytest.mark.parametrize("coeffs", [(0.0, 0.0, 1.0), (0.01, -0.02, 1.01), (-0.03, 0.01, 1.02)])
@pytest.mark.parametrize("shape", [(10, 14), (48, 64)])
def test_lensfun_poly3_remap_coords_match(coeffs, shape):
    got = TMod.lensfun_poly3_remap_coords(shape, *coeffs, device="cpu")
    with jax.disable_jit():
        want = JMod.lensfun_poly3_remap_coords(shape, *coeffs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=COORD_ATOL)
    if coeffs == (0.0, 0.0, 1.0):
        xs, ys = np.meshgrid(np.arange(shape[1], dtype=np.float32),
                             np.arange(shape[0], dtype=np.float32))
        np.testing.assert_allclose(got[0].numpy(), xs, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), ys, atol=1e-4)


ODD = (21, 21)
CENTRE = (10, 10)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("direction", ["distorted", "undistorted"])
def test_odd_plane_centre_has_zero_offset(name, direction):
    """At r = 0 the JAX field is NaN (0/0); the port's offset is 0 there and
    equals JAX's everywhere else."""
    tm, jm = _models(name)
    attr = f"get_{direction}_coordinates"
    got = getattr(tm, attr)(torch.zeros(ODD)).numpy()
    with jax.disable_jit():
        want = np.asarray(getattr(jm, attr)(jnp.zeros(ODD)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[CENTRE], [0.0, 0.0])
    nan = ~np.isfinite(want)
    assert nan[CENTRE].all() and nan.sum() == 2
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=COORD_ATOL)


def test_odd_plane_lensfun_centre_maps_to_itself():
    got = TMod.lensfun_poly3_remap_coords(ODD, 0.01, -0.02, 1.01, device="cpu")
    with jax.disable_jit():
        want = JMod.lensfun_poly3_remap_coords(ODD, 0.01, -0.02, 1.01)
    for g, w, c in zip(got, want, (CENTRE[1], CENTRE[0])):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all() and g[CENTRE] == c
        nan = ~np.isfinite(w)
        assert nan[CENTRE] and nan.sum() == 1
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=0, atol=COORD_ATOL)


# --- instability -----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 20), (30, 42)])
def test_structural_instability_equal(shape):
    bayer = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    jf, tf = _pair(bayer)
    with jax.disable_jit():
        want = np.asarray(JI.compute_structural_instability(jf))
    got = TI.compute_structural_instability(tf)
    assert got.shape == shape + (3,)
    np.testing.assert_array_equal(got.numpy(), want)


# --- matcher and solver ----------------------------------------------------------------


def _plant(img, k1):
    """``img`` sampled through Poly3(k1)'s inverse field, as tests/test_ca.py
    plants CA: what ``remove_ca_from_raw`` with Poly3(k1) undoes."""
    h, w = img.shape
    coords = TMod.Poly3CorrectionModel(k1).get_undistorted_coordinates(torch.zeros(h, w))
    return remap_bilinear(torch.from_numpy(img), *TR._maps_from_offsets(coords, h, w)).numpy()


def _distorted_ring(size, k1, radii=(70, 110, 150)):
    """A ring chart and its copy with Poly3(k1) CA planted."""
    img = ring_chart(size, size, radii=radii, amp=0.5, base=0.25)
    return img, _plant(img, k1)


@pytest.fixture(scope="module")
def ring_bins():
    img, distorted = _distorted_ring(384, 0.03)
    pool = PooledChannel(distorted)
    detector = RoiDetector(pool, default_threshold=16)
    jpool = JPooled(distorted)
    jdetector = JRoi(jpool, default_threshold=16)
    return img, pool, detector, jpool, jdetector


def test_roi_detector_bins_equal(ring_bins):
    _, _, detector, _, jdetector = ring_bins
    assert [len(b) for b in detector.bins] == [len(b) for b in jdetector.bins]
    for b, jb in zip(detector.bins, jdetector.bins):
        for t, jt in zip(b, jb):
            np.testing.assert_array_equal(t.offset_real_tl, jt.offset_real_tl)
            assert t.average_n == jt.average_n


def test_template_match_batch_matches_jax_and_host(ring_bins):
    """The scale pairs through the port's device batch, JAX's device batch and
    the port's float64 host loop. Measured: bit-equal to JAX's (the tile
    errors are summed in the order of JAX's reduction run op by op), 2.9e-5
    from the host loop (in normalized radius: 0.008 px)."""
    img, pool, detector, jpool, jdetector = ring_bins
    dev = TS.get_radius_scale_factors_from_bins(detector, pool, torch.from_numpy(img),
                                                max_reach=0.05, device=True)
    host = TS.get_radius_scale_factors_from_bins(detector, pool, img, max_reach=0.05,
                                                 device=False)
    with jax.disable_jit():
        want = JS.get_radius_scale_factors_from_bins(jdetector, jpool, img, max_reach=0.05,
                                                     device=True)
    assert dev.shape == host.shape == want.shape and len(dev) > 4
    print(f"scale pairs: {np.abs(dev - want).max():.3g} from JAX's, "
          f"{np.abs(dev - host).max():.3g} from the host loop")
    np.testing.assert_allclose(dev, want, rtol=0, atol=MATCH_ATOL)
    np.testing.assert_allclose(dev, host, rtol=0, atol=MATCH_ATOL)
    np.testing.assert_allclose(dev, want, rtol=FIT_RTOL, atol=0)


def test_template_match_batch_positions():
    """The refined positions themselves, one tile a bin, against JAX's."""
    rng = np.random.default_rng(3)
    target = rng.random((64, 64)).astype(np.float32)
    tiles = np.stack([target[24:40, 30:46], target[10:26, 8:24], target[33:49, 40:56]])
    starts = np.array([[21.0, 27.0], [7.5, 5.25], [30.2, 37.9]])
    vecs = np.full((3, 2), 6.0 / np.sqrt(72) / 4)
    pos = starts[:, None] + np.arange(64)[None, :, None] * vecs[:, None]
    mask = np.arange(64)[None] < np.array([[25], [30], [64]])
    got = TM.template_match_batch(torch.from_numpy(target), tiles, pos, mask, vecs).numpy()
    with jax.disable_jit():
        want = np.asarray(JM.template_match_batch(target, tiles, pos, mask, vecs))
    np.testing.assert_allclose(got, want, rtol=0, atol=MATCH_ATOL)
    np.testing.assert_allclose(got[0], [24.0, 30.0], atol=0.3)


def _ca_frame(h, w, k_r, k_b):
    """An RGGB mosaic of a ring chart with R sampled through Poly3(k_r)'s
    inverse field and B through Poly3(k_b)'s (``None``: left clean)."""
    size = min(h, w)
    img = ring_chart(h, w, radii=tuple(int(size * f) for f in (0.23, 0.33, 0.41)),
                     amp=0.6, base=0.1) + 0.1
    rgb = np.dstack([img, img, img]).astype(np.float32)
    for c, k in ((0, k_r), (2, k_b)):
        if k is not None:
            rgb[..., c] = _plant(img, k)
    return mosaic_rggb(rgb)


def test_blind_fit_defaults_to_poly5_and_recovers_the_sign():
    """``tests/test_ca.py``'s gate on the port alone: 0.002 < k1 < 0.08."""
    bayer = _ca_frame(256, 256, 0.02, None)
    _, tf = _pair(bayer, wb=np.ones(3, np.float32))
    model_r, model_b = TR.compute_ca_lens_models_for_raw(
        tf, TMod.Poly3CorrectionModel(), None, max_distortion_additional_scale=0.03)
    assert isinstance(model_b, TMod.Poly5CorrectionModel)
    assert 0.002 < float(model_r.get_coefficients()[0]) < 0.08


# --- removal ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["both", "r", "b", "none"])
@pytest.mark.parametrize("name", ["poly3", "poly5", "ptlens"])
def test_remove_ca_matches_jax(name, which):
    """Measured: bit-equal to the JAX package on every sample."""
    bayer = mosaic_rggb(make_scene(64, 96, seed=5))
    jf, tf = _pair(bayer)
    tm, jm = _models(name)
    tb, jb = _models("poly3_neg")
    pick = {"both": (0, 1), "r": (0,), "b": (1,), "none": ()}[which]
    targs = [m if k in pick else None for k, m in enumerate((tm, tb))]
    jargs = [m if k in pick else None for k, m in enumerate((jm, jb))]
    got = TR.remove_ca_from_raw(tf, *targs)
    with jax.disable_jit():
        want = np.asarray(JR.remove_ca_from_raw(jf, *jargs).bayer)
    print(f"{name} {which}: {np.abs(got.bayer.numpy() - want).max():.3g} apart")
    np.testing.assert_allclose(got.bayer.numpy(), want, rtol=0, atol=REMOVE_ATOL)
    if which == "none":
        assert got is tf
    # the greens never move
    np.testing.assert_array_equal(got.bayer[0::2, 1::2].numpy(), bayer[0::2, 1::2])
    np.testing.assert_array_equal(got.bayer[1::2, 0::2].numpy(), bayer[1::2, 0::2])


@pytest.mark.parametrize("which", ["both", "r", "b"])
def test_remove_ca_burst_equals_its_frames(which):
    frames = [RawFrame.from_numpy(mosaic_rggb(make_scene(48, 64, seed=s)), np.eye(3),
                                  (0.95, 1.0, 1.09), WB * (1 + 0.1 * s), 10.0, 1.0,
                                  device="cpu") for s in range(3)]
    model_r, model_b = TMod.Poly3CorrectionModel(0.03), TMod.Poly5CorrectionModel(-0.01, 0.004)
    models = {"both": (model_r, model_b), "r": (model_r, None), "b": (None, model_b)}[which]
    burst = TR.remove_ca_from_raw(stack_frames(frames, device="cpu"), *models)
    assert burst.bayer.shape == (3, 48, 64)
    for f, got in zip(frames, unstack_frames(burst)):
        assert torch.equal(got.bayer, TR.remove_ca_from_raw(f, *models).bayer)
        assert torch.equal(got.wb_neutral, f.wb_neutral)


def test_remove_ca_remaps_through_the_kernel_wrapper(monkeypatch):
    """Each remap is one call of ``remap_kernel`` over the whole burst, with
    maps shared by the frames and no bounds: 4 calls for two models, 2 for one."""
    calls = []

    def spy(img, map_x, map_y, kind="bilinear", bounds=None, channels_last=False):
        calls.append((tuple(img.shape), tuple(map_x.shape), kind, bounds))
        return K.remap_plain(img, map_x, map_y, kind, bounds, channels_last)

    monkeypatch.setattr(TR, "remap_kernel", spy)
    frames = [RawFrame.synthetic(mosaic_rggb(make_scene(32, 48, seed=s)), device="cpu")
              for s in range(4)]
    burst = stack_frames(frames, device="cpu")
    model = TMod.Poly3CorrectionModel(0.02)
    TR.remove_ca_from_raw(burst, model, model)
    assert calls == [((4, 32, 48), (32, 48), "bilinear", None)] * 4
    calls.clear()
    TR.remove_ca_from_raw(frames[0], None, model)
    assert calls == [((1, 32, 48), (32, 48), "bilinear", None)] * 2


def test_remove_ca_refuses_a_model_it_cannot_invert():
    class ForwardOnly(TMod.CaCorrectionModel):
        def compute_coefficients(self, pairs):
            return True

        def get_coefficients(self):
            return np.zeros(1)

        def get_distorted(self, und):
            return und

    _, tf = _pair(mosaic_rggb(make_scene(16, 16, seed=1)))
    with pytest.raises(ValueError, match="Blue lens model is not reversible"):
        TR.remove_ca_from_raw(tf, TMod.Poly3CorrectionModel(0.01), ForwardOnly())
    with pytest.raises(ValueError, match="Red lens model is not reversible"):
        TR.remove_ca_from_raw(tf, ForwardOnly(), None)


def test_remove_ca_improves_alignment():
    """``tests/test_ca.py``'s gate on the port alone: R distorted by Poly3(0.08)
    (about 3 px at mid radius), corrected with the true model, lies closer to
    the clean R than before by more than half."""
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    r_px = np.hypot(yy - (h - 1) / 2, xx - (w - 1) / 2)
    img = (0.2 + sum(0.5 * np.exp(-0.5 * ((r_px - rad) / 2.5) ** 2)
                     for rad in (25, 40, 52))).astype(np.float32)
    rgb = np.dstack([img, img, img])
    rgb_ca = rgb.copy()
    rgb_ca[..., 0] = _plant(img, 0.08)
    bayer = mosaic_rggb(rgb_ca)
    fixed = TR.remove_ca_from_raw(RawFrame.synthetic(bayer, device="cpu"),
                                  TMod.Poly3CorrectionModel(0.08), None).bayer.numpy()
    clean_r = rgb[0::2, 0::2, 0]
    before = np.abs(bayer[0::2, 0::2] - clean_r)[4:-4, 4:-4].mean()
    after = np.abs(fixed[0::2, 0::2] - clean_r)[4:-4, 4:-4].mean()
    assert after < before * 0.5, (before, after)
    np.testing.assert_array_equal(fixed[0::2, 1::2], bayer[0::2, 1::2])


# --- the CLI ---------------------------------------------------------------------------


def _read_rgb16(path) -> np.ndarray:
    tf = T.read_tiff(str(path))
    ifd = tf.ifds[0]
    h = ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    w = ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    (offset,) = ifd.require(T.TAG_STRIP_OFFSETS).as_ints()
    data = np.frombuffer(tf.data, dtype=tf.endian + "u2", count=h * w * 3, offset=offset)
    return data.reshape(h, w, 3)


def _jax_gradient_models(frame, models, steps, learning_rate):
    """The JAX package's ``fit_radial_gradient`` of the mean G plane onto each
    of R and B, seeded with ``models``' coefficients, as models of their
    classes: the port's frame-level gradient fit (``JG.fit_ca_models_gradient``
    aligns the other way and fits the inverse model; ROADMAP.md queue C)."""
    from pysp_tpu.core.bayer import bayer_to_rgbg

    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    out = []
    for plane, model in zip((r0, b0), models):
        kind = JG._kind_of_model(model)
        theta, _ = JG.fit_radial_gradient(g, plane, kind, np.asarray(
            model.get_coefficients(), np.float32), steps=steps, learning_rate=learning_rate)
        out.append(JG._KINDS[kind][3](theta))
    return tuple(out)


@pytest.fixture(scope="module")
def ca_dng(tmp_path_factory):
    """A 256x384 RGGB DNG of a ring chart with R and B displaced radially, and
    the JAX package's fits on it: the template fit op by op, the gradient fit
    and the refinement jitted (op by op they take minutes; their coefficients
    are within 1e-4 of the port's, tests/test_torch_gradfit.py)."""
    bayer = _ca_frame(256, 384, 0.02, -0.01)
    u16 = (200 + np.clip(bayer, 0, 1) * 3800).astype(np.uint16)
    path = tmp_path_factory.mktemp("ca") / "rings.dng"
    path.write_bytes(T.write_synthetic_dng(u16))
    frame = jax_load_raw_dng(path.read_bytes())
    with jax.disable_jit():
        template = JR.compute_ca_lens_models_for_raw(frame)
    zero = (JMod.Poly3CorrectionModel(), JMod.Poly3CorrectionModel())
    fits = {"template": template,
            "gradient": _jax_gradient_models(frame, zero, 80, 2e-3),
            "refine": _jax_gradient_models(frame, template, 40, 5e-4)}
    return path, frame, fits


def test_blind_fit_matches_jax(ca_dng):
    """The default Poly5 fits of R and B on the DNG: the scale pairs are
    bit-equal to JAX's run op by op (measured), so the coefficients are equal
    (gate: 1e-3 relative)."""
    from pysp_tpu_torch.io.raw_loader import load_raw

    path, _, fits = ca_dng
    got = TR.compute_ca_lens_models_for_raw(load_raw(str(path), device="cpu"))
    for g, w in zip(got, fits["template"]):
        assert isinstance(g, TMod.Poly5CorrectionModel)
        np.testing.assert_allclose(g.get_coefficients(), w.get_coefficients(),
                                   rtol=FIT_RTOL, atol=0)
        np.testing.assert_array_equal(g.get_coefficients(), w.get_coefficients())


@pytest.mark.parametrize("mode", ["template", "gradient", "refine"])
def test_cli_ca_matches_the_jax_chain(ca_dng, tmp_path, mode, capsys):
    from pysp_tpu.const import QualityDemosaic

    path, frame, fits = ca_dng
    out = tmp_path / f"{mode}.tif"
    assert main(["develop", str(path), "-o", str(out), "--device", "cpu",
                 "--quality", "fast", "--ca", mode]) == 0
    assert "CA fit failed" not in capsys.readouterr().err
    got = _read_rgb16(out)

    with jax.disable_jit():
        img = np.asarray(jax_develop(JR.remove_ca_from_raw(frame, *fits[mode]),
                                     JaxConfig(quality=QualityDemosaic.Fast)))
    want = to_uint16(img)
    assert got.shape == want.shape == (256, 384, 3)
    assert psnr(got.astype(np.float64) / 65535, want.astype(np.float64) / 65535) >= MIN_PSNR
