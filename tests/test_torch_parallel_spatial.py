"""Row-sharded corrections, CA, develop and warp
(pysp_tpu_torch.parallel.spatial_pipeline) against pysp_tpu's on the CPU.

The JAX functions run jitted on the eight virtual CPU devices of
tests/conftest.py, the port on a mesh of ``"cpu"`` repeated; every input is
built once in NumPy from a seed. One case here for each non-TPU case of
tests/test_parallel_spatial.py, at its sizes, plus the host setup the halo
rests on. Tolerances:

- the windowed coordinate fields and warp tables: bit-equal to slices of the
  port's full ones, and within 1e-5 px of the JAX package's
  (tests/test_torch_ca.py's and tests/test_torch_warp.py's bound);
- ``_model_bound_px``, ``_ca_setup``'s bounds and ``required_spatial_halo``:
  equal to the JAX package's;
- Fast and Draft develops: within 1e-5 of the JAX result; the compositions
  with CA or the warp within 3e-5, the JAX test's own gate (the port's eager
  composition differs from JAX's by up to 5.4e-6 before JAX's jit moves it);
- Best: >= 40 dB against JAX's jitted result;
- against the port's own monolithic composition: the JAX test's gate (3e-5)
  on its interior rows (``-s`` prints the maxima). These are not 0, as they
  are for ``develop_spatial`` and the batch-sharded pipeline: the row-sharded
  CA and warp re-base their maps by the block's row offset in float32, as
  the JAX package does, and ``map_y - b0`` rounds where it crosses a power of
  two (7.6e-6 px at 128 px), and the corrections' statistics sum in another
  order (5.0e-6 and 3.5e-6 measured);
- each rejection with the JAX message.

Left out: ``test_col_rects_for_medium_format_only``, which tests the TPU's
in-shard column rectangles (not carried: Hopper gathers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.const import QualityDemosaic as JQ
from pysp_tpu.correct.ca import models as JM
from pysp_tpu.correct.ca import removal as JR
from pysp_tpu.parallel import pipeline_sharded as JPS
from pysp_tpu.parallel import spatial_pipeline as JSPP
from pysp_tpu.parallel.mesh import make_mesh as jax_mesh
from pysp_tpu.pipeline.develop import DevelopConfig as JaxDevelopConfig
from pysp_tpu.pipeline.pipeline import PipelineConfig as JaxPipelineConfig
from pysp_tpu.warp import rectilinear as JW
from pysp_tpu_torch import (
    DevelopConfig,
    PipelineConfig,
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
    QualityDemosaic,
    RawFrame,
    develop_pipeline,
    encode_warp_rectilinear,
    stack_frames,
)
from pysp_tpu_torch.correct.ca.removal import _model_bound_px
from pysp_tpu_torch.parallel import spatial_pipeline as SPP
from pysp_tpu_torch.parallel.pipeline_sharded import develop_pipeline_sharded
from pysp_tpu_torch.parallel.spatial_pipeline import (
    develop_frame_spatial,
    required_spatial_halo,
)
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr
from pysp_tpu_torch.warp import rectilinear as TW

from test_torch_parallel import (
    BEST_MIN_PSNR,
    COMPOSED_ATOL,
    TIER_ATOL,
    WARP_COEFFS,
    _close,
    _monolithic,
    _pair,
    _q,
    cpu_mesh,
)

torch.set_num_threads(1)

COORD_ATOL = 1e-5


# --- the windowed coordinate primitives ---------------------------------------------------


def test_ca_window_coordinates_match_slices():
    model, jmodel = Poly3CorrectionModel(0.012), JM.Poly3CorrectionModel(0.012)
    h, w = 96, 64
    probe = torch.zeros((h, w))
    full_fwd = model.get_distorted_coordinates(probe)
    full_inv = model.get_undistorted_coordinates(probe)
    for r0, n in ((0, 16), (30, 32), (70, 26)):
        win_fwd = model.get_distorted_coordinates_window(n, r0, (h, w), "cpu")
        win_inv = model.get_undistorted_coordinates_window(n, r0, (h, w), "cpu")
        assert torch.equal(win_fwd, full_fwd[r0:r0 + n])
        assert torch.equal(win_inv, full_inv[r0:r0 + n])
        np.testing.assert_allclose(
            win_fwd.numpy(), np.asarray(jmodel.get_distorted_coordinates_window(n, r0, (h, w))),
            rtol=0, atol=COORD_ATOL)
        np.testing.assert_allclose(
            win_inv.numpy(),
            np.asarray(jmodel.get_undistorted_coordinates_window(n, r0, (h, w))),
            rtol=0, atol=COORD_ATOL)


def test_warp_table_window_matches_slices():
    h, w = 80, 112
    fx, fy = TW.compute_remapping_table(WARP_COEFFS, w, h, (0.5, 0.5), 0.9, device="cpu")
    for r0, n in ((0, 20), (24, 40), (56, 24)):
        wx, wy = TW.compute_remapping_table_window(WARP_COEFFS, w, h, (0.5, 0.5), 0.9, r0, n,
                                                   device="cpu")
        assert torch.equal(wx, fx[r0:r0 + n]) and torch.equal(wy, fy[r0:r0 + n])
        jx, jy = JW.compute_remapping_table_window(WARP_COEFFS, w, h, (0.5, 0.5), 0.9, r0, n)
        np.testing.assert_allclose(wx.numpy(), np.asarray(jx), rtol=0, atol=COORD_ATOL)
        np.testing.assert_allclose(wy.numpy(), np.asarray(jy), rtol=0, atol=COORD_ATOL)


def test_windows_above_the_frame_continue_the_field():
    """A shard's block starts above the frame (row0 < 0 on the top shard):
    the window continues the field there, and its rows inside the frame are
    the full field's."""
    model = Poly5CorrectionModel(0.004, -0.001)
    h, w = 64, 48
    full = model.get_distorted_coordinates(torch.zeros((h, w)))
    win = model.get_distorted_coordinates_window(24, -8, (h, w), "cpu")
    assert torch.equal(win[8:], full[:16])
    jwin = np.asarray(JM.Poly5CorrectionModel(0.004, -0.001)
                      .get_distorted_coordinates_window(24, -8, (h, w)))
    np.testing.assert_allclose(win.numpy(), jwin, rtol=0, atol=COORD_ATOL)
    wx, wy = TW.compute_remapping_table_window(WARP_COEFFS, w, h, (0.5, 0.5), 1.0, -8, 24,
                                               device="cpu")
    fx, fy = TW.compute_remapping_table(WARP_COEFFS, w, h, (0.5, 0.5), 1.0, device="cpu")
    assert torch.equal(wx[8:], fx[:16]) and torch.equal(wy[8:], fy[:16])


# --- the host setup ------------------------------------------------------------------------


@pytest.mark.parametrize("kind,coeffs", [
    ("Poly3", (0.01,)), ("Poly3", (-0.02,)), ("Poly3", (0.1,)), ("Poly5", (0.004, -0.001)),
    ("PtLens", (0.002, -0.004, 0.001)),
])
@pytest.mark.parametrize("shape,cap", [((256, 96), 12), ((1000, 1504), 24),
                                       ((8736, 11648), 24), ((512, 128), 24)])
def test_model_bound_px_matches_jax(kind, coeffs, shape, cap):
    port = {"Poly3": Poly3CorrectionModel, "Poly5": Poly5CorrectionModel,
            "PtLens": PtLensCorrectionModel}[kind](*coeffs)
    jmodel = getattr(JM, f"{kind}CorrectionModel")(*coeffs)
    assert _model_bound_px(port, *shape, cap=cap) == JR._model_bound_px(jmodel, *shape, cap=cap)


def test_required_spatial_halo_accounting():
    """The JAX test's accounting, and the port's halo equal to JAX's for the
    same configurations and plans."""
    cfgs = [
        (PipelineConfig(repair_hot_pixels=True, denoise_strength=1.0),
         JaxPipelineConfig(repair_hot_pixels=True, denoise_strength=1.0)),
        (PipelineConfig(), JaxPipelineConfig()),
        (PipelineConfig(repair_hot_pixels=True, hot_pixel_iterations=6, denoise_levels=4,
                        denoise_strength=0.5, flat_field=True, dark_frame=True),
         JaxPipelineConfig(repair_hot_pixels=True, hot_pixel_iterations=6, denoise_levels=4,
                           denoise_strength=0.5, flat_field=True, dark_frame=True)),
    ]
    plans = [
        ((None, None), [], "lanczos4"),
        ((None, None), [], "bilinear"),
        (((5, "bilinear", "bilinear"), None), [], "bilinear"),
        ((None, None), [((WARP_COEFFS,) * 3, (0.5, 0.5), ((-6, 6), (-6, 6)), "lanczos4")],
         "lanczos4"),
        (((3, "bilinear", "bilinear"), (7, "bilinear", "bilinear")),
         [((WARP_COEFFS,) * 3, (0.5, 0.5), ((-9, 4), (-6, 6)), "bilinear")], "bilinear"),
    ]
    for cfg, jcfg in cfgs:
        for setups, ops, interp in plans:
            assert (required_spatial_halo(cfg, setups, ops, interp)
                    == JSPP.required_spatial_halo(jcfg, setups, ops, interp))
    halo = required_spatial_halo(cfgs[0][0], (None, None), [], "lanczos4")
    base = required_spatial_halo(PipelineConfig(), (None, None), [], "bilinear")
    assert halo % 2 == 0 and halo > base
    assert required_spatial_halo(PipelineConfig(), ((5, "bilinear", "bilinear"), None), [],
                                 "bilinear") > base
    assert required_spatial_halo(PipelineConfig(), (None, None), plans[3][1], "lanczos4") > base


def test_setups_match_jax():
    """``_ca_setup``'s bound and ``_warp_setup``'s bounds are the JAX package's."""
    h, w = 256, 96
    for k1 in (0.01, -0.02):
        got = SPP._ca_setup(Poly3CorrectionModel(k1), h, w)
        want = JSPP._ca_setup(JM.Poly3CorrectionModel(k1), h, w)
        assert got[0] == want[0] and got[1:] == ("bilinear", "bilinear")
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.45, 0.55))
    for interp in ("bilinear", "lanczos4"):
        got = SPP._warp_setup(block, h, w, 1.0, interp)
        want = JSPP._warp_setup(block, h, w, 1.0, interp)
        assert [op[2] for op in got] == [op[2] for op in want]
        assert [op[3] for op in got] == [interp]


# --- the sharded single-frame pipeline --------------------------------------------------


def test_frame_spatial_config5_parity():
    """CA + Best develop + rectilinear warp row-sharded over 4 shards."""
    h, w = 256, 96
    jf, tf = _pair(mosaic_rggb(make_scene(h, w, seed=90)))
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    jq, tq = _q("Best")
    jmodel, model = JM.Poly3CorrectionModel(0.01), Poly3CorrectionModel(0.01)
    want = np.asarray(JSPP.develop_frame_spatial(
        jf, jax_mesh((1, 4)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq)),
        ca_model_r=jmodel, ca_model_b=jmodel, warp_block=block,
        warp_interpolation="bilinear"))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq))
    got = develop_frame_spatial(tf, cpu_mesh((1, 4)), cfg, ca_model_r=model, ca_model_b=model,
                                warp_block=block, warp_interpolation="bilinear")
    assert got.shape == (h, w, 3) and bool(torch.isfinite(got).all())
    p = psnr(got.numpy(), want)
    print(f"config 5 row-sharded at Best, port vs JAX: {p:.2f} dB")
    assert p >= BEST_MIN_PSNR
    mono = _monolithic(tf, cfg, model, model, block, "bilinear")
    _close(got[32:-32], mono[32:-32], COMPOSED_ATOL, "config 5 row-sharded vs the port's")
    assert psnr(got.numpy(), mono.numpy()) > 40


def test_frame_spatial_lanczos_warp_parity():
    h, w = 192, 64
    jf, tf = _pair(mosaic_rggb(make_scene(h, w, seed=91)))
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.45, 0.55))
    jq, tq = _q("Fast")
    want = np.asarray(JSPP.develop_frame_spatial(
        jf, jax_mesh((1, 2)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq)),
        warp_block=block, warp_interpolation="lanczos4"))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq))
    got = develop_frame_spatial(tf, cpu_mesh((1, 2)), cfg, warp_block=block,
                                warp_interpolation="lanczos4")
    _close(got, want, COMPOSED_ATOL, "Lanczos4 warp row-sharded, port vs JAX")
    mono = _monolithic(tf, cfg, None, None, block, "lanczos4")
    _close(got[32:-32], mono[32:-32], COMPOSED_ATOL, "Lanczos4 warp row-sharded vs the port's")


def _corrections_inputs(seed=92, h=256, w=64):
    rng = np.random.default_rng(seed)
    bayer = mosaic_rggb(make_scene(h, w, seed=seed)) * 0.6 + 0.1
    # hot pixels in different shards' rows: a per-shard quantile would pick
    # different thresholds and flip masks
    for (y, x) in ((8, 9), (77, 30), (150, 11), (233, 50)):
        bayer[y, x] = 1.0
    flat = np.clip(1.0 - 0.3 * (np.linspace(0, 1, h)[:, None] ** 2)
                   - 0.05 * rng.random((h, w)), 0.2, 1).astype(np.float32)
    dark = (0.01 * rng.random((h, w))).astype(np.float32)
    return _pair(bayer), _pair(flat), _pair(dark)


def test_frame_spatial_corrections_global_stats():
    """flat + dark + hot pixels + denoise under the spatial mesh: the flat
    means, the quantile threshold and the denoise sigma are the frame's."""
    (jf, tf), (jflat, tflat), (jdark, tdark) = _corrections_inputs()
    jq, tq = _q("Draft")
    flags = dict(flat_field=True, dark_frame=True, repair_hot_pixels=True,
                 denoise_strength=0.8)
    want = np.asarray(JSPP.develop_frame_spatial(
        jf, jax_mesh((1, 4)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq), **flags),
        flat=jflat, dark=jdark))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq), **flags)
    got = develop_frame_spatial(tf, cpu_mesh((1, 4)), cfg, flat=tflat, dark=tdark)
    _close(got, want, TIER_ATOL, "corrections row-sharded, port vs JAX")
    mono = develop_pipeline(tf, cfg, flat=tflat, dark=tdark)
    _close(got[40:-40], mono[40:-40], COMPOSED_ATOL, "corrections row-sharded vs the port's")


def test_sharded_statistics_are_the_frames():
    """The detector's masks on a shard are the monolithic masks' rows, and
    the flat field's and the denoise's scales are the frame's: each held
    inside the runner against the same call on the whole frame."""
    from pysp_tpu_torch.correct.bad_pixels import find_erroneous_pixels_median
    from pysp_tpu_torch.correct.denoise import denoise_bayer_wavelet
    from pysp_tpu_torch.correct.flat_field import flat_frame_correction
    from pysp_tpu_torch.parallel.mesh import SPATIAL_AXIS
    from pysp_tpu_torch.parallel.shard import P, shard_map
    from pysp_tpu_torch.parallel.spatial import _cfa_reflect_rows

    (_, tf), (_, tflat), _ = _corrections_inputs()
    h = tf.bayer.shape[0]
    halo, n_sp = 40, 4
    rows = h // n_sp
    # the halo-extended blocks, cut from the frame with the CFA reflection at
    # its edges (which is the symmetric padding of each plane)
    def reflected(x):
        return torch.cat([_cfa_reflect_rows(x, halo, top=True), x,
                          _cfa_reflect_rows(x, halo, top=False)])

    pad, flat_pad = reflected(tf.bayer), reflected(tflat.bayer)
    blocks = torch.stack([pad[i * rows:i * rows + rows + 2 * halo] for i in range(n_sp)])
    flats = torch.stack([flat_pad[i * rows:i * rows + rows + 2 * halo] for i in range(n_sp)])
    core = (halo, halo + rows)

    def block_fn(b, f):
        frame = RawFrame.synthetic(b[0, 0], device="cpu")
        masks = find_erroneous_pixels_median(frame, axis_name=SPATIAL_AXIS, core_rows=core)
        flat = flat_frame_correction(frame, RawFrame.synthetic(f[0, 0], device="cpu"),
                                     axis_name=SPATIAL_AXIS, core_rows=core)
        den = denoise_bayer_wavelet(frame, 0.8, axis_name=SPATIAL_AXIS, core_rows=core)
        return (masks[:, halo // 2:-(halo // 2)][None], flat.bayer[halo:-halo][None],
                den.bayer[halo:-halo][None])

    spec = P(None, SPATIAL_AXIS)
    masks, flat, den = shard_map(block_fn, cpu_mesh((1, n_sp)), in_specs=(spec, spec),
                                 out_specs=(P(None, None, SPATIAL_AXIS), P(None, SPATIAL_AXIS),
                                            P(None, SPATIAL_AXIS)))(blocks[None], flats[None])
    assert torch.equal(masks[0], find_erroneous_pixels_median(tf))
    torch.testing.assert_close(flat[0], flat_frame_correction(tf, tflat).bayer,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(den[0], denoise_bayer_wavelet(tf, 0.8).bayer, rtol=0, atol=1e-6)


def test_frame_spatial_gather_path_small_blocks():
    """halo >= rows_local takes the all_gather assembly; parity holds."""
    h, w = 128, 64
    jf, tf = _pair(mosaic_rggb(make_scene(h, w, seed=93)))
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    jq, tq = _q("Fast")
    want = np.asarray(JSPP.develop_frame_spatial(
        jf, jax_mesh((1, 8)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq)),
        warp_block=block, warp_interpolation="bilinear"))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq))
    got = develop_frame_spatial(tf, cpu_mesh((1, 8)), cfg, warp_block=block,
                                warp_interpolation="bilinear")
    _close(got, want, COMPOSED_ATOL, "gather path, port vs JAX")
    mono = _monolithic(tf, cfg, None, None, block, "bilinear")
    _close(got[24:-24], mono[24:-24], COMPOSED_ATOL, "gather path vs the port's")


def test_frame_spatial_rejects_bad_inputs():
    jf, tf = _pair(mosaic_rggb(make_scene(64, 48, seed=94)))
    jb = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jf)
    tb = stack_frames([tf, tf], device="cpu")
    cases = [
        (lambda: JSPP.develop_frame_spatial(jf, jax_mesh((1, 4)),
                                            JaxPipelineConfig(fuse_hdr=True)),
         lambda: develop_frame_spatial(tf, cpu_mesh((1, 4)), PipelineConfig(fuse_hdr=True))),
        (lambda: JSPP.develop_frame_spatial(jb, jax_mesh((1, 4)), JaxPipelineConfig()),
         lambda: develop_frame_spatial(tb, cpu_mesh((1, 4)), PipelineConfig())),
        (lambda: JSPP.develop_frame_spatial(jf, jax_mesh((1, 3)), JaxPipelineConfig()),
         lambda: develop_frame_spatial(tf, cpu_mesh((1, 3)), PipelineConfig())),
        (lambda: JSPP.develop_pipeline_spatial(jf, jax_mesh((1, 4)), JaxPipelineConfig()),
         lambda: SPP.develop_pipeline_spatial(tf, cpu_mesh((1, 4)), PipelineConfig())),
        (lambda: JSPP.develop_pipeline_spatial(jb, jax_mesh((4, 2)), JaxPipelineConfig()),
         lambda: SPP.develop_pipeline_spatial(tb, cpu_mesh((4, 2)), PipelineConfig())),
        (lambda: JSPP.develop_pipeline_spatial(jb, jax_mesh((1, 4)),
                                               JaxPipelineConfig(fuse_hdr=True)),
         lambda: SPP.develop_pipeline_spatial(tb, cpu_mesh((1, 4)),
                                              PipelineConfig(fuse_hdr=True))),
    ]
    for jax_call, port_call in cases:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)
    assert "ONE frame" in str(got.value) or "fuse_hdr" in str(got.value)


def test_refusals_follow_the_bounds():
    """A model beyond the 24 px cap, or a warp beyond its bounds' cap, is
    refused with the JAX message. A bound above 12 px on a frame narrow
    enough for the TPU's full-width select chain is refused by the JAX
    package only; the port develops it, and matches its own monolithic path."""
    h, w = 512, 128
    jf, tf = _pair(mosaic_rggb(make_scene(h, w, seed=95)))
    cfg, jcfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast)), \
        JaxPipelineConfig(develop=JaxDevelopConfig(quality=JQ.Fast))
    # beyond the cap (bound 31 px at 512x128 for Poly3(0.3))
    assert _model_bound_px(Poly3CorrectionModel(0.3), h, w, cap=24) is None
    with pytest.raises(ValueError) as want:
        JSPP.develop_frame_spatial(jf, jax_mesh((1, 4)), jcfg,
                                   ca_model_r=JM.Poly3CorrectionModel(0.3))
    with pytest.raises(ValueError) as got:
        develop_frame_spatial(tf, cpu_mesh((1, 4)), cfg, ca_model_r=Poly3CorrectionModel(0.3))
    assert str(got.value) == str(want.value) and "red CA model" in str(got.value)
    wide = encode_warp_rectilinear([(1.0, -0.2, 0.0, 0.0, 0.0, 0.0)] * 3, (0.5, 0.5))
    with pytest.raises(ValueError) as want:
        JSPP.develop_frame_spatial(jf, jax_mesh((1, 4)), jcfg, warp_block=wide)
    with pytest.raises(ValueError) as got:
        develop_frame_spatial(tf, cpu_mesh((1, 4)), cfg, warp_block=wide)
    assert str(got.value) == str(want.value)

    # the TPU-only refusal: a 13 px bound on a 128-wide frame
    jmodel, model = JM.Poly3CorrectionModel(0.1), Poly3CorrectionModel(0.1)
    assert _model_bound_px(model, h, w, cap=24) == JR._model_bound_px(jmodel, h, w, cap=24) == 13
    with pytest.raises(ValueError, match="red CA model has no static displacement bound"):
        JSPP.develop_frame_spatial(jf, jax_mesh((1, 4)), jcfg, ca_model_r=jmodel)
    got = develop_frame_spatial(tf, cpu_mesh((1, 4)), cfg, ca_model_r=model)
    mono = _monolithic(tf, cfg, model, None, None, "bilinear")
    _close(got[32:-32], mono[32:-32], COMPOSED_ATOL, "the 13 px CA bound row-sharded")


def test_pipeline_sharded_batch_x_spatial_parity():
    """develop_pipeline_sharded on a ('batch', 'spatial') mesh: frames over
    batch AND rows over spatial, each frame against the monolithic
    composition."""
    n, h, w = 4, 128, 64
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    pairs = [_pair(mosaic_rggb(make_scene(h, w, seed=95 + i)), ev=9.0 + 0.1 * i)
             for i in range(n)]
    jb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[j for j, _ in pairs])
    tb = stack_frames([t for _, t in pairs], device="cpu")
    jq, tq = _q("Fast")
    jmodel, model = JM.Poly3CorrectionModel(0.01), Poly3CorrectionModel(0.01)
    want = np.asarray(JPS.develop_pipeline_sharded(
        jb, jax_mesh((2, 4)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq)),
        ca_model_r=jmodel, ca_model_b=jmodel, warp_block=block, warp_interpolation="bilinear"))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq))
    got = develop_pipeline_sharded(tb, cpu_mesh((2, 4)), cfg, ca_model_r=model,
                                   ca_model_b=model, warp_block=block,
                                   warp_interpolation="bilinear")
    assert got.shape == (n, h, w, 3) and bool(torch.isfinite(got).all())
    _close(got, want, COMPOSED_ATOL, "batch x spatial, port vs JAX")
    for i in (0, 3):
        mono = _monolithic(pairs[i][1], cfg, model, model, block, "bilinear")
        _close(got[i, 32:-32], mono[32:-32], COMPOSED_ATOL, f"batch x spatial frame {i}")


def test_pipeline_spatial_consensus_masks():
    """Consensus under ('batch', 'spatial'): counts psummed over 'batch',
    quantiles over 'spatial'."""
    n, h, w = 4, 64, 48
    pairs = []
    for i in range(n):
        b = mosaic_rggb(make_scene(h, w, seed=100 + i)) * 0.6 + 0.1
        b[9, 13] = 1.0  # hot everywhere -> consensus keeps it
        if i < 1:
            b[41, 5] = 1.0  # hot in 1/4 frames -> consensus drops it
        pairs.append(_pair(b.astype(np.float32)))
    jb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[j for j, _ in pairs])
    tb = stack_frames([t for _, t in pairs], device="cpu")
    jq, tq = _q("Draft")
    flags = dict(repair_hot_pixels=True, hot_pixel_shared_ratio=0.6)
    want = np.asarray(JPS.develop_pipeline_sharded(
        jb, jax_mesh((2, 2)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq), **flags)))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq), **flags)
    got = develop_pipeline_sharded(tb, cpu_mesh((2, 2)), cfg)
    _close(got, want, TIER_ATOL, "consensus batch x spatial, port vs JAX")
    _close(got[:, 16:-16], develop_pipeline(tb, cfg)[:, 16:-16], COMPOSED_ATOL,
           "consensus batch x spatial vs the port's develop_pipeline")
