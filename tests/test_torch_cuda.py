"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""
import numpy as np
import pytest
import torch

from pysp_tpu_torch import BayerPattern, DevelopConfig, RawFrame, develop
from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix
from pysp_tpu_torch.demosaic.ahd import demosaic_ahd_channels, postprocess_color_channels
from pysp_tpu_torch.demosaic.ahd_mega import demosaic_ahd_mega
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.utils.testing import (
    HEAL_TILE_KINDS,
    RAW_FORMATS,
    chroma_case,
    heal_case,
    heal_tile_case,
    make_scene,
    mosaic_rggb,
    psnr,
    raw_format_mosaic,
    read_png,
    write_raw_format,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)


@pytest.fixture(scope="module", autouse=True)
def scratch_matrix_cache(tmp_path_factory):
    """DNG loads harvest their calibration rows into the persistent camera-
    matrix cache: point it at a file of this module's own (the module runs
    without tests/conftest.py, which does that for the other tests)."""
    patch = pytest.MonkeyPatch()
    patch.setenv("PYSP_TPU_MATRIX_CACHE",
                 str(tmp_path_factory.mktemp("matrix_cache") / "harvested_matrices.json"))
    yield
    patch.undo()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _frame(h, w, seed, is_hdr, device, noise=0.0):
    mosaic = mosaic_rggb(make_scene(h, w, seed=seed))
    if noise:  # so that every border rule gives its own values at the frame's edge
        rng = np.random.default_rng(seed)
        mosaic = np.clip(mosaic + rng.normal(0, noise, mosaic.shape), 0.02, 0.98)
    return RawFrame.synthetic(mosaic.astype(np.float32), cam_mat=CAM, wb_neutral=WB,
                              is_hdr=is_hdr, device=device)


@pytest.mark.parametrize("shape", [
    (37, 50), (64, 64), (200, 333),
    (100, 200), (100, 202), (96, 256),   # blocks without border code; unaligned rows; whole tiles
    (70, 20), (20, 70), (3, 5), (1, 7), (1, 1),   # narrower than a tile, than the window
])
def test_postprocess_kernel_bit_exact(cuda, shape):
    chans = list(torch.from_numpy(chroma_case(*shape, seed=shape[0])).to(cuda))
    before = K.postprocess_kernel_launches
    got = K.postprocess_color_kernel(*chans)
    assert K.postprocess_kernel_launches == before + 1
    for g, w in zip(got, postprocess_color_channels(*chans)):
        assert torch.equal(g, w)


def test_postprocess_kernel_on_planes_off_the_16_byte_alignment(cuda):
    """Planes that start 4 bytes past a 16-byte boundary take the path without
    16-byte accesses and give the plain version's bytes."""
    h, w = 100, 200
    store = torch.zeros(3 * h * w + 1, device=cuda)
    store[1:] = torch.from_numpy(chroma_case(h, w, seed=3)).to(cuda).reshape(-1)
    chans = list(store[1:].view(3, h, w))
    assert chans[0].data_ptr() % 16 != 0 and chans[0].is_contiguous()
    for g, w_ in zip(K.postprocess_color_kernel(*chans), postprocess_color_channels(*chans)):
        assert torch.equal(g, w_)


MAX_AHD_FLIPS = 1e-4   # pixels whose H/V pick cbrtf flips at an exact tie: 0.01%


@pytest.mark.parametrize("shape", [(256, 320), (250, 334), (20, 200), (4, 6)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_kernel_against_plain(cuda, is_hdr, stages, shape):
    """One launch computes the whole frame, border included: without stages
    every pixel but the flipped ones equals the plain version's bit for bit;
    with S stages every pixel outside the 4 S px dilation of that set."""
    frame = _frame(*shape, seed=shape[0], is_hdr=is_hdr, device=cuda, noise=0.03)
    before = (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
              K.postprocess_kernel_launches)
    got0 = torch.stack(demosaic_ahd_mega(frame, 0))
    got = torch.stack(demosaic_ahd_mega(frame, stages))
    assert (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
            K.postprocess_kernel_launches) == (before[0] + 2, before[1], before[2])
    flipped = (got0 != torch.stack(demosaic_ahd_channels(frame, 0))).any(dim=0)
    assert float(flipped.float().mean()) <= MAX_AHD_FLIPS
    want = torch.stack(demosaic_ahd_channels(frame, stages))
    k = 8 * stages + 1
    near = torch.nn.functional.max_pool2d(flipped[None, None].float(), k, 1, k // 2)[0, 0] > 0
    assert not bool(((got != want).any(dim=0) & ~near).any())
    assert psnr(got.cpu().numpy(), want.cpu().numpy()) >= 50


@pytest.mark.parametrize("stages,clip,gamma,pattern", [
    (1, True, True, BayerPattern.Rggb),
    (0, False, False, BayerPattern.Bggr),
    (2, True, False, BayerPattern.Grbg),
])
def test_develop_with_kernels_against_plain(cuda, stages, clip, gamma, pattern):
    frame = _frame(256, 320, seed=3, is_hdr=False, device=cuda).replace(
        source_pattern=pattern)
    kw = dict(postprocess_stages=stages, clip_highlights=clip, gamma_encode=gamma)
    got = develop(frame, DevelopConfig(**kw))
    want = develop(frame, DevelopConfig(use_pallas=False, **kw))
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.cpu().numpy(), want.cpu().numpy()) >= 50


@pytest.mark.parametrize("shape", [(96, 160), (8, 12)])
def test_small_frames_take_the_ahd_kernel_whole(cuda, shape):
    """Frames of a few tiles, or of less than one, develop in one launch of
    the AHD kernel like any other, and the image is the plain one's but for
    tie flips."""
    frame = _frame(*shape, seed=5, is_hdr=False, device=cuda)
    before = (K.ahd_kernel_launches, K.postprocess_kernel_launches)
    got = develop(frame)
    assert (K.ahd_kernel_launches, K.postprocess_kernel_launches) == (before[0] + 1, before[1])
    want = develop(frame, DevelopConfig(use_pallas=False))
    assert float(((got - want).abs() > 1e-4).any(dim=-1).float().mean()) <= 0.01
    assert psnr(got.cpu().numpy(), want.cpu().numpy()) >= 50


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    frame = _frame(64, 64, seed=4, is_hdr=False, device=cuda)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    with pytest.raises(ValueError, match="even"):
        K.ahd_kernel(frame.bayer[:63], mat, wb, False, 1)
    with pytest.raises(ValueError, match="at least 4"):
        K.ahd_kernel(frame.bayer[:2].contiguous(), mat, wb, False, 1)
    with pytest.raises(TypeError, match="float32"):
        K.ahd_kernel(frame.bayer.double(), mat, wb, False, 1)
    with pytest.raises(ValueError, match="stages"):
        K.ahd_kernel(frame.bayer, mat, wb, False, K.AHD_MAX_STAGES + 1)
    with pytest.raises(ValueError, match="shape"):
        K.postprocess_color_kernel(frame.bayer, frame.bayer, frame.bayer[:32])


# --- the finishing path's kernels: RL and remap -------------------------------------

# Bilinear is bit-exact. Lanczos4 takes an axis's eight weights from one sinf
# and one sincosf where the plain version takes sixteen sines of pi t rounded to
# float: within 5e-6 of it on images in [0, 1], and no further from the float64
# remap than the plain version is plus 1e-6.
REMAP_ATOL = {"bilinear": 0.0, "lanczos4": 5e-6}
LANCZOS4_F64_SLACK = 1e-6


def _assert_remap_close(got, img, mx, my, kind, bounds, channels_last):
    want = K.remap_plain(img, mx, my, kind, bounds, channels_last)
    assert (got - want).abs().max().item() <= REMAP_ATOL[kind]
    if kind == "lanczos4":
        exact = K.remap_plain(img.double(), mx.double(), my.double(), kind, bounds, channels_last)
        plain_err = (want.double() - exact).abs().max().item()
        assert (got.double() - exact).abs().max().item() <= plain_err + LANCZOS4_F64_SLACK


def _rl_image(h, w, channels, device):
    img = np.clip(make_scene(h, w, seed=h) * 0.9 + 0.05, 0.01, 1.0)
    img = img[..., 1] if channels == 1 else img
    return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)


@pytest.mark.parametrize("sigma,iters", [(1.0, 3), (1.0, 20), (2.0, 20), (0.5, 3), (0.7, 3),
                                         (1.4, 3), (1.6, 3), (2.5, 3), (10.5, 2)])
@pytest.mark.parametrize("channels", [1, 3])
def test_rl_kernel_against_plain(cuda, sigma, iters, channels):
    """One launch per iteration over every channel, bit for bit the plain
    loop, at every reach with a kernel of its own (1 to 6) and on the generic
    kernel (7, 31), on a frame that is not a whole number of tiles."""
    from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter

    img = _rl_image(203, 330, channels, cuda)
    taps = get_1d_gaussian_filter(sigma)
    before = K.rl_kernel_launches
    got = K.rl_kernel(img, taps, iters)
    assert K.rl_kernel_launches == before + iters
    assert torch.equal(got, K.rl_plain(img, taps, iters))


def test_rl_gate_on_the_card(cuda):
    """Inside the gate gaussian_rt_deconvolution launches the kernel; outside it
    (H < 2 * reach) runs the plain loop; the wrapper itself raises there."""
    from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter
    from pysp_tpu_torch.filters.sharpen import gaussian_rt_deconvolution

    taps = get_1d_gaussian_filter(2.0)
    small = _rl_image(64, 80, 1, cuda)[:10].contiguous()
    before = K.rl_kernel_launches
    out = gaussian_rt_deconvolution(small, 2.0, 3)
    assert K.rl_kernel_launches == before
    assert torch.equal(out, K.rl_plain(small, taps, 3))
    with pytest.raises(ValueError, match="RL kernel"):
        K.rl_kernel(small, taps, 3)
    gaussian_rt_deconvolution(_rl_image(64, 80, 3, cuda), 2.0, 3)
    assert K.rl_kernel_launches == before + 3


def _remap_maps(h, w, channels, device):
    from pysp_tpu_torch.warp.rectilinear import compute_remapping_table

    xs, ys = [], []
    for k in range(channels):
        co = (1.0, -0.02 + 0.006 * k, 0.002, 0.0, 0.001, -0.001)
        mx, my = compute_remapping_table(co, w, h, (0.45, 0.55), device=device)
        xs.append(mx.clamp(0, w - 1))
        ys.append(my.clamp(0, h - 1))
    return torch.stack(xs), torch.stack(ys)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("bounds", [None, ((-3, 1), (-2, 3))])
@pytest.mark.parametrize("channels,maps", [(1, "shared"), (3, "shared"), (3, "per_channel")])
def test_remap_kernel_against_plain(cuda, kind, bounds, channels, maps):
    """(H, W) planes and (H, W, C) images, maps shared or per channel, bounded
    (tighter than the maps' displacement) or not."""
    h, w = 203, 330
    img = _rl_image(h, w, channels, cuda)
    mx, my = _remap_maps(h, w, channels if maps == "per_channel" else 1, cuda)
    if maps == "shared":
        mx, my = mx[0], my[0]
    before = K.remap_kernel_launches
    got = K.remap_kernel(img, mx, my, kind, bounds, channels_last=channels > 1)
    assert K.remap_kernel_launches == before + 1
    _assert_remap_close(got, img, mx, my, kind, bounds, channels > 1)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("case", ["planes", "tiny", "random", "whole_phases"])
def test_remap_kernel_layouts_and_maps(cuda, kind, case):
    """Beside the cases above: a (3, H, W) stack, a 5x6 frame that is smaller
    than the taps' reach, random maps that send every pixel anywhere in the
    frame and past it, and phases next to 0 and 1."""
    h, w = (5, 6) if case == "tiny" else (203, 330)
    img = _rl_image(h, w, 3, cuda)
    channels_last = case != "planes"
    if case == "planes":
        img = img.permute(2, 0, 1).contiguous()
    if case == "random":
        rng = np.random.default_rng(4)
        mx = torch.from_numpy(rng.uniform(-3, w + 2, (h, w)).astype(np.float32)).to(cuda)
        my = torch.from_numpy(rng.uniform(-3, h + 2, (h, w)).astype(np.float32)).to(cuda)
    elif case == "whole_phases":
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=cuda),
                                torch.arange(w, dtype=torch.float32, device=cuda), indexing="ij")
        eps = 0.3 * 10.0 ** -(xs % 8)
        mx = (xs + torch.where(xs % 2 == 0, eps, 1 - eps)).clamp(0, w - 1)
        my = (ys + torch.where(ys % 2 == 0, 1 - eps, eps)).clamp(0, h - 1)
    else:
        mx, my = _remap_maps(h, w, 1, cuda)
        mx, my = mx[0], my[0]
    got = K.remap_kernel(img, mx, my, kind, None, channels_last)
    _assert_remap_close(got, img, mx, my, kind, None, channels_last)


def _plain_warp(img, co, center):
    """The lens warp of one coefficient set shared by every channel, through
    the remap kernel's plain version with the warp's own bounds."""
    from pysp_tpu_torch.warp.rectilinear import compute_remapping_table, displacement_bounds

    h, w = img.shape[0], img.shape[1]
    mx, my = compute_remapping_table(co, w, h, center, device=img.device)
    bounds = displacement_bounds(co, w, h, center)
    return K.remap_plain(img, mx.clamp(0, w - 1), my.clamp(0, h - 1), "lanczos4", bounds,
                         channels_last=True)


def test_finishing_path_with_kernels_against_plain(cuda):
    """deconv (RL kernel) -> unsharp -> gamma -> lens warp (remap kernel)
    against the same stages composed from the plain versions on the card."""
    from pysp_tpu_torch.colorimetry.transforms import lin_srgb_to_srgb
    from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter
    from pysp_tpu_torch.filters.sharpen import (
        gaussian_rt_deconvolution_yuv,
        unsharp_mask_lab,
    )
    from pysp_tpu_torch.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

    co, center = (1.0, -0.02, 0.0, 0.0, 0.0, 0.0), (0.5, 0.5)
    block = encode_warp_rectilinear([co] * 3, center)
    lin = _rl_image(256, 320, 3, cuda)

    def sharpen(deconv):
        return lin_srgb_to_srgb(torch.clamp(unsharp_mask_lab(deconv, 2.0, 0.5), 0.0, 1.0))

    before = (K.rl_kernel_launches, K.remap_kernel_launches)
    got = apply_opcode_3_warp(sharpen(gaussian_rt_deconvolution_yuv(lin, 1.0, 20)), block)
    assert (K.rl_kernel_launches, K.remap_kernel_launches) == (before[0] + 20, before[1] + 1)
    y = 0.299 * lin[..., 0] + 0.587 * lin[..., 1] + 0.114 * lin[..., 2]
    y_mod = K.rl_plain(y, get_1d_gaussian_filter(1.0), 20)
    want = _plain_warp(sharpen(lin * (y_mod / y)[..., None]), co, center)
    assert (K.rl_kernel_launches, K.remap_kernel_launches) == (before[0] + 20, before[1] + 1)
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4


def test_bounded_and_prior_warps_with_kernels_against_plain(cuda):
    """remap_bounded and the prior-composed per-channel warp with the remap
    kernel, against the same remaps through its plain version on the card."""
    from pysp_tpu_torch.ops.resample import remap_bounded
    from pysp_tpu_torch.warp.opcodes import (
        apply_opcode_3_warp,
        encode_warp_rectilinear,
        stack_warp_prior,
    )
    from pysp_tpu_torch.warp.rectilinear import compute_offset_remapping_table

    h, w = 120, 170
    img = _rl_image(h, w, 3, cuda)
    mx, my = _remap_maps(h, w, 3, cuda)
    planes = img.permute(2, 0, 1).contiguous()
    for kind in ("bilinear", "lanczos4"):
        before = K.remap_kernel_launches
        got = remap_bounded(planes, mx, my, (-3, 1), (-2, 3), kind)
        assert K.remap_kernel_launches == before + 1
        want = remap_bounded(planes, mx, my, (-3, 1), (-2, 3), kind, use_pallas=False)
        assert K.remap_kernel_launches == before + 1
        assert (got - want).abs().max().item() <= REMAP_ATOL[kind]
    co, center = (1.0, -0.02, 0.0, 0.0, 0.0, 0.0), (0.5, 0.5)
    block = encode_warp_rectilinear([co] * 3, center)
    prior = stack_warp_prior((h, w), (mx[0], my[0]), None, (mx[2], my[2]))
    before = K.remap_kernel_launches
    got = apply_opcode_3_warp(img, block, prior=prior)
    assert K.remap_kernel_launches == before + 3
    want = []
    for idx in range(3):
        tx, ty = compute_offset_remapping_table(prior[idx][0], prior[idx][1], co, w, h, center)
        want.append(K.remap_plain(img[..., idx].contiguous(), tx.clamp(0, w - 1),
                                  ty.clamp(0, h - 1), "lanczos4"))
    assert K.remap_kernel_launches == before + 3
    assert (got - torch.stack(want, dim=-1)).abs().max().item() <= REMAP_ATOL["lanczos4"]


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img = _rl_image(64, 80, 3, cuda)
    mx, my = _remap_maps(64, 80, 1, cuda)
    with pytest.raises(TypeError, match="float32"):
        K.rl_kernel(img.double(), np.ones(3, np.float32), 1)
    with pytest.raises(TypeError, match="float32"):
        K.remap_kernel(img.double(), mx[0], my[0], "bilinear", channels_last=True)
    with pytest.raises(ValueError, match="kind"):
        K.remap_kernel(img, mx[0], my[0], "bicubic", channels_last=True)


# --- the corrections path's kernel: heal ----------------------------------------------


@pytest.mark.parametrize("sweeps", [(4, 2), (6, 2)])
@pytest.mark.parametrize("density", [1e-4, 3e-3, 0.6])
@pytest.mark.parametrize("shape", [(256, 384), (253, 381), (3, 5), (1, 1)])
def test_heal_kernel_bit_exact(cuda, shape, density, sweeps):
    planes, mask = (torch.from_numpy(a).to(cuda) for a in heal_case(*shape, density, shape[1]))
    before = K.heal_kernel_launches
    got = K.heal_kernel(planes, mask, *sweeps)
    assert K.heal_kernel_launches == before + 1
    assert torch.equal(got, K.heal_plain(planes, mask, *sweeps))


@pytest.mark.parametrize("sweeps", [(4, 2), (6, 2)])
@pytest.mark.parametrize("kind", HEAL_TILE_KINDS)
@pytest.mark.parametrize("shape", [(64, 128), (61, 133), (3, 5), (1, 1)])
def test_heal_kernel_tiling(cuda, shape, kind, sweeps):
    """No site, a site in every sweep sub-tile, sites on and R - 1 past every
    sub-tile corner: bit-exact, and the planes themselves without a site."""
    planes, mask = (torch.from_numpy(a).to(cuda) for a in heal_tile_case(*shape, kind, shape[1]))
    got = K.heal_kernel(planes, mask, *sweeps)
    assert torch.equal(got, K.heal_plain(planes, mask, *sweeps))
    if kind == "no_site":
        assert torch.equal(got, planes)


def test_repair_bad_pixels_and_its_gate_on_the_card(cuda):
    """Inside the gate repair_bad_pixels launches the heal kernel, outside it
    (7 + 2 sweeps) runs the dense fill; both equal the plain fill."""
    from pysp_tpu_torch.core.bayer import bayer_to_planes
    from pysp_tpu_torch.correct.bad_pixels import (
        find_erroneous_pixels_median,
        masked_fill_inpaint,
        repair_bad_pixels,
    )

    bayer = mosaic_rggb(make_scene(256, 320, seed=8))
    bayer[np.random.default_rng(8).random(bayer.shape) < 2e-3] = 1.0
    frame = RawFrame.synthetic(bayer, device=cuda)
    masks = find_erroneous_pixels_median(frame, quantile=0.99)
    planes = bayer_to_planes(frame.bayer)
    for iterations, launched in ((4, 1), (7, 0)):
        before = K.heal_kernel_launches
        got = bayer_to_planes(repair_bad_pixels(frame, masks, iterations).bayer)
        assert K.heal_kernel_launches == before + launched
        assert torch.equal(got, masked_fill_inpaint(planes, masks, iterations))
    with pytest.raises(ValueError, match="sweeps"):
        K.heal_kernel(planes, masks, 7, 2)
    with pytest.raises(TypeError, match="bool"):
        K.heal_kernel(planes, masks.float(), 4, 2)


def _pipeline_plain(frames, cfg, flat=None):
    """develop_pipeline composed from the plain versions: the same stages with
    heal_plain for the heal and the plain develop."""
    from pysp_tpu_torch.core.frame import stack_frames, unstack_frames
    from pysp_tpu_torch.correct.bad_pixels import find_erroneous_pixels_median
    from pysp_tpu_torch.correct.flat_field import flat_frame_correction
    from pysp_tpu_torch.correct.hdr import fuse_exposures_to_raw
    from pysp_tpu_torch.core.bayer import bayer_to_planes, planes_to_bayer

    def heal(f, masks):
        healed = K.heal_plain(bayer_to_planes(f.bayer), masks, cfg.hot_pixel_iterations)
        return f.replace(bayer=planes_to_bayer(healed))

    plain = DevelopConfig(use_pallas=False)
    if frames.bayer.ndim == 2:
        if cfg.flat_field:
            frames = flat_frame_correction(frames, flat)
        return develop(heal(frames, find_erroneous_pixels_median(frames)), plain)
    burst = unstack_frames(frames)
    per_frame = [find_erroneous_pixels_median(f) for f in burst]
    need = float(np.ceil(np.float32(len(burst) * cfg.hot_pixel_shared_ratio)))
    shared = sum(m.to(torch.int32) for m in per_frame) >= need
    fused, _ = fuse_exposures_to_raw(stack_frames([heal(f, shared) for f in burst],
                                                  device=frames.bayer.device))
    return develop(fused, plain)


def test_corrections_pipeline_with_the_kernels_against_plain(cuda):
    """Configs 3 and 4 at 256x320 through develop_pipeline on the card (heal and
    AHD kernels) against the same stages from the plain versions."""
    from pysp_tpu_torch import PipelineConfig, develop_pipeline, stack_frames

    rng = np.random.default_rng(9)
    scene = mosaic_rggb(make_scene(256, 320, seed=9))
    hot = rng.random(scene.shape) < 5e-4
    bayer = np.where(hot & (scene < 0.25), 1.0, scene).astype(np.float32)
    yy, xx = np.mgrid[0:256, 0:320].astype(np.float32)
    flat = 1.0 - 0.4 * (((yy - 128) / 256) ** 2 + ((xx - 160) / 320) ** 2) * 2
    frame = RawFrame.synthetic(bayer, cam_mat=CAM, wb_neutral=WB, device=cuda)
    flat = RawFrame.synthetic(flat.astype(np.float32), device=cuda)
    cfg3 = PipelineConfig(flat_field=True, repair_hot_pixels=True)
    before = (K.heal_kernel_launches, K.ahd_kernel_launches)
    got = develop_pipeline(frame, cfg3, flat=flat)
    assert (K.heal_kernel_launches, K.ahd_kernel_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.cpu().numpy(), _pipeline_plain(frame, cfg3, flat).cpu().numpy()) >= 50

    frames = [RawFrame.synthetic(np.clip(bayer * 2.0 ** (k - 2), 0, 1).astype(np.float32),
                                 cam_mat=CAM, wb_neutral=WB, ev=12.0 - k, device=cuda)
              for k in range(5)]
    burst = stack_frames(frames)
    cfg4 = PipelineConfig(fuse_hdr=True, repair_hot_pixels=True, hot_pixel_shared_ratio=0.5)
    before = (K.heal_kernel_launches, K.ahd_kernel_launches)
    got = develop_pipeline(burst, cfg4)
    assert (K.heal_kernel_launches, K.ahd_kernel_launches) == (before[0] + 5, before[1] + 1)
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.cpu().numpy(), _pipeline_plain(burst, cfg4).cpu().numpy()) >= 50


# --- the staged AHD route's kernels: median5, homogeneity count, direction pick --------

STAGED_SHAPES = [(512, 768), (203, 330), (33, 70), (3, 5)]
# The median5 kernel's 16x64 and the homogeneity kernel's 32x64 tiles: blocks on the 16-byte path
# beside edge blocks (100x260), rows off the 16-byte alignment, planes one
# pixel wide or high.
TILE_SHAPES = [(100, 260), (97, 203), (130, 190), (1, 7), (7, 1)]
MAX_PICK_FLIPS = 5e-4   # picks that flip at exact ties through cbrtf (0.05%)


def _unaligned(planes, cuda):
    """Copies of (H, W) planes that start 4 bytes past a 16-byte boundary."""
    h, w = planes[0].shape
    store = torch.empty(len(planes) * h * w + 1, device=cuda)
    out = store[1:].view(len(planes), h, w)
    for dst, src in zip(out, planes):
        dst.copy_(src)
    assert out.data_ptr() % 16 != 0
    return list(out)


@pytest.mark.parametrize("shape", STAGED_SHAPES + [(1, 1)] + TILE_SHAPES)
def test_median5_kernel_bit_exact(cuda, shape):
    from pysp_tpu_torch.ops.stencil import median5

    rgb = torch.from_numpy(make_scene(*shape, seed=shape[0])).to(cuda)
    x = (rgb[..., 0] - rgb[..., 1]).contiguous()
    before = K.median5_kernel_launches
    got = K.median5_kernel(x)
    assert K.median5_kernel_launches == before + 1
    assert torch.equal(got, median5(x))


def test_median5_kernel_unaligned_plane(cuda):
    """A plane off the 16-byte alignment takes the path without 16-byte
    accesses and gives the plain median."""
    from pysp_tpu_torch.ops.stencil import median5

    rgb = torch.from_numpy(make_scene(100, 260, seed=3)).to(cuda)
    (x,) = _unaligned([rgb[..., 0] - rgb[..., 1]], cuda)
    assert torch.equal(K.median5_kernel(x), median5(x))


@pytest.mark.parametrize("is_vertical", [False, True])
@pytest.mark.parametrize("shape", STAGED_SHAPES + TILE_SHAPES)
def test_homogeneity_kernel_bit_exact(cuda, shape, is_vertical):
    from pysp_tpu_torch.colorimetry.transforms import rgb_to_lab_channels
    from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels

    rgb = torch.from_numpy(make_scene(*shape, seed=shape[1])).to(cuda)
    lum, a, b = (p.contiguous() for p in rgb_to_lab_channels(*rgb.unbind(-1)))
    before = K.homogeneity_kernel_launches
    got = K.homogeneity_kernel(lum, a, b, is_vertical)
    assert K.homogeneity_kernel_launches == before + 1
    assert torch.equal(got, homogeneity_map_channels(lum, a, b, is_vertical))


@pytest.mark.parametrize("is_vertical", [False, True])
def test_homogeneity_kernel_unaligned_planes(cuda, is_vertical):
    """Planes off the 16-byte alignment take the path without 16-byte
    accesses and give the plain count."""
    from pysp_tpu_torch.colorimetry.transforms import rgb_to_lab_channels
    from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels

    rgb = torch.from_numpy(make_scene(100, 260, seed=5)).to(cuda)
    lum, a, b = _unaligned(rgb_to_lab_channels(*rgb.unbind(-1)), cuda)
    got = K.homogeneity_kernel(lum, a, b, is_vertical)
    assert torch.equal(got, homogeneity_map_channels(lum, a, b, is_vertical))


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("shape", [(512, 768), (202, 330), (34, 70), (4, 6), (130, 190),
                                   (62, 122)])
def test_decision_kernel_against_plain(cuda, shape, is_hdr):
    from pysp_tpu_torch.demosaic.ahd import ahd_candidates, ahd_decision, ahd_decision_plain

    frame = _frame(*shape, seed=2, is_hdr=is_hdr, device=cuda)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    fields = [f.contiguous() for f in ahd_candidates(frame.bayer, wb)]
    before = K.decision_kernel_launches
    got = ahd_decision(*fields, mat, wb, is_hdr)
    assert K.decision_kernel_launches == before + 1
    want = ahd_decision_plain(*fields, mat, wb, is_hdr)
    assert float((got != want).float().mean()) <= MAX_PICK_FLIPS
    assert bool(((got == 0) | (got == 1)).all())


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (3, 2)])
def test_decision_kernel_on_tiny_frames(cuda, shape, is_hdr):
    """2 and 3 px a side, random fields: every count across the border is a
    mirror of an in-frame one."""
    from pysp_tpu_torch.demosaic.ahd import ahd_decision_plain

    frame = _frame(8, 8, seed=1, is_hdr=is_hdr, device=cuda)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    fields = [torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda)
              for _ in range(6)]
    got = K.decision_kernel(*fields, mat, wb, is_hdr)
    want = ahd_decision_plain(*fields, mat, wb, is_hdr)
    assert int((got != want).sum()) <= 1     # a cbrtf tie flip at most
    assert bool(((got == 0) | (got == 1)).all())


@pytest.mark.parametrize("is_hdr", [False, True])
def test_staged_route_with_the_kernels_equals_plain(cuda, is_hdr):
    """Three stages leave the AHD kernel's route: the whole frame takes the
    staged route, two homogeneity launches and one postprocess launch per
    stage, bit-identical to the plain route."""
    frame = _frame(256, 320, seed=6, is_hdr=is_hdr, device=cuda)
    before = (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
              K.postprocess_kernel_launches)
    got = develop(frame, DevelopConfig(postprocess_stages=3))
    assert (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
            K.postprocess_kernel_launches) == (before[0], before[1] + 2, before[2] + 3)
    assert torch.equal(got, develop(frame, DevelopConfig(postprocess_stages=3,
                                                         use_pallas=False)))


def test_best_develop_is_one_launch(cuda):
    """A Best develop launches the AHD kernel once and neither the homogeneity
    nor the postprocess kernel."""
    frame = _frame(256, 320, seed=3, is_hdr=False, device=cuda)
    before = (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
              K.postprocess_kernel_launches)
    develop(frame)
    assert (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
            K.postprocess_kernel_launches) == (before[0] + 1, before[1], before[2])


@pytest.mark.parametrize("quality", ["Draft", "Fast"])
@pytest.mark.parametrize("pattern", [BayerPattern.Rggb, BayerPattern.Grbg])
def test_draft_and_fast_on_the_card_match_the_cpu(cuda, quality, pattern):
    from pysp_tpu_torch import QualityDemosaic

    cfg = DevelopConfig(quality=getattr(QualityDemosaic, quality))
    on_cpu = _frame(256, 320, seed=4, is_hdr=False, device="cpu").replace(
        source_pattern=pattern)
    on_card = _frame(256, 320, seed=4, is_hdr=False, device=cuda).replace(
        source_pattern=pattern)
    got = develop(on_card, cfg)
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert (got.cpu() - develop(on_cpu, cfg)).abs().max().item() <= 1e-5


def test_staged_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.median5_kernel(x.double())
    with pytest.raises(ValueError, match="shape"):
        K.homogeneity_kernel(x, x, x[:4], False)
    with pytest.raises(ValueError, match="H, W >= 2"):
        K.decision_kernel(*([x[:1]] * 6), torch.eye(3, device=cuda),
                          torch.ones(3, device=cuda), False)
    with pytest.raises(ValueError, match="contiguous"):
        K.median5_kernel(x.t()[:, :4])


# --- chromatic aberration ---------------------------------------------------------------


def _ca_removal_plain(monkeypatch, frame, model_r, model_b):
    """``remove_ca_from_raw`` with the remap kernel's plain version in its place."""
    from pysp_tpu_torch.correct.ca import removal

    with monkeypatch.context() as m:
        m.setattr(removal, "remap_kernel", K.remap_plain)
        return removal.remove_ca_from_raw(frame, model_r, model_b)


@pytest.mark.parametrize("case", ["single", "burst", "r_only", "odd_planes"])
def test_ca_removal_on_the_card_equals_plain(cuda, monkeypatch, case):
    """CA removal through the remap kernel is the plain remap's bit for bit:
    4 launches a call with two models (2 with one), for a frame or a burst."""
    from pysp_tpu_torch import Poly3CorrectionModel, Poly5CorrectionModel, remove_ca_from_raw
    from pysp_tpu_torch.core.frame import stack_frames

    h, w = (258, 334) if case == "odd_planes" else (256, 320)
    frames = [_frame(h, w, seed=s, is_hdr=False, device=cuda) for s in range(3)]
    frame = stack_frames(frames, device=cuda) if case == "burst" else frames[0]
    model_r = Poly3CorrectionModel(0.02)
    model_b = None if case == "r_only" else Poly5CorrectionModel(-0.01, 0.004)
    before = K.remap_kernel_launches
    got = remove_ca_from_raw(frame, model_r, model_b)
    assert K.remap_kernel_launches == before + (2 if model_b is None else 4)
    want = _ca_removal_plain(monkeypatch, frame, model_r, model_b)
    assert got.bayer.device.type == "cuda" and torch.equal(got.bayer, want.bayer)
    if case == "burst":
        for f, g in zip(frames, got.bayer):
            assert torch.equal(g, remove_ca_from_raw(f, model_r, model_b).bayer)


def test_template_match_batch_on_the_card_matches_the_cpu(cuda):
    from pysp_tpu_torch.correct.ca.matcher import template_match_batch

    rng = np.random.default_rng(3)
    target = rng.random((64, 64)).astype(np.float32)
    tiles = np.stack([target[24:40, 30:46], target[10:26, 8:24], target[33:49, 40:56]])
    starts = np.array([[21.0, 27.0], [7.5, 5.25], [30.2, 37.9]])
    vecs = np.full((3, 2), 6.0 / np.sqrt(72) / 4)
    pos = starts[:, None] + np.arange(64)[None, :, None] * vecs[:, None]
    mask = np.arange(64)[None] < np.array([[25], [30], [64]])
    got = template_match_batch(torch.from_numpy(target).to(cuda), tiles, pos, mask, vecs)
    want = template_match_batch(torch.from_numpy(target), tiles, pos, mask, vecs)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=2e-4)


def test_poly3_gradient_fit_on_the_card_matches_the_cpu(cuda):
    from pysp_tpu_torch.correct.ca.gradfit import fit_poly3_gradient, poly3_correct_channel

    scene = torch.from_numpy(make_scene(96, 128, seed=2)[..., 1].copy())
    moving = poly3_correct_channel(scene, -0.015)
    got, got_loss = fit_poly3_gradient(moving.to(cuda), scene.to(cuda), steps=40)
    want, want_loss = fit_poly3_gradient(moving, scene, steps=40)
    assert abs(got - want) <= 1e-4 and np.isfinite(got_loss)


def test_centre_pixel_rule_on_the_card(cuda):
    """On an odd-by-odd plane the centre offset is 0 and every value finite."""
    from pysp_tpu_torch import Poly5CorrectionModel, lensfun_poly3_remap_coords
    from pysp_tpu_torch.correct.ca.gradfit import radial_correct_channel

    model = Poly5CorrectionModel(0.01, -0.004)
    for coords in (model.get_distorted_coordinates(torch.zeros(21, 21, device=cuda)),
                   model.get_undistorted_coordinates(torch.zeros(21, 21, device=cuda))):
        assert bool(torch.isfinite(coords).all()) and coords[10, 10].abs().max().item() == 0.0
    mx, my = lensfun_poly3_remap_coords((21, 21), 0.01, -0.02, 1.01, device=cuda)
    assert bool(torch.isfinite(mx).all()) and (mx[10, 10].item(), my[10, 10].item()) == (10, 10)
    plane = torch.rand(21, 21, device=cuda)
    out = radial_correct_channel(plane, torch.tensor([0.01, -0.004], device=cuda), "poly5")
    assert bool(torch.isfinite(out).all()) and out[10, 10].item() == plane[10, 10].item()


# --- the DNG develop surface: opcodes at load, reconstruction, statistics ----------


@pytest.mark.parametrize("shape", [
    (37, 50), (100, 200), (100, 202), (96, 256), (70, 20), (3, 5), (1, 7), (1, 1),
])
def test_postprocess_image_entry_bit_exact(cuda, shape):
    """The (H, W, 3) entry of the postprocess kernel equals the plain stage."""
    from pysp_tpu_torch.demosaic.ahd import postprocess_color

    image = torch.from_numpy(chroma_case(*shape, seed=shape[1])).to(cuda).permute(1, 2, 0)
    image = image.contiguous()
    before = K.postprocess_kernel_launches
    got = postprocess_color(image, use_pallas=True)
    assert K.postprocess_kernel_launches == before + 1
    assert torch.equal(got, postprocess_color(image))


def test_postprocess_image_entry_off_the_16_byte_alignment_and_bad_inputs(cuda):
    from pysp_tpu_torch.demosaic.ahd import postprocess_color

    h, w = 100, 200
    store = torch.zeros(h * w * 3 + 1, device=cuda)
    image = store[1:].view(h, w, 3)
    image.copy_(torch.from_numpy(chroma_case(h, w, seed=7)).to(cuda).permute(1, 2, 0))
    assert image.data_ptr() % 16 != 0
    assert torch.equal(K.postprocess_color_image_kernel(image), postprocess_color(image))
    with pytest.raises(ValueError, match="contiguous"):
        K.postprocess_color_image_kernel(image.transpose(0, 1))
    with pytest.raises(ValueError, match="H, W, 3"):
        K.postprocess_color_image_kernel(image[..., :2].contiguous())
    with pytest.raises(TypeError, match="float32"):
        K.postprocess_color_image_kernel(image.double())


def _opcode_dng_bytes(h, w):
    from pysp_tpu_torch.io.tiff import write_synthetic_dng
    from pysp_tpu_torch.warp import fix_opcodes as F
    from pysp_tpu_torch.warp import gain_opcodes as G

    rng = np.random.default_rng(h + w)
    stored = (256 + np.minimum(mosaic_rggb(make_scene(h, w, seed=2) * 1.3), 1.0) * 4095)
    stored = stored.astype(np.uint16)
    stored.flat[rng.choice(h * w, 20, replace=False)] = 7
    points = np.stack([rng.integers(0, h, 40), rng.integers(0, w, 40)], 1).astype(np.int32)
    rects = np.array([[10, 12, 14, 17], [h - 3, w - 4, h + 2, w + 2]], np.int32)
    block1 = G.encode_opcode_list([
        (F.OPCODE_FIX_BAD_PIXELS_CONSTANT,
         F.encode_fix_bad_pixels_constant(F.BadPixelsConstant(7, 0))),
        (F.OPCODE_FIX_BAD_PIXELS_LIST,
         F.encode_fix_bad_pixels_list(F.BadPixelsList(0, points, rects))),
    ])
    maps = []
    for dy in (0, 1):
        for dx in (0, 1):
            gains = rng.uniform(0.8, 1.3, (5, 5, 1)).astype(np.float32)
            maps.append((G.OPCODE_GAIN_MAP, G.encode_gain_map(G.GainMap(
                dy, dx, h, w, 0, 1, 2, 2, 5, 5, 0.25, 0.25, 0.0, 0.0, 1, gains))))
    maps.append((G.OPCODE_FIX_VIGNETTE_RADIAL, G.encode_vignette_radial(
        G.VignetteRadial((0.2, -0.05, 0.0, 0.0, 0.0), 0.5, 0.5))))
    return write_synthetic_dng(stored, opcode_list_1=block1,
                               opcode_list_2=G.encode_opcode_list(maps))


def test_load_with_opcode_lists_on_the_card_matches_the_cpu(cuda):
    from pysp_tpu_torch import load_raw

    blob = _opcode_dng_bytes(130, 190)
    on_card = load_raw(blob)
    assert on_card.bayer.device.type == "cuda"
    on_cpu = load_raw(blob, device="cpu")
    assert (on_card.bayer.cpu() - on_cpu.bayer).abs().max().item() <= 1e-6


@pytest.mark.parametrize("is_hdr", [False, True])
def test_reconstruct_develop_is_one_launch_and_matches_plain(cuda, is_hdr):
    """Best with highlights="reconstruct" on a CUDA frame: one AHD launch in
    its demosaic-only mode, no homogeneity or postprocess launch, and the
    plain develop's pixels but for H/V tie flips."""
    mosaic = mosaic_rggb(make_scene(256, 320, seed=5) * 1.5)
    lim = 2.0 if is_hdr else 1.0
    frame = RawFrame.synthetic(np.clip(mosaic * lim, 0, lim).astype(np.float32), cam_mat=CAM,
                               wb_neutral=WB, lim_sat=lim, is_hdr=is_hdr, device=cuda)
    cfg = DevelopConfig(highlights="reconstruct")
    before = (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
              K.postprocess_kernel_launches)
    got = develop(frame, cfg)
    assert (K.ahd_kernel_launches, K.homogeneity_kernel_launches,
            K.postprocess_kernel_launches) == (before[0] + 1, before[1], before[2])
    want = develop(frame, DevelopConfig(highlights="reconstruct", use_pallas=False))
    assert got.shape == (256, 320, 3) and bool(torch.isfinite(got).all())
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0 + 1e-6
    assert float(((got - want).abs() > 1e-4).any(-1).float().mean()) < 1e-3
    assert psnr(got.cpu().numpy(), want.cpu().numpy()) >= 50


def test_staged_reconstruct_develop_equals_plain(cuda):
    frame = _frame(256, 320, seed=8, is_hdr=False, device=cuda)
    frame = frame.replace(bayer=torch.clamp(frame.bayer * 1.6, 0, 1))
    cfg = DevelopConfig(highlights="reconstruct", postprocess_stages=3)
    before = K.homogeneity_kernel_launches, K.postprocess_kernel_launches
    got = develop(frame, cfg)
    assert (K.homogeneity_kernel_launches, K.postprocess_kernel_launches) == (
        before[0] + 2, before[1] + 3)
    want = develop(frame, DevelopConfig(highlights="reconstruct", postprocess_stages=3,
                                        use_pallas=False))
    assert torch.equal(got, want)


def test_develop_with_stats_on_the_card(cuda):
    """The statistics of a 4200x4200 mosaic (past torch.quantile's 2**24
    elements) on the card, against float64 NumPy over the same tensors."""
    from pysp_tpu_torch.utils.tracing import bayer_stats, rgb_stats

    rng = np.random.default_rng(9)
    x = (rng.integers(0, 4096, (4200, 4200)) / 4095).astype(np.float32)
    got = bayer_stats(torch.from_numpy(x).to(cuda), torch.tensor(1.0, device=cuda))
    assert abs(float(got["p99"]) - float(np.quantile(x, 0.99))) <= 1e-6
    assert abs(float(got["mean"]) / x.astype(np.float64).mean() - 1) <= 1e-5
    assert float(got["clip_high_frac"]) == np.float32((x >= 1.0).sum()) / np.float32(x.size)
    rgb = rng.uniform(-0.1, 1.1, (300, 400, 3)).astype(np.float32)
    out = rgb_stats(torch.from_numpy(rgb).to(cuda))
    ref = rgb.reshape(-1, 3).astype(np.float64)
    np.testing.assert_allclose(out["mean_rgb"].cpu().numpy(), ref.mean(0), rtol=1e-5)
    np.testing.assert_allclose(out["std_rgb"].cpu().numpy(), ref.std(0), rtol=1e-5)
    assert float(out["neg_frac"]) == np.float32((rgb <= 0).sum()) / np.float32(rgb.size)


@pytest.mark.parametrize("fmt", sorted(RAW_FORMATS))
def test_each_format_loads_on_the_card_as_on_the_cpu(cuda, fmt, tmp_path):
    """``load_raw`` with its default device puts the frame on the card, equal
    to the CPU load field by field; the PNG of a card image is the CPU's."""
    from pysp_tpu_torch import load_raw
    from pysp_tpu_torch.io.image_out import save_image, to_uint8

    stored = raw_format_mosaic(fmt, mosaic_rggb(make_scene(64, 224, seed=4)))
    blob = write_raw_format("pysp_tpu_torch.io", fmt, stored)
    got, want = load_raw(blob), load_raw(blob, device="cpu")
    assert got.device.type == "cuda" and got.source_pattern == want.source_pattern
    for k in ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    if fmt == "cr2":
        img = develop(got)
        save_image(str(tmp_path / "x.png"), img)
        assert np.array_equal(read_png((tmp_path / "x.png").read_bytes()), to_uint8(img.cpu()))


def _stream_dngs(folder, n, h=96, w=128):
    """``n`` small RGGB DNGs of the test scene, every third one LJ92."""
    from pysp_tpu_torch.io.tiff import write_synthetic_dng

    paths = []
    for i in range(n):
        u16 = (200 + mosaic_rggb(make_scene(h, w, seed=70 + i)) * 3800).astype(np.uint16)
        path = folder / f"f{i:02d}.dng"
        path.write_bytes(write_synthetic_dng(u16, compression=7 if i % 3 == 1 else 1))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("prefetch", [1, 4])
def test_stream_on_the_card_equals_the_sequential_develop(cuda, tmp_path, prefetch):
    """32 files through the card's stream (upload, compute and download
    streams): each image the card's own develop of that file, bit for bit, in
    input order; one AHD launch a file."""
    from pysp_tpu_torch import develop_stream, load_raw

    paths = _stream_dngs(tmp_path, 32)
    cfg = DevelopConfig()
    before = K.ahd_kernel_launches
    got = list(develop_stream(paths, cfg, prefetch=prefetch))
    assert K.ahd_kernel_launches == before + 32
    assert [s for s, _ in got] == paths
    for src, img in got:
        want = develop(load_raw(src), cfg).cpu().numpy()
        np.testing.assert_array_equal(img, want)


def test_load_burst_on_the_card_equals_the_cpu(cuda, tmp_path):
    from pysp_tpu_torch import load_burst

    paths = _stream_dngs(tmp_path, 5)
    got = load_burst(paths)
    want = load_burst(paths, device="cpu")
    for k in ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat"):
        assert getattr(got, k).is_cuda
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k


def test_develop_files_on_the_card_writes_the_cpu_pngs(cuda, tmp_path):
    """At Fast (plain PyTorch on both devices) the card's stream writes the
    PNG bytes of the card's own develop saved one by one, and within one
    8-bit code of the CPU stream's PNGs: the two devices' develops differ by
    up to 2.3e-6 (the float32 cam->lin-sRGB inverse, PERF.md), which moves a
    sample that sits that close to a rounding boundary by one code."""
    from pysp_tpu_torch import QualityDemosaic, develop_files, load_raw, save_image

    paths = _stream_dngs(tmp_path, 6)
    cfg = DevelopConfig(quality=QualityDemosaic.Fast)
    card = develop_files(paths, str(tmp_path / "card"), cfg)
    host = develop_files(paths, str(tmp_path / "host"), cfg, device="cpu")
    assert len(card) == len(host) == 6
    for src, a, b in zip(paths, card, host):
        one = str(tmp_path / "one.png")
        save_image(one, develop(load_raw(src), cfg))
        with open(a, "rb") as fa, open(b, "rb") as fb, open(one, "rb") as fo:
            got, cpu, want = fa.read(), fb.read(), fo.read()
        assert got == want, a
        diff = read_png(got).astype(np.int64) - read_png(cpu).astype(np.int64)
        assert np.abs(diff).max() <= 1, a


# --- the mesh (parallel/) on the card -------------------------------------------------


def test_make_mesh_without_a_gpu_raises(monkeypatch):
    """make_mesh() takes the visible cards and never falls back to the CPU."""
    from pysp_tpu_torch import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 2), ["cuda:0"] * 2)


@pytest.mark.parametrize("quality", ["Best", "Fast"])
def test_mesh_on_the_card_matches_the_cpu_mesh(cuda, quality):
    """develop_spatial and the row-sharded config-5 chain on a (1, 2) mesh of
    cuda:0 against the same on a (1, 2) CPU mesh: Fast within 1e-5 (the
    card's matrix inverse rounds differently), Best within the AHD kernel's
    flip bound; Best's interior equal to the card's monolithic develop, with
    one AHD launch a shard."""
    from pysp_tpu_torch import (PipelineConfig, Poly3CorrectionModel, QualityDemosaic,
                                encode_warp_rectilinear, make_mesh)
    from pysp_tpu_torch.parallel.spatial import develop_spatial
    from pysp_tpu_torch.parallel.spatial_pipeline import develop_frame_spatial

    cfg = DevelopConfig(quality=getattr(QualityDemosaic, quality))
    card_mesh, cpu_mesh = make_mesh((1, 2), [cuda] * 2), make_mesh((1, 2), ["cpu"] * 2)
    frame = _frame(256, 192, 5, False, cuda, noise=0.01)
    before = K.ahd_kernel_launches
    got = develop_spatial(frame, cfg, card_mesh)
    assert got.is_cuda
    assert K.ahd_kernel_launches - before == (2 if quality == "Best" else 0)
    want = develop_spatial(frame.to("cpu"), cfg, cpu_mesh)
    if quality == "Best":
        assert torch.equal(got[16:-16], develop(frame, cfg)[16:-16])
        assert psnr(got.cpu().numpy(), want.numpy()) >= 50
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

    model = Poly3CorrectionModel(0.01)
    block = encode_warp_rectilinear([(1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)] * 3,
                                    (0.5, 0.5))
    pcfg = PipelineConfig(develop=cfg, repair_hot_pixels=True)
    kw = dict(ca_model_r=model, ca_model_b=model, warp_block=block)
    got = develop_frame_spatial(frame, card_mesh, pcfg, **kw)
    want = develop_frame_spatial(frame.to("cpu"), cpu_mesh, pcfg, **kw)
    assert got.is_cuda and bool(torch.isfinite(got).all())
    assert psnr(got.cpu().numpy(), want.numpy()) >= 50
