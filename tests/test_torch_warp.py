"""pysp_tpu_torch's resample and DNG warp against pysp_tpu.

The same seeded inputs go through the JAX functions, run op by op
(``jax.disable_jit()``), and through the port on CPU tensors, where the remap
kernel's wrapper runs its plain version. The remap is also held against the
JAX package's Pallas remap kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.io.metadata import get_opcode_3_block as jax_get_opcode_3_block
from pysp_tpu.ops import resample as JR
from pysp_tpu.ops.pallas_kernels import remap_bounded_pallas
from pysp_tpu.warp import opcodes as JO
from pysp_tpu.warp import rectilinear as JW
from pysp_tpu_torch.io.metadata import get_opcode_3_block
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.ops import resample as TR
from pysp_tpu_torch.warp import opcodes as TO
from pysp_tpu_torch.warp import rectilinear as TW
from pysp_tpu_torch.utils.testing import make_scene

torch.set_num_threads(1)

# A lens-like warp: barrel plus a little tangential, off-centre.
COEFFS = (1.0, -0.03, 0.004, 0.0, 0.001, -0.002)
CENTER = (0.47, 0.53)
# Exact-sine Lanczos4 weights: torch's and XLA's float32 sin differ by an ulp.
LANCZOS_ATOL = 1e-6


def _image(h, w, channels, seed):
    img = make_scene(h, w, seed=seed)
    return img[..., 0].copy() if channels == 1 else img


def _jax(fn, *args, **kw):
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _maps(h, w, seed, per_channel=0):
    """Clipped warp maps, (H, W) or (C, H, W), as numpy float32."""
    xs, ys = [], []
    for k in range(max(per_channel, 1)):
        co = (1.0, COEFFS[1] + 0.01 * k + 0.001 * seed, *COEFFS[2:])
        mx, my = JW.compute_remapping_table(co, w, h, CENTER)
        xs.append(np.clip(np.asarray(mx), 0, w - 1))
        ys.append(np.clip(np.asarray(my), 0, h - 1))
    if per_channel:
        return np.stack(xs), np.stack(ys)
    return xs[0], ys[0]


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("channels", [1, 3])
def test_gather_remaps_match_jax(kind, channels):
    """Bilinear bit-exact; Lanczos4 within LANCZOS_ATOL (sin ulps)."""
    img = _image(40, 56, channels, seed=1)
    planes = img if channels == 1 else np.ascontiguousarray(np.moveaxis(img, -1, 0))
    mx, my = _maps(40, 56, seed=1)
    mx[0, :3] = [-2.5, -0.25, 60.0]          # clamped gathers off the frame
    fn_j = JR.remap_lanczos4 if kind == "lanczos4" else JR.remap_bilinear
    fn_t = TR.remap_lanczos4 if kind == "lanczos4" else TR.remap_bilinear
    want = _jax(fn_j, planes, mx, my)
    got = fn_t(_t(planes), _t(mx), _t(my)).numpy()
    if kind == "bilinear":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=LANCZOS_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("bounds", ["own", "tight"])
def test_remap_bounded_matches_jax(kind, bounds):
    """The port's bounded remap equals the JAX package's select-chain bounded
    remap, with the warp's own bounds and with bounds tighter than the maps'
    displacement (each floor displacement clipped)."""
    h, w = 36, 48
    img = _image(h, w, 1, seed=2)
    mx, my = _maps(h, w, seed=2)
    dyb, dxb = JW.displacement_bounds(COEFFS, w, h, CENTER)
    if bounds == "tight":
        dyb, dxb = (dyb[0] + 1, dyb[1] - 1), (dxb[0] + 1, dxb[1] - 1)
    want = _jax(JR.remap_bounded, img, mx, my, dyb, dxb, kind=kind)
    got = TR.remap_bounded(_t(img), _t(mx), _t(my), dyb, dxb, kind=kind).numpy()
    if kind == "bilinear":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=LANCZOS_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("maps", ["shared", "per_channel"])
def test_remap_plain_matches_the_jax_remap_kernel(kind, maps):
    """The remap kernel's plain version against the JAX package's Pallas remap
    kernel in interpret mode, on a (C, H, W) stack. Bilinear within 2.5e-7:
    interpret mode compiles the kernel body with XLA, which fuses the lerps'
    multiply-adds (1 ulp off on a quarter of the pixels). The Pallas Lanczos4
    uses polynomial weights, within their 2e-5."""
    h, w = 32, 40
    img = np.ascontiguousarray(np.moveaxis(_image(h, w, 3, seed=3), -1, 0))
    mx, my = _maps(h, w, seed=3, per_channel=3 if maps == "per_channel" else 0)
    dyb, dxb = JW.displacement_bounds(COEFFS, w, h, CENTER, margin=2)
    want = np.asarray(remap_bounded_pallas(jnp.asarray(img), jnp.asarray(mx),
                                           jnp.asarray(my), dyb, dxb, kind,
                                           interpret=True))
    got = K.remap_plain(_t(img), _t(mx), _t(my), kind, (dyb, dxb)).numpy()
    np.testing.assert_allclose(got, want, atol=2.5e-7 if kind == "bilinear" else 2e-5,
                               rtol=0)


def test_remap_kernel_wrapper_checks_and_cpu_route():
    img = _t(_image(20, 24, 3, seed=4))
    mx, my = (_t(m) for m in _maps(20, 24, seed=4))
    before = K.launch_counts["remap"]
    got = K.remap_kernel(img, mx, my, "lanczos4", channels_last=True)
    assert K.launch_counts["remap"] == before
    assert torch.equal(got, K.remap_plain(img, mx, my, "lanczos4", channels_last=True))
    assert got.shape == img.shape
    with pytest.raises(ValueError, match="kind"):
        K.remap_kernel(img, mx, my, "lanczos4_sep", channels_last=True)
    with pytest.raises(ValueError, match="fit"):
        K.remap_kernel(img, mx[:10], my[:10], "bilinear", channels_last=True)
    with pytest.raises(ValueError, match="per-channel"):
        K.remap_kernel(img[..., 0], mx.expand(2, -1, -1), my.expand(2, -1, -1))
    with pytest.raises(ValueError, match="lo <= hi"):
        K.remap_kernel(img, mx, my, "bilinear", ((1, -1), (0, 0)), channels_last=True)


def test_bilinear_sample_and_identity_map_match_jax():
    img = _image(20, 24, 1, seed=5)
    want = _jax(JR.bilinear_sample, img, (1.25, -0.5), 17, 13)
    got = TR.bilinear_sample(_t(img), (1.25, -0.5), 17, 13).numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(TR.identity_map(7, 9), JR.identity_map(7, 9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_remapping_tables_match_jax(scale):
    """Float32 in the JAX order, division by a 0-d tensor: bit-exact."""
    h, w = 30, 44
    want = _jax(JW.compute_remapping_table, COEFFS, w, h, CENTER, scale)
    got = TW.compute_remapping_table(COEFFS, w, h, CENTER, scale, device="cpu")
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
    win = TW.compute_remapping_table_window(COEFFS, w, h, CENTER, scale, 7, 9,
                                            device="cpu")
    for g, full in zip(win, got):
        assert torch.equal(g, full[7:16])
    seeds = [_t(m) for m in _maps(h, w, seed=6)]
    want = _jax(JW.compute_offset_remapping_table, *(m.numpy() for m in seeds),
                COEFFS, w, h, CENTER, scale)
    got = TW.compute_offset_remapping_table(*seeds, COEFFS, w, h, CENTER, scale)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)


@pytest.mark.parametrize("shape,coeffs,kw", [
    ((30, 44), COEFFS, {}),
    ((400, 600), (1.0, -0.003, 0, 0, 0, 0), {}),
    ((300, 200), (1.0, 0.05, -0.01, 0.002, 0.003, 0.001), dict(scale=0.5, margin=2)),
    ((300, 200), COEFFS, dict(row_range=(0, 40), col_range=(150, 200))),
    ((300, 200), (1.0, -0.9, 0, 0, 0, 0), {}),   # beyond the cap: None
])
def test_displacement_bounds_equal_jax(shape, coeffs, kw):
    h, w = shape
    assert (TW.displacement_bounds(coeffs, w, h, CENTER, **kw)
            == JW.displacement_bounds(coeffs, w, h, CENTER, **kw))


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("prior", [False, True])
def test_warp_channel_matches_jax(kind, prior):
    h, w = 36, 52
    ch = _image(h, w, 1, seed=7)
    kw = dict(scale=1.0, interpolation=kind)
    if prior:
        px, py = _maps(h, w, seed=8)
        want = _jax(JW.warp_channel_rectilinear, ch, COEFFS, CENTER,
                    prior=(jnp.asarray(px), jnp.asarray(py)), **kw)
        got = TW.warp_channel_rectilinear(_t(ch), COEFFS, CENTER, prior=(_t(px), _t(py)),
                                          **kw)
    else:
        want = _jax(JW.warp_channel_rectilinear, ch, COEFFS, CENTER, **kw)
        got = TW.warp_channel_rectilinear(_t(ch), COEFFS, CENTER, **kw)
    atol = 0.0 if kind == "bilinear" else LANCZOS_ATOL
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("planes", ["identical", "per_channel"])
@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
def test_apply_opcode_3_warp_matches_jax(planes, kind):
    """One channel-batched remap over the (H, W, C) image against the JAX
    package's per-channel bounded remaps."""
    h, w = 40, 60
    img = _image(h, w, 3, seed=9)
    if planes == "identical":
        coeffs = [COEFFS] * 3
    else:
        coeffs = [(1.0, COEFFS[1] + 0.004 * k, *COEFFS[2:]) for k in range(3)]
    block = TO.encode_warp_rectilinear(coeffs, CENTER)
    assert block == JO.encode_warp_rectilinear(coeffs, CENTER)
    want = _jax(JO.apply_opcode_3_warp, img, block, interpolation=kind)
    got = TO.apply_opcode_3_warp(_t(img), block, interpolation=kind).numpy()
    atol = 0.0 if kind == "bilinear" else LANCZOS_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_apply_opcode_3_warp_with_prior_matches_jax():
    h, w = 40, 60
    img = _image(h, w, 3, seed=10)
    block = TO.encode_warp_rectilinear([COEFFS] * 3, CENTER)
    px, py = _maps(h, w, seed=11)
    with jax.disable_jit():
        jprior = JO.stack_warp_prior((h, w), (jnp.asarray(px), jnp.asarray(py)), None, None)
        want = np.asarray(JO.apply_opcode_3_warp(jnp.asarray(img), block, prior=jprior))
    tprior = TO.stack_warp_prior((h, w), (_t(px), _t(py)), None, None, device="cpu")
    for (tx, ty), (jx, jy) in zip(tprior, jprior):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    got = TO.apply_opcode_3_warp(_t(img), block, prior=tprior).numpy()
    np.testing.assert_allclose(got, want, atol=LANCZOS_ATOL, rtol=0)


def test_stack_warp_prior_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TO.stack_warp_prior((4, 5), None, None, None)[0][0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.stack_warp_prior((4, 5), None, None, None)


def test_opcode_round_trip_and_skips():
    coeffs = [(1.0, -0.01, 0.002, 0.0, 0.0005, -0.0005), COEFFS, (1.0, 0, 0, 0, 0, 0)]
    block = TO.encode_warp_rectilinear(coeffs, CENTER, flags=1)
    ops = list(TO.iter_opcodes(block))
    assert ops == list(JO.iter_opcodes(block))
    assert [(o[0], o[1], o[2]) for o in ops] == [(1, 0x01030000, 1)]
    decoded = TO.decode_warp_rectilinear(ops[0][3], 3)
    assert decoded == JO.decode_warp_rectilinear(ops[0][3], 3)
    assert [tuple(c) for c in decoded[0]] == coeffs and tuple(decoded[1]) == CENTER
    assert TO.decode_warp_rectilinear(ops[0][3], 1) is None
    assert TO.decode_warp_rectilinear(b"\x00", 3) is None
    with pytest.raises(ValueError):
        TO.encode_warp_rectilinear([(1.0, 0.0)], CENTER)
    # an unknown opcode and a malformed warp leave the image as it was
    other = (b"\x00\x00\x00\x02" + b"\x00\x00\x00\x09" + b"\x00" * 8 + b"\x00\x00\x00\x04"
             + b"abcd" + block[4:])
    img = _t(_image(16, 20, 3, seed=12))
    want = TO.apply_opcode_3_warp(img, block)
    assert torch.equal(TO.apply_opcode_3_warp(img, other), want)
    one_plane = TO.encode_warp_rectilinear([COEFFS], CENTER)
    assert torch.equal(TO.apply_opcode_3_warp(img, one_plane), img)


def test_opcode_list_3_dng_reads_back(tmp_path):
    """A DNG carrying an OpcodeList3 WarpRectilinear block gives the block back
    through both packages' readers, and the port's loader accepts it."""
    from pysp_tpu_torch import load_raw

    block = TO.encode_warp_rectilinear([COEFFS] * 3, CENTER)
    bayer = (200 + 3000 * np.random.default_rng(13).random((24, 32))).astype(np.uint16)
    path = tmp_path / "warp.dng"
    path.write_bytes(write_synthetic_dng(bayer, opcode_list_3=block))
    assert get_opcode_3_block(str(path)) == block
    assert jax_get_opcode_3_block(str(path)) == block
    assert load_raw(str(path), device="cpu").bayer.shape == (24, 32)
