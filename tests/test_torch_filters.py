"""pysp_tpu_torch's filters (blur, unsharp, Richardson-Lucy) against pysp_tpu.

The same seeded inputs go through the JAX functions, run op by op
(``jax.disable_jit()``, as the JAX package runs off the TPU), and through the
port on CPU tensors, where the RL kernel's wrapper runs its plain loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.colorimetry import transforms as JT
from pysp_tpu.filters import blur as JB
from pysp_tpu.filters import sharpen as JS
from pysp_tpu.ops import stencil as JST
from pysp_tpu.ops.pallas_kernels import rl_deconv_pallas
from pysp_tpu_torch.colorimetry import transforms as TT
from pysp_tpu_torch.filters import blur as TB
from pysp_tpu_torch.filters import sharpen as TS
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.ops import stencil as TST
from pysp_tpu_torch.utils.testing import make_scene

torch.set_num_threads(1)


def _image(h, w, channels, seed):
    """A structured scene in [0.01, 1] with a little noise: (H, W) or (H, W, 3)."""
    rng = np.random.default_rng(seed)
    img = make_scene(h, w, seed=seed) + rng.normal(0, 0.01, (h, w, 3))
    img = np.clip(img, 0.01, 1.0).astype(np.float32)
    return img[..., 1].copy() if channels == 1 else img


def _jax(fn, *args):
    with jax.disable_jit():
        return np.asarray(fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args)))


def _port(fn, *args):
    return fn(*(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
                for a in args)).numpy()


@pytest.mark.parametrize("border", ["reflect", "reflect101", "replicate"])
@pytest.mark.parametrize("channels", [1, 3])
def test_filter2d_hwc_matches_jax(border, channels):
    """Same taps, same order, same pads: bit-exact."""
    x = _image(23, 31, channels, seed=channels)
    kernel = np.random.default_rng(4).random((5, 3)).astype(np.float32)
    want = _jax(lambda a: JST.filter2d_hwc(a, kernel, border), x)
    got = _port(lambda a: TST.filter2d_hwc(a, kernel, border), x)
    np.testing.assert_array_equal(got, want)


def test_window_and_taps_match_jax():
    for sigma in (0.3, 0.5, 1.0, 2.0, 2.3, 10.5):
        assert TB.get_gaussian_filter_window_size(sigma) == JB.get_gaussian_filter_window_size(sigma)
        np.testing.assert_array_equal(TB.get_1d_gaussian_filter(sigma),
                                      JB.get_1d_gaussian_filter(sigma))


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.3])
@pytest.mark.parametrize("channels", [1, 3])
def test_blur_gaussian_matches_jax(sigma, channels):
    """Two passes of the same float32 taps in the same order: bit-exact."""
    x = _image(40, 52, channels, seed=7)
    np.testing.assert_array_equal(_port(TB.blur_gaussian, x, sigma),
                                  _jax(JB.blur_gaussian, x, sigma))


@pytest.mark.parametrize("channels", [1, 3])
def test_unsharp_per_channel_matches_jax(channels):
    x = _image(40, 52, channels, seed=8)
    np.testing.assert_array_equal(_port(TS.unsharp_mask_per_channel, x, 2.0, 0.5),
                                  _jax(JS.unsharp_mask_per_channel, x, 2.0, 0.5))


def test_oklab_round_trip_matches_jax():
    """The port's cube root is within 1 ulp of exact and jnp.cbrt within 2
    (PERF.md, "Cube root"), so Oklab agrees to a few float32 ulps."""
    x = _image(30, 40, 3, seed=9)
    x[0, :4] = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    lab_j = _jax(JT.lin_srgb_to_oklab, x)
    lab_t = _port(TT.lin_srgb_to_oklab, x)
    np.testing.assert_allclose(lab_t, lab_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_port(TT.oklab_to_lin_srgb, lab_j),
                               _jax(JT.oklab_to_lin_srgb, lab_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_port(TT.oklab_to_lin_srgb, lab_t), x, atol=2e-5, rtol=0)


def test_cbrt_signed_is_odd_and_zero_at_zero():
    x = torch.tensor([-8.0, -1e-3, 0.0, -0.0, 1e-3, 27.0])
    got = TT.cbrt_signed(x)
    np.testing.assert_allclose(got.numpy(), np.cbrt(x.numpy()), rtol=2e-7)
    assert torch.equal(torch.signbit(got), torch.signbit(x))


def test_unsharp_lab_matches_jax():
    """Through Oklab and back: the cube roots' ulps (see above)."""
    x = _image(40, 52, 3, seed=10)
    np.testing.assert_allclose(_port(TS.unsharp_mask_lab, x, 2.0, 0.5),
                               _jax(JS.unsharp_mask_lab, x, 2.0, 0.5), atol=5e-6, rtol=0)


@pytest.mark.parametrize("sigma,iters", [(1.0, 5), (2.0, 3)])
@pytest.mark.parametrize("channels", [1, 3])
def test_rl_deconvolution_matches_jax(sigma, iters, channels):
    """The plain RL loop is the JAX loop op for op: bit-exact."""
    x = _image(48, 64, channels, seed=11)
    np.testing.assert_array_equal(_port(TS.gaussian_rt_deconvolution, x, sigma, iters),
                                  _jax(JS.gaussian_rt_deconvolution, x, sigma, iters))


@pytest.mark.parametrize("variant", ["lab", "yuv"])
def test_rl_colour_variants_match_jax(variant):
    """RL on Oklab L (cube-root ulps, as above) and on linear luma (bit-exact
    RL, then the same per-pixel gain)."""
    x = _image(48, 64, 3, seed=12)
    fn_t = getattr(TS, f"gaussian_rt_deconvolution_{variant}")
    fn_j = getattr(JS, f"gaussian_rt_deconvolution_{variant}")
    got, want = _port(fn_t, x, 1.0, 6), _jax(fn_j, x, 1.0, 6)
    if variant == "yuv":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rl_plain_matches_the_jax_rl_kernel():
    """``rl_plain`` against the JAX package's Pallas RL kernel in interpret
    mode, on the JAX package's own gate (tests/test_filters.py): 48x160,
    atol 2e-6, border rows and columns included."""
    rng = np.random.default_rng(31)
    h, w = 48, 160
    img = np.clip(
        0.4 + 0.3 * np.sin(np.arange(w) / 7.0)[None, :]
        + 0.2 * np.cos(np.arange(h) / 5.0)[:, None] + rng.normal(0, 0.02, (h, w)),
        0.01, 1.0,
    ).astype(np.float32)
    for sigma, iters in ((2.0, 3), (1.0, 2)):
        taps = JB.get_1d_gaussian_filter(sigma)
        want = np.asarray(rl_deconv_pallas(jnp.asarray(img), taps, iters, tile_h=16,
                                           interpret=True))
        got = K.rl_plain(torch.from_numpy(img), taps, iters).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_rl_kernel_gate_is_the_jax_kernels():
    """The frames the RL kernel takes are those the JAX kernel's gate admits
    (odd taps, reach <= 32, H and W >= 2 * reach) at any H and W; outside it
    ``gaussian_rt_deconvolution`` runs the plain loop."""
    taps2 = JB.get_1d_gaussian_filter(2.0)        # 13 taps, reach 6
    assert K.rl_kernel_admits((12, 12), taps2)
    assert K.rl_kernel_admits((47, 61, 3), taps2)
    assert not K.rl_kernel_admits((8, 8), taps2)
    assert not K.rl_kernel_admits((48, 11), taps2)
    assert not K.rl_kernel_admits((64, 64), np.ones(4, np.float32))
    assert not K.rl_kernel_admits((64, 64), np.ones(1, np.float32))
    assert K.rl_kernel_admits((128, 128), np.ones(65, np.float32))
    assert not K.rl_kernel_admits((128, 128), np.ones(67, np.float32))
    # the JAX kernel's refusals at these shapes agree
    assert rl_deconv_pallas(jnp.zeros((8, 8), jnp.float32), taps2, 2) is None
    x = _image(8, 8, 1, seed=13)
    np.testing.assert_array_equal(_port(TS.gaussian_rt_deconvolution, x, 2.0, 2),
                                  _port(lambda a: K.rl_plain(a, taps2, 2), x))


def test_rl_kernel_wrapper_on_cpu_is_the_plain_loop():
    x = torch.from_numpy(_image(40, 44, 3, seed=14))
    taps = TB.get_1d_gaussian_filter(1.0)
    before = K.launch_counts["rl"]
    assert torch.equal(K.rl_kernel(x, taps, 4), K.rl_plain(x, taps, 4))
    assert K.launch_counts["rl"] == before
