"""Device colour transforms of pysp_tpu_torch against pysp_tpu.colorimetry.

Tolerances:

- ``cam_to_lin_srgb_matrix``: atol 1e-6 (a 3x3 inverse in float32; the two
  libraries' solvers round differently in the last place).
- ``rgb_to_lab_channels``: L within atol 1e-5. a = 500 (fx - fy) and
  b = 200 (fy - fz) multiply a one-ulp difference of the cube roots near 1
  (1.2e-7) by 500 and 200, so a is held to 1.2e-4 and b to 4.8e-5 (two such
  ulps each); measured 7.6e-6, 6.1e-5 and 3.1e-5 on the sample below.
- ``lin_srgb_to_srgb``: atol 2e-6 (the gamma ``pow``).
- ``cam_to_rgb_norm``, ``cam_to_clean_xyz`` and ``srgb_to_lin_srgb``: atol
  1e-6 (the 3x3 inverse as above; the decode's ``pow``).
- ``rgb_to_lab``: bit-equal to the port's ``rgb_to_lab_channels`` stacked,
  and against the JAX package at that function's tolerances (L reaches 100,
  where one float32 step is 7.6e-6).

torch has no cube root. ``transforms.cbrt`` is ``y = x ** (1/3)`` followed by
one Newton step ``y + (x / y**2 - y) * (1/3)``: on 1M float32 samples over
[1e-6, 4] it is within 1 ulp of the exact cube root (about 9% of values not
correctly rounded), where ``jnp.cbrt`` on the CPU is within 2 ulp (about 11%);
the two agree on about 87% of values (``jnp.cbrt`` on the CPU is XLA's
``pow(x, 1/3)``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.colorimetry import transforms as J
from pysp_tpu.core.frame import DevelopedImage as JaxImage
from pysp_tpu_torch.colorimetry import transforms as T
from pysp_tpu_torch.core.frame import DevelopedImage

torch.set_num_threads(1)

CAM_MATS = [
    np.eye(3, dtype=np.float32),
    np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32),
    np.array([[0.77, -0.11, -0.055], [-0.22, 1.21, 0.11], [0.022, -0.22, 1.32]], np.float32),
]
WHITES = [
    np.array([0.95043, 1.0, 1.08890], np.float32),
    np.array([1.0985, 1.0, 0.3558], np.float32),
]


@pytest.mark.parametrize("white", range(len(WHITES)))
@pytest.mark.parametrize("cam", range(len(CAM_MATS)))
def test_cam_to_lin_srgb_matrix(cam, white):
    want = np.asarray(J.cam_to_lin_srgb_matrix(jnp.asarray(CAM_MATS[cam]), jnp.asarray(WHITES[white])))
    got = T.cam_to_lin_srgb_matrix(torch.from_numpy(CAM_MATS[cam]), torch.from_numpy(WHITES[white]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_rgb_to_lab_channels():
    x = np.random.default_rng(0).uniform(-0.1, 1.2, (3, 100000)).astype(np.float32)
    want = J.rgb_to_lab_channels(*(jnp.asarray(c) for c in x))
    got = T.rgb_to_lab_channels(*(torch.from_numpy(c) for c in x))
    for g, w, atol in zip(got, want, (1e-5, 1.2e-4, 4.8e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_lin_srgb_to_srgb():
    x = np.random.default_rng(1).uniform(-0.2, 1.3, (64, 48, 3)).astype(np.float32)
    want = np.asarray(J.lin_srgb_to_srgb(jnp.asarray(x)))
    np.testing.assert_allclose(T.lin_srgb_to_srgb(torch.from_numpy(x)).numpy(), want, atol=2e-6, rtol=0)


def test_cbrt_within_one_ulp():
    x = np.random.default_rng(2).uniform(1e-6, 4.0, 200000).astype(np.float32)
    exact = np.cbrt(x.astype(np.float64)).astype(np.float32)
    got = T.cbrt(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - exact.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_developed_image_to_lin_srgb():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.2, (16, 12, 3)).astype(np.float32)
    wb = np.array([1.8, 1.0, 1.4], np.float32)
    kw = dict(cam_mat=CAM_MATS[1], cam_white=WHITES[0], ev=np.float32(10.0))
    want = JaxImage(image=jnp.asarray(img), wb_coeff=jnp.asarray(wb), wb_applied=False,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got = DevelopedImage(image=torch.from_numpy(img), wb_coeff=torch.from_numpy(wb),
                         wb_applied=False, **{k: torch.as_tensor(v) for k, v in kw.items()})
    for clip in (True, False):
        np.testing.assert_allclose(
            got.to_lin_srgb(clip).numpy(), np.asarray(want.to_lin_srgb(clip)), atol=2e-6, rtol=0
        )
    np.testing.assert_array_equal(got.wb_apply().wb_undo().image.numpy(),
                                  np.asarray(want.wb_apply().wb_undo().image))
    moved = got.to("cpu")
    assert moved.wb_applied is False and torch.equal(moved.image, got.image)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("cam", range(len(CAM_MATS)))
def test_cam_to_rgb_norm_and_clean_xyz(cam, clip):
    rng = np.random.default_rng(10 + cam)
    rgb = rng.uniform(-0.1, 1.3, (24, 20, 3)).astype(np.float32)
    mat, white = CAM_MATS[cam], WHITES[1]
    base, dest_white = J._REC2020_TO_XYZ.astype(np.float32), J._D65_XYZ.astype(np.float32)
    want = J.cam_to_rgb_norm(jnp.asarray(rgb), jnp.asarray(mat), jnp.asarray(white),
                             jnp.asarray(base), jnp.asarray(dest_white), clip)
    got = T.cam_to_rgb_norm(torch.from_numpy(rgb), torch.from_numpy(mat),
                            torch.from_numpy(white), torch.from_numpy(base),
                            torch.from_numpy(dest_white), clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    want = J.cam_to_clean_xyz(jnp.asarray(rgb), jnp.asarray(mat), jnp.asarray(white), clip)
    got = T.cam_to_clean_xyz(torch.from_numpy(rgb), torch.from_numpy(mat),
                             torch.from_numpy(white), clip)
    assert got.dtype == torch.float32 and got.shape == (24, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # cam_to_lin_srgb is cam_to_rgb_norm with the Rec. 709 base, bit for bit
    lin = T.cam_to_lin_srgb(torch.from_numpy(rgb), torch.from_numpy(mat),
                            torch.from_numpy(white), clip)
    assert torch.equal(lin, T.cam_to_rgb_norm(
        torch.from_numpy(rgb), torch.from_numpy(mat), torch.from_numpy(white),
        torch.from_numpy(J._REC709_TO_XYZ.astype(np.float32)),
        torch.from_numpy(dest_white), clip))


def test_srgb_to_lin_srgb():
    x = np.random.default_rng(11).uniform(-0.2, 1.3, (64, 48, 3)).astype(np.float32)
    want = np.asarray(J.srgb_to_lin_srgb(jnp.asarray(x)))
    got = T.srgb_to_lin_srgb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # and back: the decode inverts the encode on [0, 1]
    y = np.linspace(0, 1, 1001, dtype=np.float32)
    back = T.lin_srgb_to_srgb(T.srgb_to_lin_srgb(torch.from_numpy(y))).numpy()
    np.testing.assert_allclose(back, y, atol=1e-6, rtol=0)


def test_rgb_to_lab():
    x = np.random.default_rng(12).uniform(-0.1, 1.2, (50, 40, 3)).astype(np.float32)
    got = T.rgb_to_lab(torch.from_numpy(x))
    assert got.shape == (50, 40, 3)
    channels = T.rgb_to_lab_channels(*torch.from_numpy(x).unbind(-1))
    assert torch.equal(got, torch.stack(channels, dim=-1))
    want = np.asarray(J.rgb_to_lab(jnp.asarray(x)))
    for k, atol in enumerate((1e-5, 1.2e-4, 4.8e-5)):
        np.testing.assert_allclose(got[..., k].numpy(), want[..., k], atol=atol, rtol=0)
