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
from pysp_tpu_torch.demosaic.ahd_mega import demosaic_ahd_mega, margin_for
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _frame(h, w, seed, is_hdr, device):
    return RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=seed)), cam_mat=CAM,
                              wb_neutral=WB, is_hdr=is_hdr, device=device)


@pytest.mark.parametrize("shape", [(37, 50), (64, 64), (200, 333)])
def test_postprocess_kernel_bit_exact(cuda, shape):
    rgb = torch.from_numpy(make_scene(*shape, seed=1)).to(cuda)
    chans = [rgb[..., k].contiguous() for k in range(3)]
    before = K.postprocess_kernel_launches
    got = K.postprocess_color_kernel(*chans)
    assert K.postprocess_kernel_launches == before + 1
    for g, w in zip(got, postprocess_color_channels(*chans)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(256, 320), (250, 334)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_kernel_against_plain(cuda, is_hdr, stages, shape):
    frame = _frame(*shape, seed=stages, is_hdr=is_hdr, device=cuda)
    before = K.ahd_kernel_launches
    got = torch.stack(demosaic_ahd_mega(frame, stages))
    assert K.ahd_kernel_launches == before + 1
    want = torch.stack(demosaic_ahd_channels(frame, stages))
    f = 2 * margin_for(stages)
    inner = np.s_[:, f:-f, f:-f]
    border = torch.ones_like(want, dtype=torch.bool)
    border[inner] = False
    assert torch.equal(got[border], want[border])
    g, w = got[inner].cpu().numpy(), want[inner].cpu().numpy()
    assert psnr(g, w) >= 50
    assert np.mean(np.abs(g - w) > 1e-4) < 0.05


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


def test_small_frames_take_the_postprocess_kernel_alone(cuda):
    """Frames under four strip widths develop by the plain AHD with the
    postprocess kernel, which is bit-exact, so the image equals plain."""
    frame = _frame(96, 160, seed=5, is_hdr=False, device=cuda)
    before = (K.ahd_kernel_launches, K.postprocess_kernel_launches)
    got = develop(frame)
    assert (K.ahd_kernel_launches, K.postprocess_kernel_launches) == (before[0], before[1] + 1)
    assert torch.equal(got, develop(frame, DevelopConfig(use_pallas=False)))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    frame = _frame(64, 64, seed=4, is_hdr=False, device=cuda)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    with pytest.raises(ValueError, match="even"):
        K.ahd_kernel(frame.bayer[:63], mat, wb, False, 1)
    with pytest.raises(TypeError, match="float32"):
        K.ahd_kernel(frame.bayer.double(), mat, wb, False, 1)
    with pytest.raises(ValueError, match="stages"):
        K.ahd_kernel(frame.bayer, mat, wb, False, K.AHD_MAX_STAGES + 1)
    with pytest.raises(ValueError, match="shape"):
        K.postprocess_color_kernel(frame.bayer, frame.bayer, frame.bayer[:32])
