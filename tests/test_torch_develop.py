"""develop / develop_to_image / develop_burst of pysp_tpu_torch against pysp_tpu.

Gate: >= 50 dB PSNR. The reference is ``pysp_tpu.develop`` run op by op
(``develop.__wrapped__``, the function the JAX package's own burst path
calls): under ``jax.jit`` XLA fuses CIELAB's pow and cbrt, which rounds them
differently and flips H/V picks at exact homogeneity ties, 41 dB from the
op-by-op run on this scene (see test_torch_ahd.py). The jitted program itself
is held to the same gate on the scene with identity colour metadata, where it
is 67 dB from its op-by-op run.
"""
import numpy as np
import pytest
import torch

from pysp_tpu.const import BayerPattern as JaxPattern
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop as jax_develop
from pysp_tpu.pipeline.develop import develop_to_image as jax_develop_to_image
from pysp_tpu.utils.testing import make_scene, mosaic_rggb, psnr
from pysp_tpu_torch import (
    BayerPattern,
    DevelopConfig,
    RawFrame,
    develop,
    develop_burst,
    develop_to_image,
)

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
MIN_PSNR = 50.0


def _frames(pattern="rggb", identity=False, seed=0, h=160, w=192):
    meta = {} if identity else dict(cam_mat=CAM, wb_neutral=WB)
    jax_pattern = JaxPattern.Bggr if pattern == "bggr" else JaxPattern.Rggb
    jf = JaxFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=seed)),
                            source_pattern=jax_pattern, **meta)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS),
                             source_pattern=BayerPattern(int(jax_pattern)), device="cpu")
    return jf, tf


@pytest.mark.parametrize("tail", [(True, True), (False, False), (True, False), (False, True)])
@pytest.mark.parametrize("pattern", ["rggb", "bggr"])
def test_develop_matches_jax(pattern, tail):
    jf, tf = _frames(pattern)
    kw = dict(clip_highlights=tail[0], gamma_encode=tail[1])
    want = np.asarray(jax_develop.__wrapped__(jf, JaxConfig(**kw)))
    got = develop(tf, DevelopConfig(**kw))
    assert got.shape == (160, 192, 3) and got.dtype == torch.float32
    assert psnr(got.numpy(), want) >= MIN_PSNR


def test_jitted_develop_matches_on_identity_metadata():
    jf, tf = _frames(identity=True)
    want = np.asarray(jax_develop(jf, JaxConfig()))
    assert psnr(develop(tf).numpy(), want) >= MIN_PSNR


@pytest.mark.parametrize("stages", [0, 2])
@pytest.mark.parametrize("pattern", ["rggb", "bggr"])
def test_develop_to_image_matches_jax(pattern, stages):
    jf, tf = _frames(pattern, seed=1)
    want = jax_develop_to_image(jf, JaxConfig(postprocess_stages=stages))
    got = develop_to_image(tf, DevelopConfig(postprocess_stages=stages))
    assert psnr(got.image.numpy(), np.asarray(want.image)) >= MIN_PSNR
    for k in ("wb_coeff", "cam_mat", "cam_white", "ev"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert (got.wb_applied, got.wb_normalized) == (want.wb_applied, want.wb_normalized)


def test_develop_burst_is_a_loop_of_develops():
    frames = [_frames(seed=s, h=64, w=80)[1] for s in (2, 3)]
    burst = frames[0].replace(**{
        k: torch.stack([getattr(f, k) for f in frames]) for k in FIELDS
    })
    got = develop_burst(burst)
    assert got.shape == (2, 64, 80, 3)
    for i, f in enumerate(frames):
        assert torch.equal(got[i], develop(f))
