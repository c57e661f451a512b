"""Host decode and output of pysp_tpu_torch against the JAX package.

The same synthetic DNG bytes go through ``pysp_tpu.io.raw_loader.load_raw_dng``
and the port's ``load_raw``; every frame field must be identical.
"""
import numpy as np
import pytest
import torch

from pysp_tpu.io import tiff as JT
from pysp_tpu.io.raw_loader import load_raw_dng as jax_load_raw_dng
from pysp_tpu_torch import BayerPattern, load_raw, save_image
from pysp_tpu_torch.io import image_out
from pysp_tpu_torch.io import tiff as TT

torch.set_num_threads(1)

PATTERNS = {"rggb": ((0, 1, 1, 2), BayerPattern.Rggb),
            "bggr": ((2, 1, 1, 0), BayerPattern.Bggr)}
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _bayer_u16(h=64, w=80, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(200, 4000, (h, w)).astype(np.uint16)


@pytest.mark.parametrize("geometry", ["full", "area_crop"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_load_raw_matches_jax(pattern, geometry, tmp_path):
    cfa, want_pattern = PATTERNS[pattern]
    extra = {}
    if geometry == "area_crop":
        extra = dict(active_area=(2, 4, 61, 75), crop_origin=(2, 2), crop_size=(64, 52))
    blob = JT.write_synthetic_dng(_bayer_u16(), cfa_pattern=cfa, **extra)
    assert TT.write_synthetic_dng(_bayer_u16(), cfa_pattern=cfa, **extra) == blob

    path = tmp_path / "shot.dng"
    path.write_bytes(blob)
    want = jax_load_raw_dng(blob)
    for source in (blob, str(path)):
        got = load_raw(source, device="cpu")
        assert got.source_pattern == want.source_pattern == want_pattern
        assert got.is_hdr == want.is_hdr
        for k in FIELDS:
            g = getattr(got, k)
            assert g.device.type == "cpu" and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, k)), err_msg=k)
    if geometry == "area_crop":
        assert tuple(got.bayer.shape) == (52, 64)


def test_load_raw_defaults_to_the_card(tmp_path):
    """Without ``device`` the frame goes to the card; with no GPU the call
    raises instead of loading onto the CPU."""
    path = tmp_path / "shot.dng"
    path.write_bytes(JT.write_synthetic_dng(_bayer_u16()))
    if torch.cuda.is_available():
        assert load_raw(str(path)).bayer.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_raw(str(path))


def test_save_image_tiff_matches_jax_writer(tmp_path):
    from pysp_tpu.io.image_out import save_tiff16 as jax_save_tiff16

    rng = np.random.default_rng(1)
    srgb = rng.uniform(-0.1, 1.1, (12, 10, 3)).astype(np.float32)
    save_image(str(tmp_path / "port.tif"), torch.from_numpy(srgb))
    jax_save_tiff16(str(tmp_path / "jax.tif"), srgb)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    np.testing.assert_array_equal(image_out.to_uint8(srgb), image_out.to_uint8(torch.from_numpy(srgb)))
