"""The frozen reference against the port's plain path as it stands, at small
sizes on the CPU: the white balance, the normalisation, the three develops,
the detector, the heal, the fuse, the whole HDR pipeline and the 8-bit
quantisation."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from isp_bench.tests import helpers  # noqa: I001 (sets the matrix cache first)
from isp_bench import gen
from isp_bench.drivers import resident
from isp_bench.reference import colour
from isp_bench.reference import develop as ref

CONF = json.loads((Path(__file__).parents[1] / "configs" / "hdr5.json").read_text())
CAMERA = CONF["camera"]


def program_frame(counts):
    return resident._frame(counts, CAMERA, resident._controller(CAMERA),
                           CAMERA["exposure_time"], "cpu")


def test_white_balance_matches_the_port():
    c = resident._controller(CAMERA)
    mat, white, neutral = colour.white_balance(CAMERA)
    np.testing.assert_array_equal(mat, c.get_matrix().mat)
    np.testing.assert_array_equal(white, c.get_matrix().xyz)
    np.testing.assert_array_equal(neutral, c.get_neutral())


def test_white_balance_matches_a_dng_load():
    from pysp_tpu_torch import load_raw

    counts = gen.to_counts(gen.scene_mosaic(32, 48, 5, 0, "cpu"))
    f = load_raw(gen.dng_bytes(counts, CAMERA, 1), device="cpu")
    r = ref.frame(counts, CAMERA)
    for k in ("bayer", "cam_mat", "cam_white", "wb_neutral"):
        assert torch.equal(getattr(f, k), getattr(r, k)), k
    assert float(f.ev) == pytest.approx(r.ev, rel=1e-6)


@pytest.mark.parametrize("quality,atol", [("best", 0.0), ("fast", 1e-5), ("draft", 1e-5)])
@pytest.mark.parametrize("shape", [(64, 96), (66, 102)])
def test_develop_matches_the_plain_port(quality, atol, shape):
    from pysp_tpu_torch import DevelopConfig, QualityDemosaic, develop

    counts = gen.to_counts(gen.scene_mosaic(*shape, 11, 1, "cpu"))
    got = develop(program_frame(counts), DevelopConfig(quality=QualityDemosaic[quality.capitalize()],
                                                       use_pallas=False))
    want = ref.develop(ref.frame(counts, CAMERA), quality)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= atol


def test_detector_heal_and_fuse_match_the_port():
    from pysp_tpu_torch import find_erroneous_pixels_median
    from pysp_tpu_torch.correct.bad_pixels import masked_fill_inpaint
    from pysp_tpu_torch.core.bayer import bayer_to_planes

    mosaic = gen.scene_mosaic(256, 384, 3, 0, "cpu")
    sites = gen.hot_sites(mosaic, 9, 6, 0)
    counts = gen.bracket_counts(mosaic, sites, [1.0])[0]
    f = program_frame(counts)
    want = find_erroneous_pixels_median(f)
    got = ref.hot_masks(f.bayer, 1.5, 0.9999)
    assert torch.equal(got, want)
    assert bool(got.any())
    planes = bayer_to_planes(f.bayer)
    assert torch.equal(ref.heal(planes, got), masked_fill_inpaint(planes, got))


def test_hdr_pipeline_matches_the_port():
    from pysp_tpu_torch import PipelineConfig, develop_pipeline, stack_frames

    pipe = CONF["pipeline"]
    mosaic = gen.scene_mosaic(256, 384, 4, 0, "cpu")
    sites = gen.hot_sites(mosaic, 8, 6, 0)
    burst = gen.bracket_counts(mosaic, sites, CONF["brackets"]["scales"])
    times = [tuple(t) for t in CONF["brackets"]["exposure_times"]]
    ctrl = resident._controller(CAMERA)
    frames = [resident._frame(burst[k], CAMERA, ctrl, t, "cpu") for k, t in enumerate(times)]
    got = develop_pipeline(stack_frames(frames, device="cpu"), PipelineConfig(
        fuse_hdr=True, repair_hot_pixels=True, hot_pixel_shared_ratio=pipe["hot_pixel_shared_ratio"]))
    want = ref.hdr_pipeline([ref.frame(burst[k], CAMERA, t) for k, t in enumerate(times)], pipe, 1)
    assert torch.equal(got, want)


def test_to_uint8_matches_the_port():
    from pysp_tpu_torch.io.image_out import to_uint8

    x = torch.linspace(-0.1, 1.1, 10001).reshape(-1, 1)
    assert np.array_equal(ref.to_uint8(x).numpy(), to_uint8(x))


def test_cells_are_correct_at_small_sizes():
    for cell in ("cam24.best", "cam24.preview", "hdr5.bracket", "cam24.files"):
        result, _ = helpers.run_cell(cell)
        assert result["correct"], (cell, result["checks"])
        assert result["attempted"] > 0 and result["failed"] == 0
