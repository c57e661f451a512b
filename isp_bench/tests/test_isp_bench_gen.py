"""The generator: the same seed gives the same inputs, another seed others,
and the DNGs it writes decode to its counts through the port's loader."""
import numpy as np
import pytest
import torch

from isp_bench.tests import helpers  # noqa: F401 (sets the matrix cache first)
from isp_bench import gen
from isp_bench.drivers import resident
from isp_bench.tests.test_isp_bench_reference import CAMERA, CONF


def test_inputs_are_deterministic_per_seed():
    for seed in (0, 7, 2**31 + 5, 2**33 + 1):
        a = gen.scene_mosaic(96, 128, seed, 2, "cpu")
        b = gen.scene_mosaic(96, 128, seed, 2, "cpu")
        assert torch.equal(a, b)
        assert not torch.equal(a, gen.scene_mosaic(96, 128, seed + 1, 2, "cpu"))
        assert not torch.equal(a, gen.scene_mosaic(96, 128, seed, 3, "cpu"))
        assert float(a.min()) >= np.float32(0.02) and float(a.max()) <= np.float32(0.98)


def test_hot_sites_are_deterministic_and_dark():
    m = gen.scene_mosaic(512, 768, 3, 0, "cpu")
    s1, s2 = gen.hot_sites(m, 11, 20, 0), gen.hot_sites(m, 11, 20, 0)
    assert np.array_equal(s1, s2) and len(s1) == 20
    assert not np.array_equal(s1, gen.hot_sites(m, 12, 20, 0))
    assert float(m[s1[:, 0], s1[:, 1]].max()) < 0.25
    burst = gen.bracket_counts(m, s1, CONF["brackets"]["scales"])
    assert burst.shape == (5, 512, 768) and bool((burst[:, s1[:, 0], s1[:, 1]] == 4095).all())


def test_counts_are_the_same_for_both_cells_of_one_seed():
    class Ctx:
        config = {"height": 64, "width": 96}
        seed, device = 99, "cpu"
    assert torch.equal(resident.make_counts(Ctx, 1), resident.make_counts(Ctx, 1))


@pytest.mark.parametrize("compression", [1, 7])
def test_dng_decodes_to_the_counts(compression):
    from pysp_tpu_torch import load_raw

    counts = gen.to_counts(gen.scene_mosaic(40, 62, 4, 0, "cpu"))
    f = load_raw(gen.dng_bytes(counts, CAMERA, compression, (1, 50)), device="cpu")
    want = torch.clamp(counts.float() - 256, 0, 4095) / 4095
    assert torch.equal(f.bayer, want)
    assert float(f.ev) == pytest.approx(np.log2(100 * 2.8 ** 2 / (200 / 50)), rel=1e-6)


def test_lossless_jpeg_round_trips_any_16_bit_values():
    from pysp_tpu_torch.io import native

    rng = np.random.default_rng(0)
    x = rng.integers(0, 65536, (33, 47)).astype(np.int32)
    x[0, 0], x[1, :], x[2, :] = 65535, 0, 65535
    x[3, ::2] = 0
    d = native.ljpeg_decode(gen.lj92_encode(torch.from_numpy(x)))
    assert np.array_equal(d.reshape(x.shape), x)


@pytest.mark.cuda
def test_lossless_jpeg_on_the_card_writes_the_cpu_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    counts = gen.to_counts(gen.scene_mosaic(400, 600, 4, 0, "cpu"))
    assert gen.lj92_encode(counts.cuda()) == gen.lj92_encode(counts)
