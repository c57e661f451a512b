"""The Best develop's counted work: the float32 operations a pixel of the
frozen plain Best develop, recounted with the copy of ``FloatOpCount``."""
import pytest

from isp_bench.tests import helpers  # noqa: F401
from isp_bench import gen, roofline
from isp_bench.reference import develop as ref
from isp_bench.tests.test_isp_bench_reference import CAMERA


def test_best_ops_per_pixel_recounted():
    h, w = 128, 192
    frame = ref.frame(gen.to_counts(gen.scene_mosaic(h, w, 1, 0, "cpu")), CAMERA)
    with roofline.FloatOpCount() as counter:
        ref.develop(frame, "best", 1)
    assert counter.ops / (h * w) == pytest.approx(roofline.BEST_OPS_PER_PX, rel=0.01)


def test_least_time_of_a_24mp_best_develop():
    least = roofline.best_develop_least_s(4000 * 6000)
    assert least == pytest.approx(879 * 24e6 / 67e12)          # bound by operations
    assert least > 16 * 24e6 / 3.35e12
