"""The cell mf102.lens at a size a CPU test holds: its driver, its check, its
control and faults, and the readers of its per-layer metrics."""
import json
import time
from pathlib import Path

import pytest

from isp_bench.tests import helpers  # noqa: I001 (sets the matrix cache first)
from isp_bench import devtrace, harness
from isp_bench.drivers import lens as driver
from pysp_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
CELL = "mf102.lens"
NEW = ("device_ms_per_item.lens", "device_idle_pct.lens", "launches_per_item.lens",
       "ca_device_ms_per_item.lens", "warp_device_ms_per_item.lens", "remap_roofline_pct.lens")


def _scale() -> dict:
    """256x384 with six single hot sites (a small scene has no 2x2 dark quad)
    and CA of about 2 px at that size, as the configuration's at 102 MP."""
    conf = json.loads((ROOT / "isp_bench" / "configs" / "mf102.json").read_text())
    lens = {**conf["lens"], "ca_models": {"r": {"type": "Poly3", "k1": 0.02},
                                          "b": {"type": "Poly3", "k1": -0.02}}}
    return {"height": 256, "width": 384, "hot_pixels": {"singles": 6, "clusters": 0},
            "lens": lens}


def _context():
    import torch

    torch.set_num_threads(1)
    return harness.Context(CELL, helpers.SEED, device="cpu", scale=_scale())


def _run(program=None, seconds=0.3):
    ctx = _context()
    if callable(program):
        program = program(ctx)
    return harness.execute(ctx, seconds, False, time.perf_counter(), program=program), ctx


def test_the_cell_is_correct_at_a_small_size():
    result, ctx = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"off_share", "rms"}
    assert set(result["metrics"]) == {"mp_per_s", "latency_p95_ms", "setup_s"}
    assert {it.kind for it in ctx.run.items} == {"best"}
    assert ctx.run.items[0].mp == pytest.approx(256 * 384 / 1e6)
    # an untraced run leaves the recorder off and puts no spans on the run
    assert not hasattr(ctx.run, "spans")


@pytest.mark.parametrize("make", [driver.control, *driver.FAULTS], ids=lambda f: f.__name__)
def test_the_control_and_each_fault_fail_the_check(make):
    result, _ = _run(make)
    assert not result["correct"], (make.__name__, result["checks"])


class _Session:
    """What ``window`` needs of a ``devtrace.Session`` on the CPU."""

    def __init__(self):
        self.spans, self.lo, self.hi = [], None, None

    def mark(self, which):
        setattr(self, which, time.time_ns())

    def span(self, name, start, end):
        self.spans.append((name, start, end))


def test_a_traced_window_puts_the_ports_spans_on_the_run():
    ctx = _context()
    state = driver.prepare(ctx)
    driver.window(state, ctx, 0.3, _Session())
    run = ctx.run
    n = len(run.items)
    assert n > 0 and not tracing._recording
    names = [s.name for s in run.spans]
    assert names.count("pipeline.develop_lens_corrected") == n
    assert names.count("ca.remove") == names.count("warp.opcode3") == n
    assert names.count("ca.remap") == 4 * n and names.count("warp.remap") == n
    assert run.counters["ca.maps_built"] == 4 * n
    # on the CPU no span is timed on the device, so the span readers read nothing
    for name in ("ca_device_ms_per_item.lens", "warp_device_ms_per_item.lens"):
        assert harness.read_metric(name, run) is None
    driver.release(state)


def _span(name, ms):
    return tracing.Span(name, 0, 1, 1, "MainThread", 1, None, 1, None, ms)


def test_the_span_readers_sum_device_ms_per_item():
    ctx = _context()
    run = ctx.run
    run.items = [harness.Item(0, 1, 101.76, "best")] * 4
    run.spans = [_span("ca.remove", 30.0)] * 4 + [_span("ca.remap", 9.0)] * 16 \
        + [_span("warp.opcode3", 6.0)] * 4 + [_span("warp.remap", 5.0)] * 4
    assert harness.read_metric("ca_device_ms_per_item.lens", run) == pytest.approx(30.0)
    assert harness.read_metric("warp_device_ms_per_item.lens", run) == pytest.approx(6.0)
    run.spans = []
    assert harness.read_metric("ca_device_ms_per_item.lens", run) is None


def test_the_remap_roofline_reads_the_kernels_by_name():
    from isp_bench import roofline_remap

    ctx = harness.Context(CELL, helpers.SEED, device="cpu")
    run = ctx.run
    run.items = [harness.Item(0, 1, 101.76, "best")] * 10
    assert harness.read_metric("remap_roofline_pct.lens", run) is None      # no trace
    by_kernel = [("(anonymous namespace)::ahd_kernel<1>", 0.05),
                 ("(anonymous namespace)::lanczos4_kernel<3>", 0.07),
                 ("(anonymous namespace)::bilinear_kernel<true, int>", 0.03),
                 ("at::native::elementwise_kernel[MulFunctor]", 0.2)]
    run.trace = devtrace.Trace(20.0, 19.0, 0.35, 100, by_kernel, [])
    want = 100 * roofline_remap.item_least_s(8736 * 11648) / 0.01
    assert harness.read_metric("remap_roofline_pct.lens", run) == pytest.approx(want)
    assert 0 < want < 100
    run.trace = devtrace.Trace(20.0, 19.0, 0.35, 100, by_kernel[3:], [])
    assert harness.read_metric("remap_roofline_pct.lens", run) is None


def test_the_benchmark_lists_the_cell_under_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == "mf102" and cell["traffic"] == "lens"
    (conf,) = [c for c in bench["configs"] if c["name"] == "mf102"]
    assert conf["reduced"] == [] and conf["file"] == "isp_bench/configs/mf102.json"
    ends = {m["name"]: m for m in bench["end_to_end"]}
    assert ends["mp_per_s"]["workloads"] == ["cam24.best", CELL]
    assert ends["latency_p95_ms"]["workloads"] == ["cam24.best", CELL]
    layers = {m["name"]: m for m in bench["per_layer"]}
    assert all(layers[n]["workloads"] == [CELL] for n in NEW)
    ctx = harness.Context(CELL, 1, device="cpu")
    assert {m["name"] for m in ctx.metrics(True)} == set(NEW)
    assert {m["name"] for m in ctx.metrics(False)} == {"mp_per_s", "latency_p95_ms", "setup_s"}
