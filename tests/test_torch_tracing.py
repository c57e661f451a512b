"""The span recorder of ``pysp_tpu_torch/utils/tracing.py`` and the spans
and counters the port's paths record, on the CPU."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pysp_tpu_torch import (
    DevelopConfig,
    PipelineConfig,
    RawFrame,
    develop_files,
    develop_pipeline,
    stack_frames,
)
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.utils import tracing
from pysp_tpu_torch.utils.tracing import span
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb

torch.set_num_threads(1)

KERNELS = ("ahd", "postprocess", "rl", "remap", "heal", "median5", "homogeneity", "decision",
           "multisection", "eag_resample")


@pytest.fixture
def recorder():
    """The recorder on for one test, and off with nothing left after it."""
    tracing.drain()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.drain()


def _by_id(spans):
    return {s.span_id: s for s in spans}


def _ancestors(s, by_id):
    while s.parent_id is not None:
        s = by_id[s.parent_id]
        yield s


def test_off_span_is_one_shared_object_and_reads_no_clock(monkeypatch):
    tracing.disable()
    tracing.drain()

    def boom(*_):
        raise AssertionError("a clock or an event was read with the recorder off")

    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(time, "thread_time_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    off = span("a")
    assert span("b", item=3, device=True) is off
    with off:
        with span("c"):
            pass
    tracing.count("test.off")
    monkeypatch.undo()
    got = tracing.drain()
    assert got.spans == [] and "test.off" not in got.counters


def test_spans_nest_with_parent_ids_and_share_the_root_item(recorder):
    with span("root") as root:
        with span("child"):
            with span("leaf"):
                pass
        with span("sibling", item="other"):
            pass
    with span("next"):
        pass
    got = {s.name: s for s in recorder.drain().spans}
    assert got["root"].parent_id is None and got["next"].parent_id is None
    assert got["child"].parent_id == got["root"].span_id == root.span_id
    assert got["leaf"].parent_id == got["child"].span_id
    assert got["sibling"].parent_id == got["root"].span_id
    assert got["child"].item == got["leaf"].item == got["root"].item
    assert got["sibling"].item == "other" and got["next"].item != got["root"].item
    r, c = got["root"], got["child"]
    assert r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns
    assert r.thread_id == threading.get_ident() and r.thread_name == "MainThread"
    assert r.cpu_ns >= 0 and r.device_ms is None
    assert [s.name for s in recorder.drain().spans] == []      # drained once


def test_a_span_without_the_cpu_clock(recorder, monkeypatch):
    def boom():
        raise AssertionError("the thread's CPU clock was read")

    monkeypatch.setattr(time, "thread_time_ns", boom)
    with span("launch", cpu=False):
        with span("inner", cpu=False):
            pass
    monkeypatch.undo()
    with span("work"):
        pass
    got = {s.name: s for s in recorder.drain().spans}
    assert got["launch"].cpu_ns is None and got["inner"].cpu_ns is None
    assert got["inner"].parent_id == got["launch"].span_id
    assert got["work"].cpu_ns >= 0


def test_an_item_is_shared_across_threads(recorder):
    item = tracing.new_item()

    def worker():
        with span("work", item=item):
            with span("part"):
                pass

    t = threading.Thread(target=worker, name="worker-1")
    with span("driver", item=item):
        t.start()
        t.join()
    got = {s.name: s for s in recorder.drain().spans}
    assert got["work"].item == got["part"].item == got["driver"].item == item
    assert got["work"].thread_name == "worker-1" and got["work"].parent_id is None
    assert got["work"].thread_id != got["driver"].thread_id


def test_the_cap_drops_and_counts(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    before = tracing.counters().get("tracing.dropped", 0)
    for _ in range(8):
        with span("x"):
            pass
    assert len(recorder.drain().spans) == 5
    assert tracing.counters()["tracing.dropped"] - before == 3
    with span("y"):                     # a drain makes room again
        pass
    assert [s.name for s in recorder.drain().spans] == ["y"]


def test_no_span_is_lost_from_racing_threads(recorder):
    n_threads, per = 16, 300
    gate = threading.Barrier(n_threads)
    before = tracing.counters().get("test.race", 0)

    def worker(k):
        gate.wait()
        for i in range(per):
            with span("race", item=(k, i)):
                tracing.count("test.race")

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = recorder.drain()
    assert len(got.spans) == n_threads * per
    assert len({s.span_id for s in got.spans}) == n_threads * per
    assert {s.item for s in got.spans} == {(k, i) for k in range(n_threads) for i in range(per)}
    assert got.counters["test.race"] - before == n_threads * per


def test_counters_read_the_launch_counts(monkeypatch):
    for k, name in enumerate(KERNELS):
        monkeypatch.setitem(K.launch_counts, name, 10 + k)
    got = tracing.counters()
    assert {f"kernels.{n}.launches": 10 + k for k, n in enumerate(KERNELS)}.items() <= got.items()
    assert all(K.launch_counts[n] == got[f"kernels.{n}.launches"] for n in KERNELS)
    assert set(K.launch_counts) == set(KERNELS)


def test_a_kernel_build_is_a_span_and_a_count(recorder, monkeypatch, tmp_path):
    path = tmp_path / "libpysp_kernels_test.so"
    monkeypatch.setattr(K, "_library_path", lambda csrc=None, flags=None: path)
    monkeypatch.setattr(K, "_build", lambda csrc, flags, p: (p, "log", 0.5))
    before = tracing.counters().get("kernels.builds", 0)
    assert K.build_library() == (path, "log", 0.5)
    path.write_bytes(b"")                  # built: the next call finds it
    assert K.build_library() == (path, "", 0.0)
    assert [s.name for s in recorder.drain().spans] == ["kernels.build"]
    assert tracing.counters()["kernels.builds"] - before == 1


def _write_dngs(folder, n=2, h=48, w=64):
    paths = []
    for i in range(n):
        u16 = (200 + mosaic_rggb(make_scene(h, w, seed=60 + i)) * 3800).astype(np.uint16)
        path = folder / f"s{i}.dng"
        path.write_bytes(T.write_synthetic_dng(u16, compression=7 if i else 1))
        paths.append(str(path))
    return paths


def test_develop_files_spans_each_file_under_one_item(recorder, tmp_path):
    paths = _write_dngs(tmp_path)
    before = tracing.counters()
    written = develop_files(paths, str(tmp_path / "out"), DevelopConfig(), device="cpu")
    got = recorder.drain()
    assert len(written) == 2
    by_id = _by_id(got.spans)
    items = set()
    for name in ("stream.decode", "stream.save", "stream.wait_decode", "stream.launch",
                 "stream.wait_save"):
        these = [s for s in got.spans if s.name == name]
        assert len(these) == 2 and len({s.item for s in these}) == 2, name
        items |= {s.item for s in these}
    assert len(items) == 2
    for s in got.spans:
        assert s.item in items, s
    for item in items:
        mine = [s for s in got.spans if s.item == item]
        decode = next(s for s in mine if s.name == "stream.decode")
        save = next(s for s in mine if s.name == "stream.save")
        assert decode.thread_name.startswith("pysp-decode")
        assert save.thread_name.startswith("pysp-save")
        assert next(s for s in mine if s.name == "stream.wait_decode").thread_name == "MainThread"
        for name in ("io.read", "io.decode_strips", "io.normalize", "io.metadata"):
            inside = [s for s in mine if s.name == name]
            assert inside and all(decode in _ancestors(s, by_id) for s in inside), name
        for name in ("io.to_uint8", "io.png_encode", "io.write"):
            (inside,) = [s for s in mine if s.name == name]
            assert inside.parent_id == save.span_id, name
        launch = next(s for s in mine if s.name == "stream.launch")
        dev = next(s for s in mine if s.name == "develop")
        assert dev.parent_id == launch.span_id
        assert {s.name for s in mine if s.parent_id == dev.span_id} == {
            "develop.demosaic", "develop.color_matrix", "develop.tail"}
    counted = {k: v - before.get(k, 0) for k, v in got.counters.items()}
    assert counted["stream.files"] == 2
    assert counted["io.bytes_written"] == sum((tmp_path / "out" / f"s{i}.png").stat().st_size
                                              for i in range(2))
    assert counted["io.bytes_read"] >= sum((tmp_path / f"s{i}.dng").stat().st_size
                                           for i in range(2))


def _burst(n=3, h=64, w=96):
    rng = np.random.default_rng(5)
    scene = mosaic_rggb(make_scene(h, w, seed=5))
    hot = rng.random(scene.shape) < 3e-3
    bayer = np.where(hot & (scene < 0.3), 1.0, scene).astype(np.float32)
    frames = [RawFrame.synthetic(np.clip(bayer * 2.0 ** (k - 1), 0, 1).astype(np.float32),
                                 ev=12.0 - k, device="cpu") for k in range(n)]
    return stack_frames(frames, device="cpu")


@pytest.mark.parametrize("shared", [0.5, None])
def test_develop_pipeline_spans_its_stages(recorder, shared):
    burst = _burst()
    out = develop_pipeline(burst, PipelineConfig(fuse_hdr=True, repair_hot_pixels=True,
                                                 hot_pixel_shared_ratio=shared))
    got = recorder.drain().spans
    assert out.shape == (64, 96, 3)
    names = [s.name for s in got]
    assert names.count("pipeline.develop_pipeline") == 1
    assert names.count("pipeline.detect") == names.count("pipeline.correct") == 3
    assert names.count("pipeline.fuse") == names.count("develop") == 1
    assert names.count("pipeline.consensus") == (1 if shared else 0)
    (root,) = [s for s in got if s.name == "pipeline.develop_pipeline"]
    by_id = _by_id(got)
    assert all(s.item == root.item and root in _ancestors(s, by_id)
               for s in got if s is not root)
    parents = {by_id[s.parent_id].name for s in got if s.name == "pipeline.detect"}
    assert parents == ({"pipeline.develop_pipeline"} if shared else {"pipeline.correct"})
    assert by_id[next(s for s in got if s.name == "develop").parent_id] is root
    # device timing asks for CUDA events only for CUDA work; the launch path
    # reads no CPU clock
    assert all(s.device_ms is None and s.cpu_ns is None for s in got)


def test_a_single_frame_through_the_pipeline(recorder):
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(32, 48, seed=3)), device="cpu")
    develop_pipeline(frame, PipelineConfig(repair_hot_pixels=True))
    names = [s.name for s in recorder.drain().spans]
    assert names[:3] == ["pipeline.develop_pipeline", "pipeline.correct", "pipeline.detect"]
    assert names.count("develop") == 1


def test_the_example_reports_its_root_stages():
    from examples.full_pipeline_torch import stage_report

    main = threading.get_ident()
    spans = [tracing.Span("decode", 0, 2_000_000, main, "MainThread", 1, None, 1, 0, None),
             tracing.Span("io.read", 0, 1_000_000, main, "MainThread", 2, 1, 1, 0, None),
             tracing.Span("develop", 3_000_000, 4_500_000, main, "MainThread", 3, None, 2, 0,
                          None),
             tracing.Span("other", 0, 9_000_000, main + 1, "w", 4, None, 3, 0, None)]
    assert stage_report(spans).splitlines() == ["decode: 2.0 ms", "develop: 1.5 ms",
                                                "total: 3.5 ms"]
