"""The readers of the port's spans (``isp_bench/spans.py``) on hand-made
spans and gaps."""
import random
from typing import NamedTuple, Optional

import pytest

from isp_bench import devtrace, spans as S

MAIN, WORKER = 1, 2
MS = 1_000_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread_id: int = MAIN
    device_ms: Optional[float] = None
    cpu_ns: int = 0


def test_flat_spans_label_the_gaps_as_the_benchmark_does():
    rnd = random.Random(7)
    for _ in range(200):
        harness, t = [], 0
        for _ in range(rnd.randint(0, 6)):
            t += rnd.randint(0, 5)
            lo, t = t, t + rnd.randint(1, 9)
            harness.append((rnd.choice("abc"), lo, t))
        idle, t = [], 0
        for _ in range(rnd.randint(0, 5)):
            t += rnd.randint(0, 6)
            lo, t = t, t + rnd.randint(1, 7)
            idle.append((lo, t))
        want = devtrace.label_gaps(idle, harness)
        # no port span, or port spans of other threads only: the benchmark's labels
        assert S.label_gaps(idle, harness) == want
        assert S.label_gaps(idle, harness, [Span("x", 0, 99, WORKER)], MAIN) == want
        # the pieces the refinement starts from sum to the benchmark's labels
        totals = {}
        for name, lo, hi in S._pieces(idle, harness):
            totals[name] = totals.get(name, 0.0) + (hi - lo) / 1e9
        assert totals == pytest.approx(dict(want))


def test_the_innermost_span_labels_an_idle_piece():
    harness = [("launching", 0, 100), ("waiting", 100, 120)]
    port = [Span("develop", 10, 90), Span("develop.color_matrix", 20, 40),
            Span("develop.demosaic", 50, 85), Span("stream.decode", 0, 120, WORKER)]
    idle = [(0, 60), (95, 110)]
    got = dict(S.label_gaps(idle, harness, port, MAIN))
    assert got == pytest.approx({"launching": 15e-9, "develop": 20e-9,
                                 "develop.color_matrix": 20e-9, "develop.demosaic": 10e-9,
                                 "waiting": 10e-9})
    assert sum(got.values()) == pytest.approx(sum(e - s for s, e in idle) / 1e9)


def test_timeline_of_nested_spans():
    assert S.timeline([("a", 0, 10), ("b", 2, 4), ("c", 4, 8), ("d", 5, 6), ("e", 12, 13)]) == [
        (0, 2, "a"), (2, 4, "b"), (4, 5, "c"), (5, 6, "d"), (6, 8, "c"), (8, 10, "a"),
        (12, 13, "e")]
    assert S.timeline([]) == []


SPANS = [
    Span("stream.decode", 0, 40 * MS, WORKER), Span("stream.decode", 10 * MS, 70 * MS, WORKER),
    Span("stream.save", 80 * MS, 100 * MS, WORKER),
    Span("stream.wait_decode", 0, 35 * MS), Span("stream.wait_decode", 40 * MS, 45 * MS),
    Span("stream.wait_save", 100 * MS, 101 * MS),
    Span("pipeline.detect", 0, 5 * MS, device_ms=14.0), Span("pipeline.detect", 5 * MS, 6 * MS,
                                                             device_ms=16.0),
    Span("develop.color_matrix", 0, MS // 2), Span("develop.color_matrix", MS, 2 * MS),
]


def test_each_reader_of_a_window():
    assert S.decode_ms_per_file(SPANS, 2) == pytest.approx(50.0)
    assert S.save_ms_per_file(SPANS, 2) == pytest.approx(10.0)
    assert S.stream_wait_decode_ms_per_file(SPANS, 2) == pytest.approx(20.0)
    assert S.stream_wait_save_ms_per_file(SPANS, 2) == pytest.approx(0.5)
    assert S.detect_device_ms_per_item(SPANS, 1) == pytest.approx(30.0)
    assert S.color_matrix_host_ms_per_item(SPANS, 2) == pytest.approx(0.75)


@pytest.mark.parametrize("reader", ["decode_ms_per_file", "save_ms_per_file",
                                    "stream_wait_decode_ms_per_file",
                                    "stream_wait_save_ms_per_file", "detect_device_ms_per_item",
                                    "color_matrix_host_ms_per_item"])
def test_a_reader_finds_nothing_without_its_span(reader):
    assert getattr(S, reader)([], 3) is None
    assert getattr(S, reader)(SPANS, 0) is None
    assert getattr(S, reader)([Span("other", 0, MS)], 3) is None


def test_idle_under_a_prefix_and_the_share_covered():
    port = [Span("develop", 0, 100), Span("develop.color_matrix", 10, 30),
            Span("develop.demosaic", 40, 60), Span("develop.tail", 0, 100, WORKER)]
    total, under = S.idle_under([(0, 50), (70, 80)], [(0, 100)], port, "develop.", MAIN)
    assert (total, under) == (60, 30)        # [10, 30) and [40, 50)
    assert S.covered([(0, 100), (200, 300)], port[1:3], MAIN) == pytest.approx(40 / 200)
    assert S.covered([], port, MAIN) == 0.0
