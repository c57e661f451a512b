"""The trace reader's interval arithmetic on synthetic spans."""
import pytest

from isp_bench import devtrace


def test_union_merges_overlaps_and_touching_intervals():
    assert devtrace.union([(5, 7), (0, 2), (1, 3), (3, 4), (10, 11)]) == [(0, 4), (5, 7), (10, 11)]
    assert devtrace.union([]) == []


def test_gaps_and_clip():
    busy = devtrace.union(devtrace.clip([(-5, 2), (4, 6), (8, 20)], 0, 10))
    assert busy == [(0, 2), (4, 6), (8, 10)]
    assert devtrace.gaps(busy, 0, 10) == [(2, 4), (6, 8)]
    assert devtrace.gaps([], 0, 10) == [(0, 10)]


def test_summary_of_two_streams_counts_overlap_once():
    ms = 1_000_000
    events = [("kernel", "ahd", 0, 4 * ms), ("kernel", "mat", 1 * ms, 2 * ms),
              ("gpu_memcpy", "copy", 3 * ms, 6 * ms), ("kernel", "late", 20 * ms, 30 * ms)]
    spans = [("launching", 0, 7 * ms), ("waiting", 7 * ms, 10 * ms)]
    t = devtrace.summarise(events, 0, 10 * ms, spans)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.006)           # [0, 6) ms: the overlaps once
    assert t.kernel_s == pytest.approx(0.005)         # kernel durations summed
    assert t.launches == 2                            # the one after the window left out
    assert t.by_kernel[0] == ("ahd", pytest.approx(0.004))
    # the gap [6, 10) ms: 1 ms of it while launching, 3 ms while waiting
    assert t.idle_by_host == [("waiting", pytest.approx(0.003)), ("launching", pytest.approx(0.001))]
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"} and len(b["device_ops"]) == 2


def test_a_gap_is_split_among_the_spans_it_crosses():
    spans = [("call", 0, 10), ("keep", 10, 12), ("call", 12, 20)]
    got = dict(devtrace.label_gaps([(8, 15), (21, 25)], spans))
    assert got == {"call": pytest.approx(5e-9), "keep": pytest.approx(2e-9),
                   "host outside the harness's spans": pytest.approx(4e-9)}


def test_an_empty_session_fails():
    with pytest.raises(RuntimeError):
        devtrace.summarise([], 0, 10, [])
    with pytest.raises(RuntimeError):
        devtrace.summarise([("gpu_memcpy", "c", 0, 5)], 0, 10, [])
