"""Reading the port's own spans and counters (``pysp_tpu_torch.utils.tracing``:
``enable()`` before a window, ``drain()`` after it) beside the device trace.

A span here is what ``drain()`` hands back: ``name``, ``start_ns`` and
``end_ns`` on ``time.time_ns`` (the profiler's clock, and that of the
harness's own spans), ``thread_id``, ``span_id``, ``parent_id``, ``item``,
``cpu_ns`` and ``device_ms`` (None for a span timed on the host only).

- the per-layer numbers: the sum of one span's host or device time over the
  files or items of the window (``decode_ms_per_file``, ...), each ``None``
  where the window holds no such span;
- ``label_gaps``: the device trace's idle gaps by the innermost span over
  them, with the harness's spans outermost and the port's spans of the
  thread that launches the device work inside them; with no port span the
  same numbers as ``devtrace.label_gaps``, in time linear in the gaps and
  spans where that one takes their product (some minutes for a traced
  window of cam24.best);
- ``idle_under`` / ``covered``: the idle time, or the host time, that spans
  of a name prefix cover, for the cross-checks of ``tools/span_report.py``.
"""
from __future__ import annotations

import bisect

from isp_bench import devtrace

OUTSIDE = "host outside the harness's spans"


def named(spans, name: str, thread_id=None) -> list:
    """The spans called ``name`` (on ``thread_id`` only, when given)."""
    return [s for s in spans if s.name == name and (thread_id is None or s.thread_id == thread_id)]


def host_ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def device_ms(spans) -> float:
    return sum(s.device_ms for s in spans if s.device_ms is not None)


def _per(total_ms, spans, n):
    return total_ms / n if spans and n else None


def decode_ms_per_file(spans, files: int):
    """Host ms of the decode workers' ``stream.decode`` spans per file written."""
    s = named(spans, "stream.decode")
    return _per(host_ms(s), s, files)


def save_ms_per_file(spans, files: int):
    """Host ms of the save workers' ``stream.save`` spans per file written."""
    s = named(spans, "stream.save")
    return _per(host_ms(s), s, files)


def stream_wait_decode_ms_per_file(spans, files: int):
    """Host ms the driver spent blocked on a decode (``stream.wait_decode``)
    per file written."""
    s = named(spans, "stream.wait_decode")
    return _per(host_ms(s), s, files)


def stream_wait_save_ms_per_file(spans, files: int):
    """Host ms the driver spent blocked on a save (``stream.wait_save``) per
    file written."""
    s = named(spans, "stream.wait_save")
    return _per(host_ms(s), s, files)


def detect_device_ms_per_item(spans, items: int):
    """Device ms of the hot-pixel detector (``pipeline.detect``) per item."""
    s = [x for x in named(spans, "pipeline.detect") if x.device_ms is not None]
    return _per(device_ms(s), s, items)


def color_matrix_host_ms_per_item(spans, items: int):
    """Host ms of the colour matrix before the AHD kernel
    (``develop.color_matrix``) per item."""
    s = named(spans, "develop.color_matrix")
    return _per(host_ms(s), s, items)


def timeline(spans) -> list:
    """(start, end, name) pieces, in order and apart, of the innermost of the
    nested ``spans`` (name, start, end) over each instant they cover."""
    out, stack, t = [], [], None

    def emit(upto):
        nonlocal t
        if stack and upto > t:
            out.append((t, upto, stack[-1][0]))
        t = upto if t is None else max(t, upto)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((name, e))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return out


def _pieces(idle, spans):
    """``devtrace.label_gaps``' split of each gap among the harness's spans,
    as (name, start, end) pieces in its order. The gaps are sorted and
    apart, so the spans that end before a gap starts are passed over once."""
    spans = sorted(spans, key=lambda s: s[1])
    first = 0
    for s, e in idle:
        while first < len(spans) and spans[first][2] <= s:
            first += 1
        t = s
        for j in range(first, len(spans)):
            name, lo, hi = spans[j]
            if lo >= e:
                break
            lo, hi = max(lo, t), min(hi, e)
            if hi <= lo:
                continue
            if lo > t:
                yield OUTSIDE, t, lo
            yield name, lo, hi
            t = hi
        if e > t:
            yield OUTSIDE, t, e


def label_gaps(idle, harness_spans, port_spans=(), thread_id=None):
    """Idle seconds summed by the innermost span over each part of a gap: the
    harness's spans (name, start, end) outermost, and inside them the port's
    spans of ``thread_id`` (the thread that launches the device work); the
    port's spans of other threads label nothing. Without port spans on that
    thread, what ``devtrace.label_gaps(idle, harness_spans)`` gives."""
    inner = [(s.name, s.start_ns, s.end_ns) for s in port_spans
             if thread_id is None or s.thread_id == thread_id]
    line = timeline(inner)
    starts = [p[0] for p in line]
    totals = {}

    def add(name, lo, hi):
        totals[name] = totals.get(name, 0.0) + (hi - lo) / 1e9

    for name, lo, hi in _pieces(idle, harness_spans):
        t = lo
        for j in range(max(bisect.bisect_right(starts, lo) - 1, 0), len(line)):
            a, b, inner_name = line[j]
            if a >= hi:
                break
            a, b = max(a, t), min(b, hi)
            if b <= a:
                continue
            if a > t:
                add(name, t, a)
            add(inner_name, a, b)
            t = b
        if hi > t:
            add(name, t, hi)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def _measure(intervals) -> int:
    return sum(e - s for s, e in devtrace.union(intervals))


def _intersect(a, b):
    """The intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_under(idle, within, spans, prefix: str, thread_id=None):
    """(idle ns inside the ``within`` intervals, of it the ns that some span
    whose name starts with ``prefix`` covers), spans of ``thread_id`` only
    when given."""
    base = _intersect(devtrace.union(idle), devtrace.union(within))
    cover = devtrace.union([(s.start_ns, s.end_ns) for s in spans if s.name.startswith(prefix)
                            and (thread_id is None or s.thread_id == thread_id)])
    return _measure(base), _measure(_intersect(base, cover))


def covered(within, spans, thread_id=None) -> float:
    """The share of the ``within`` intervals' time that the spans (of
    ``thread_id`` when given) cover."""
    base = devtrace.union(within)
    cover = devtrace.union([(s.start_ns, s.end_ns) for s in spans
                            if thread_id is None or s.thread_id == thread_id])
    total = _measure(base)
    return _measure(_intersect(base, cover)) / total if total else 0.0
