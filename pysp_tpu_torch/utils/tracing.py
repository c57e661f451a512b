"""Observability: the port's spans and counters, profiler traces, and the
per-develop statistics.

The recorder is off unless a caller turns it on with :func:`enable`; nothing
else (no environment variable, no config field) does. Off, :func:`span`
tests one module-level flag and hands back one shared no-op context
manager, and :func:`count` returns at once: no clock is read, no CUDA event
recorded and nothing allocated.

On, a span records its name, its start and end on ``time.time_ns`` (the
clock ``torch.profiler`` puts its device events on), the thread's id and
name, its own id and its parent's (from a per-thread stack), an ``item`` id
that every span of one file or one call shares across threads, the thread's
CPU time over the span (``time.thread_time_ns``; a span opened with
``cpu=False`` leaves it out) and, for a span opened with ``device=``, the
device milliseconds between two CUDA events recorded on the current stream
at entry and exit, resolved in :func:`drain` and never on the hot path.
Spans are appended to a list of their thread's, without a lock, at most
``MAX_SPANS`` a thread between two drains; the counter ``tracing.dropped``
counts what that cap drops. Counters live in one dict under a lock;
:func:`counters` reads them, with the kernels' launch counters of
``ops/cuda_kernels.py`` as ``kernels.<name>.launches``.

``trace`` records a ``torch.profiler`` trace (host and, with a GPU, device
activity) into a directory; inside it every span also opens a
``record_function`` range of its name, so ``trace.json`` shows the port's
spans. ``bayer_stats`` / ``rgb_stats`` are the scalar statistics of
``develop_with_stats``, computed on the tensors' device.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

# The most spans one thread keeps between two drains.
MAX_SPANS = 200_000

_recording = False   # enable() / disable()
_ranges = False      # inside trace(): spans open profiler ranges
_active = False      # either of them: the one flag span() tests

_span_ids = itertools.count(1)
_item_ids = itertools.count(1)
_local = threading.local()
_threads_lock = threading.Lock()
_threads: List["_ThreadSpans"] = []
_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


class Span(NamedTuple):
    """One recorded span. Times in ns on ``time.time_ns``; ``cpu_ns`` is the
    thread's CPU time over the span (None for a span opened with
    ``cpu=False``); ``device_ms`` the device time between its two events
    (None for a span without ``device=``)."""

    name: str
    start_ns: int
    end_ns: int
    thread_id: int
    thread_name: str
    span_id: int
    parent_id: Optional[int]
    item: object
    cpu_ns: Optional[int]
    device_ms: Optional[float]


class Recording(NamedTuple):
    """What :func:`drain` hands back: the spans since the last drain, in the
    order they started, and a snapshot of :func:`counters`."""

    spans: List[Span]
    counters: Dict[str, int]


class _ThreadSpans:
    """One thread's open spans and its finished ones."""

    __slots__ = ("thread", "name", "ident", "stack", "done")

    def __init__(self) -> None:
        t = threading.current_thread()
        self.thread, self.name, self.ident = t, t.name, threading.get_ident()
        self.stack: list = []
        self.done: list = []


def _thread_spans() -> _ThreadSpans:
    try:
        return _local.spans
    except AttributeError:
        ts = _local.spans = _ThreadSpans()
        with _threads_lock:
            _threads.append(ts)
        return ts


class _Off:
    """The no-op span that :func:`span` hands back while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _cuda_device(device) -> Optional[torch.device]:
    """The CUDA device a span's events go to: ``True`` for the current one, a
    CUDA device (or its name) for that one; None for ``False`` or a CPU
    device."""
    if device is True:
        return torch.device("cuda", torch.cuda.current_device())
    if device is False:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _Span:
    __slots__ = ("name", "item", "device", "cpu", "keep", "ts", "span_id", "parent_id",
                 "range", "ev0", "ev1", "cpu0", "start_ns", "end_ns", "cpu_ns")

    def __init__(self, name: str, item, device, cpu: bool) -> None:
        self.name, self.item, self.device, self.cpu = name, item, device, cpu

    def __enter__(self):
        ts = _thread_spans()
        parent = ts.stack[-1] if ts.stack else None
        self.ts, self.keep = ts, _recording
        self.parent_id = parent.span_id if parent is not None else None
        if self.item is None:
            self.item = parent.item if parent is not None else next(_item_ids)
        self.span_id = next(_span_ids)
        ts.stack.append(self)
        self.range = torch.profiler.record_function(self.name) if _ranges else None
        if self.range is not None:
            self.range.__enter__()
        dev = _cuda_device(self.device) if self.keep else None
        self.ev0 = self.ev1 = None
        if dev is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(dev))
            self.device = dev
        self.cpu0 = time.thread_time_ns() if self.cpu else None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self.cpu0 if self.cpu else None
        if self.ev1 is not None:
            self.ev1.record(torch.cuda.current_stream(self.device))
        if self.range is not None:
            self.range.__exit__(*exc)
        ts = self.ts
        ts.stack.remove(self)
        if self.keep:
            if len(ts.done) < MAX_SPANS:
                ts.done.append(self)
            else:
                count("tracing.dropped")
        return False


def span(name: str, item=None, device=False, cpu: bool = True):
    """A context manager that records the block as span ``name`` while the
    recorder is on (and opens a profiler range of that name inside
    :func:`trace`); the shared no-op object otherwise.

    ``item``: the id of the file or call the span belongs to; None takes the
    enclosing span's on this thread, or a new one for a root span
    (:func:`new_item` makes one to hand to other threads). ``device``:
    ``True`` or a CUDA device to time the block's device work between two
    CUDA events on that device's current stream; ``False`` or a CPU device
    not to. ``cpu=False``: no CPU time, for the spans on the path that
    launches device work: a thread's CPU clock is a system call, which a
    sandboxed host makes slow enough to hold up the launches (0.2-0.7 ms a
    Best develop on the H100 machine, three spans)."""
    if not _active:
        return _OFF
    return _Span(name, item, device, cpu)


def new_item() -> int:
    """A fresh item id, for the spans of one file or call on several threads."""
    return next(_item_ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if not _recording:
        return
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counters, and each kernel launch count of ``ops/cuda_kernels.py``
    (``launch_counts[<name>]``) as ``kernels.<name>.launches``: the stable
    way to read them."""
    from ..ops import cuda_kernels

    with _counters_lock:
        out = dict(_counters)
    for name, value in cuda_kernels.launch_counts.items():
        out[f"kernels.{name}.launches"] = value
    return out


def _set(recording: Optional[bool] = None, ranges: Optional[bool] = None) -> None:
    global _recording, _ranges, _active
    if recording is not None:
        _recording = recording
    if ranges is not None:
        _ranges = ranges
    _active = _recording or _ranges


def enable() -> None:
    """Turn recording on."""
    _set(recording=True)


def disable() -> None:
    """Turn recording off; what was recorded stays until :func:`drain`."""
    _set(recording=False)


def drain() -> Recording:
    """The spans recorded since the last drain (their device times resolved:
    each span's end event is waited for) and a snapshot of the counters; the
    spans are then cleared."""
    with _threads_lock:
        threads = list(_threads)
    spans = []
    for ts in threads:
        done = ts.done[:]
        del ts.done[:len(done)]       # what the thread appends meanwhile stays
        for s in done:
            ms = None
            if s.ev1 is not None:
                s.ev1.synchronize()
                ms = s.ev0.elapsed_time(s.ev1)
            spans.append(Span(s.name, s.start_ns, s.end_ns, ts.ident, ts.name, s.span_id,
                              s.parent_id, s.item, s.cpu_ns, ms))
    with _threads_lock:
        _threads[:] = [ts for ts in _threads if ts.thread.is_alive() or ts.done]
    spans.sort(key=lambda s: (s.start_ns, s.span_id))
    return Recording(spans, counters())


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` as a
    Chrome trace (``trace.json``; open it in Perfetto or chrome://tracing),
    with every span of the block as a range of its name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = _ranges
    with profile(activities=activities) as prof:
        _set(ranges=True)
        try:
            yield
        finally:
            _set(ranges=before)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _fraction(mask: Tensor) -> Tensor:
    """The share of true elements: the exact count over n, one float32
    division (``jnp.mean`` of the 0/1 array run op by op; jitted, XLA
    multiplies by the reciprocal of n instead, up to one ulp away)."""
    from ..colorimetry.transforms import div_const

    return div_const(torch.count_nonzero(mask).to(torch.float32), mask.numel())


def _quantile_linear(x: Tensor, q: float) -> Tensor:
    """``numpy.quantile(x, q)`` (linear interpolation between the two order
    statistics around ``q * (n - 1)``) in float32, with the position taken in
    float64. The two order statistics come from ``torch.topk``: no full sort,
    and no size limit (``torch.quantile`` refuses more than 2**24 elements)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pos = q * (n - 1)
    low = min(max(int(math.floor(pos)), 0), n - 1)
    high = min(low + 1, n - 1)
    # The n - low largest values hold the order statistics low, low + 1, ...
    top = torch.topk(flat, n - low, sorted=False).values
    pair = torch.topk(top, high - low + 1, largest=False, sorted=True).values
    frac = pos - low
    lo_w = torch.tensor(np.float32(1.0 - frac), device=flat.device)
    hi_w = torch.tensor(np.float32(frac), device=flat.device)
    return pair[0] * lo_w + pair[-1] * hi_w


def bayer_stats(bayer: Tensor, lim_sat: Tensor) -> Dict[str, Tensor]:
    """Sensor-domain statistics (0-d tensors on the mosaic's device)."""
    return {
        "mean": bayer.mean(),
        "clip_high_frac": _fraction(bayer >= lim_sat),
        "clip_low_frac": _fraction(bayer <= 0.0),
        "p99": _quantile_linear(bayer, 0.99),
    }


def rgb_stats(rgb: Tensor) -> Dict[str, Tensor]:
    """Output-domain statistics per channel; the std is the population one."""
    flat = rgb.reshape(-1, rgb.shape[-1])
    return {
        "mean_rgb": flat.mean(dim=0),
        "std_rgb": flat.std(dim=0, correction=0),
        "sat_frac": _fraction(flat >= 1.0),
        "neg_frac": _fraction(flat <= 0.0),
    }
