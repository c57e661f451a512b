"""The device trace of a ``--trace 1`` run: one ``torch.profiler`` session
over the whole window, opened after warm-up (the first call in a session
costs 3-4 ms more host time), with device activity only, read straight from
the profiler's raw events.

- busy: the union of the kernel, copy and memset intervals; user
  annotations on the device are left out (a range spans its kernels and the
  gaps between them);
- device time and launches: the sum of the kernel durations and the number
  of kernel events;
- the breakdown: the kernels that took the most device time, and the idle
  gaps of the window summed by what the host was doing (the harness's own
  spans, on the profiler's clock: ``time.time_ns``).

A session that holds no device event fails the run: it never reads as 0.
"""
from __future__ import annotations

import dataclasses
import re
import time

KERNEL = "kernel"
COPIES = ("gpu_memcpy", "gpu_memset")
TOP = 10


def union(intervals):
    """Merged, sorted (start, end) intervals of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy, lo: int, hi: int):
    """The idle (start, end) intervals of [lo, hi) outside the merged ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_gaps(idle, spans):
    """Idle seconds summed by the host span (name, start, end) that each part
    of a gap falls in, so that a gap across several spans is split among
    them; ``host outside the harness's spans`` for the parts outside every
    span."""
    outside = "host outside the harness's spans"
    spans = sorted(spans, key=lambda s: s[1])
    totals = {}
    for s, e in idle:
        t = s
        for name, lo, hi in spans:
            lo, hi = max(lo, t), min(hi, e)
            if hi <= lo:
                continue
            if lo > t:
                totals[outside] = totals.get(outside, 0.0) + (lo - t) / 1e9
            totals[name] = totals.get(name, 0.0) + (hi - lo) / 1e9
            t = hi
        if e > t:
            totals[outside] = totals.get(outside, 0.0) + (e - t) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float
    launches: int
    by_kernel: list      # [(name, seconds)], most first
    idle_by_host: list   # [(host span, seconds)], most first

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.by_kernel[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.idle_by_host[:TOP]]}


def short_name(name: str, most: int = 200) -> str:
    """A kernel's name without its parameter list; a PyTorch elementwise or
    reduction kernel as its outer template and the functors that tell it
    apart (``at::native::elementwise_kernel[BinaryFunctor, maximum_kernel_cuda]``);
    at most ``most`` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i in range(len(name) - 1, 0, -1):        # the last top-level "(...)"
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            name = name[:i]
            break
    if "at::native::" in name and "<" in name:
        head, tail = name[:name.index("<")], name[name.index("<"):]
        parts = dict.fromkeys(w for w in re.findall(r"\w+", tail)
                              if re.search(r"Functor|functor|kernel_cuda|kernel_impl|clamp", w)
                              and not w.startswith("gpu_kernel_impl"))
        name = f"{head}[{', '.join(parts)}]" if parts else head
    return name[:most]


def summarise(events, lo: int, hi: int, spans) -> Trace:
    """``events``: (activity, name, start_ns, end_ns) of the device; [lo, hi)
    the window on the same clock."""
    kernels = [(s, e, n) for a, n, s, e in events if a == KERNEL and e > lo and s < hi]
    busy_iv = union(clip([(s, e) for a, _, s, e in events if a == KERNEL or a in COPIES],
                         lo, hi))
    if not kernels or not busy_iv:
        raise RuntimeError("the profiler session holds no device event for the window")
    by_kernel = {}
    for s, e, n in kernels:
        n = short_name(n)
        by_kernel[n] = by_kernel.get(n, 0.0) + (e - s) / 1e9
    return Trace(
        window_s=(hi - lo) / 1e9,
        busy_s=sum(e - s for s, e in busy_iv) / 1e9,
        kernel_s=sum(e - s for s, e, _ in kernels) / 1e9,
        launches=len(kernels),
        by_kernel=sorted(by_kernel.items(), key=lambda kv: -kv[1]),
        idle_by_host=label_gaps(gaps(busy_iv, lo, hi), spans),
    )


def _annotation(ev) -> bool:
    return bool(ev.is_user_annotation()) if hasattr(ev, "is_user_annotation") else False


def _activity(ev) -> str:
    """The event's kineto activity (``kernel``, ``gpu_memcpy``, ...); from its
    name where this PyTorch does not give it."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    name = ev.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else KERNEL)


class Session:
    """One profiler session around the window. The drivers mark the window's
    ends and their host spans with :meth:`span`."""

    def __init__(self, device: str):
        self.device = device
        self.spans = []          # (name, start_ns, end_ns) on time.time_ns
        self.lo = self.hi = None
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.device == "cuda" else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def mark(self, which: str) -> None:
        """The window's first (``lo``) or last (``hi``) instant."""
        setattr(self, which, time.time_ns())

    def span(self, name: str, start_ns: int, end_ns: int) -> None:
        self.spans.append((name, start_ns, end_ns))

    def stop(self) -> Trace:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        raw = self._prof.profiler.kineto_results.events()
        events, kinds = [], {}
        for ev in raw:
            if ev.device_type() != torch.autograd.DeviceType.CUDA or _annotation(ev):
                continue
            act = _activity(ev)
            kinds[act] = kinds.get(act, 0) + 1
            if act == KERNEL or act in COPIES:
                events.append((act, ev.name(), ev.start_ns(), ev.end_ns()))
        try:
            return summarise(events, self.lo, self.hi, self.spans)
        except RuntimeError as e:
            raise RuntimeError(f"{e} (device events by activity: {kinds}, "
                               f"{len(raw)} events in all)") from None
