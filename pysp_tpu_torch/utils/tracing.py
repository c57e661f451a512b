"""Observability: profiler traces, named stages, per-develop statistics.

Counterpart of ``pysp_tpu/utils/tracing.py``: ``trace`` records a
``torch.profiler`` trace (host and, with a GPU, device activity) into a
directory, ``stage`` names a range in it, ``bayer_stats`` / ``rgb_stats`` are
the scalar statistics of ``develop_with_stats``, computed on the tensors'
device, and ``StageTimer`` times host-orchestrated phases on the host clock.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from ..colorimetry.transforms import div_const

Tensor = torch.Tensor


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` as a
    Chrome trace (``trace.json``; open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


stage = torch.profiler.record_function  # `with stage("ahd/green_interp"): ...`


def _fraction(mask: Tensor) -> Tensor:
    """The share of true elements: the exact count over n, one float32
    division (``jnp.mean`` of the 0/1 array run op by op; jitted, XLA
    multiplies by the reciprocal of n instead, up to one ulp away)."""
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


class StageTimer:
    """Host-side wall-clock per stage for multi-dispatch pipelines (fit loops etc.).

    Device work is asynchronous: a stage that launches it and does not wait
    for it is timed as its launches; use ``trace`` for the device's own time.
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v*1e3:.1f} ms" for k, v in sorted(self.times.items())]
        lines.append(f"total: {total*1e3:.1f} ms")
        return "\n".join(lines)
