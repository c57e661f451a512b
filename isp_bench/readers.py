"""What the metric readers under ``metrics/`` share. A cell's end-to-end and
per-layer metrics carry names of their own (``mp_per_s`` in cam24.best,
``hdr_mp_per_s`` in hdr5.bracket, ...), so that each cell's bound follows its
own spread; their files hand these functions on as ``read``. Each returns
``None`` where the run holds nothing to read."""
from __future__ import annotations

import numpy as np


def _resident(run) -> bool:
    return bool(run.items) and not run.files


def mp_per_s(run):
    """Raw megapixels taken in per second: every item completed in the
    window, times its input megapixels (a burst counts all its frames), over
    the whole window, host clock."""
    if not _resident(run) or run.window_s <= 0:
        return None
    return sum(it.mp for it in run.items) / run.window_s


def latency_p95_ms(run):
    """95th percentile, over every item of the window, of the host clock from
    an item's submission to its result being complete on the card
    (synchronised)."""
    if not _resident(run):
        return None
    lat = np.array([it.done_ns - it.submit_ns for it in run.items], np.float64) / 1e6
    return float(np.percentile(lat, 95))


def device_ms_per_item(run):
    """Device kernel time per item: the sum of the kernel durations in the
    traced window over the items completed in it."""
    if run.trace is None or not _resident(run):
        return None
    return run.trace.kernel_s * 1e3 / len(run.items)


def launches_per_item(run):
    """Device kernels per item: kernel events in the traced window over the
    items completed in it."""
    if run.trace is None or not _resident(run):
        return None
    return run.trace.launches / len(run.items)


def device_idle_pct(run):
    """Idle share of the card: 100 x (1 - the union of kernel and copy
    intervals / the traced window)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
