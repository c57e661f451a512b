#!/usr/bin/env python3
"""Runs cells of the benchmark (``isp_bench/``) with the port's span recorder
(``pysp_tpu_torch.utils.tracing``) on, beside the benchmark's own device
trace, and reports what the spans read. It changes nothing of the benchmark
and is not one of its runs.

    python3 tools/span_report.py --cells cam24.best hdr5.bracket cam24.files mf102.lens
        [--seed N] [--seconds 20] [--cost-seconds 5] [--cost-pairs 3]
        [--out chiprun_out/span_report]

For each cell, after the cell's own set-up and warm-up (``driver.prepare``):

- two traced windows of ``--seconds``, each under one ``devtrace.Session``
  as a ``--trace 1`` run opens it, the first with the recorder on
  (``enable()`` after the session starts, ``drain()`` after it stops), the
  second with it off; the benchmark's per-layer metrics of both, so that the
  recorder's effect on them shows;
- from the first: the span metrics of ``isp_bench/spans.py`` (decode, save
  and the driver's waits a file; the detector's device ms and the colour
  matrix's host ms an item), the host ms, CPU ms and count of every span name
  by thread, the counters' change over the window, the idle gaps labelled by
  the innermost span (the harness's spans outermost, the port's spans of the
  driver thread inside) beside the benchmark's own labels, and the
  cross-checks: the device ms of the pipeline's stages against the device
  trace's kernel time an item (hdr5), the share of ``develop_files``' host
  time the driver's spans cover and of its idle card time under ``stream.*``
  spans (files), the share of the idle time while ``develop`` launches under
  ``develop.*`` spans (cam24); for mf102.lens the chain's spans an item on
  the device and the host, the CA's coordinate maps against its remaps and
  the warp's maps against its remap, the remap kernel's device ms from the
  trace and the counters an item (its driver turns the recorder on in every
  traced window and drains it itself, so both traced windows record; the
  cost windows show the recorder's effect);
- for the resident cells, the recorder's cost: ``--cost-pairs`` pairs of
  untraced windows of ``--cost-seconds``, recorder off and on in turn (off,
  on, on, off, ...), and the items each completed.

Then the host cost of one span, off and on, on this machine. Each cell's
result is ``<out>/<cell>.json``; a summary goes to standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".isp_bench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
os.environ.setdefault("PYSP_TPU_MATRIX_CACHE", os.path.join(CACHE, "harvested_matrices.json"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

METRICS = {  # reader of isp_bench/spans.py -> what it divides by
    "decode_ms_per_file": "files",
    "save_ms_per_file": "files",
    "stream_wait_decode_ms_per_file": "files",
    "stream_wait_save_ms_per_file": "files",
    "detect_device_ms_per_item": "items",
    "color_matrix_host_ms_per_item": "items",
}


# the lens-corrected chain's spans (mf102.lens), outermost first
LENS_SPANS = ("pipeline.develop_lens_corrected", "ca.remove", "ca.maps", "ca.resample",
              "ca.remap", "pipeline.detect", "develop", "warp.opcode3", "warp.maps",
              "warp.remap")


def _reset(run) -> None:
    run.items, run.files, run.window_s, run.busy_window_s, run.trace = [], 0, 0.0, 0.0, None
    run.spans = []


def _device_events(session) -> list:
    """(activity, name, start, end) of the session's kernels, copies and
    memsets, read as ``devtrace.Session.stop`` reads them; none without a
    profiler (a CPU trial)."""
    import torch

    from isp_bench import devtrace

    if session._prof is None:
        return []
    torch.cuda.synchronize()
    session._prof.__exit__(None, None, None)
    out = []
    for ev in session._prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or devtrace._annotation(ev):
            continue
        act = devtrace._activity(ev)
        if act == devtrace.KERNEL or act in devtrace.COPIES:
            out.append((act, ev.name(), ev.start_ns(), ev.end_ns()))
    return out


def _stop(session):
    """``devtrace.Session.stop``'s ``Trace`` and the window's idle intervals,
    with the harness's gap labels taken by ``isp_bench.spans.label_gaps``:
    the same numbers as ``devtrace.label_gaps``, which takes some minutes
    for a window of cam24.best (it pairs every gap with every span)."""
    from isp_bench import devtrace, spans as S

    events = _device_events(session)
    lo, hi = session.lo, session.hi
    busy = devtrace.union(devtrace.clip([(s, e) for a, _, s, e in events], lo, hi))
    idle = devtrace.gaps(busy, lo, hi)
    if events:
        trace = devtrace.summarise(events, lo, hi, [])
    else:
        trace = devtrace.Trace((hi - lo) / 1e9, 0.0, 0.0, 0, [], [])
    trace.idle_by_host = S.label_gaps(idle, session.spans)
    return trace, idle


def traced_window(ctx, driver, state, seconds: float, record: bool) -> dict:
    from isp_bench import devtrace, harness
    from pysp_tpu_torch.utils import tracing

    run = ctx.run
    _reset(run)
    before = tracing.counters()
    session = devtrace.Session(ctx.device)
    if ctx.device == "cuda":
        session.start()
    if record:
        tracing.enable()
    driver.window(state, ctx, seconds, session)
    tracing.disable()
    run.trace, idle = _stop(session)
    rec = tracing.drain()
    if run.spans:       # a driver that drains the recorder itself (mf102.lens)
        rec = tracing.Recording(sorted(run.spans + rec.spans,
                                       key=lambda s: (s.start_ns, s.span_id)), rec.counters)
    metrics = {}
    for m in ctx.metrics(True) + ctx.metrics(False):
        try:
            value = harness.read_metric(m["name"], run, ctx.here)
        except ZeroDivisionError:     # a CPU trial's trace holds no kernel time
            value = None
        if value is not None:
            metrics[m["name"]] = value
    return {"trace": run.trace, "session": session, "rec": rec, "idle": idle, "metrics": metrics,
            "counters": {k: v - before.get(k, 0) for k, v in rec.counters.items()
                         if v != before.get(k, 0)},
            "items": len(run.items), "files": run.files, "window_s": run.trace.window_s}


def by_span(spans) -> dict:
    """{thread kind: {span name: [count, host ms, CPU ms, device ms]}}, the
    kind being the thread's name less its number; None for what no span of
    the name records."""
    out = {}
    for s in spans:
        kind = s.thread_name.rstrip("0123456789").rstrip("_")
        row = out.setdefault(kind, {}).setdefault(s.name, [0, 0.0, None, None])
        row[0] += 1
        row[1] += (s.end_ns - s.start_ns) / 1e6
        if s.cpu_ns is not None:
            row[2] = (row[2] or 0.0) + s.cpu_ns / 1e6
        if s.device_ms is not None:
            row[3] = (row[3] or 0.0) + s.device_ms
    return out


def analyse(cell: str, on: dict, off: dict) -> dict:
    from isp_bench import spans as S

    main = threading.get_ident()
    rec, session, idle = on["rec"], on["session"], on["idle"]
    n_items, n_files = on["items"], on["files"]
    out = {"cell": cell, "window_s": on["window_s"], "items": n_items, "files": n_files,
           "spans": len(rec.spans), "counters": on["counters"],
           "metrics_recorder_on": on["metrics"], "metrics_recorder_off": off["metrics"]}
    out["span_metrics"] = {
        name: getattr(S, name)(rec.spans, n_files if per == "files" else n_items)
        for name, per in METRICS.items()}
    out["by_span"] = by_span(rec.spans)
    out["idle_gaps"] = [[n, s] for n, s in S.label_gaps(idle, session.spans, rec.spans, main)]
    out["idle_gaps_benchmark"] = [[n, s] for n, s in on["trace"].idle_by_host]
    checks = {}
    harness_spans = {}
    for name, lo, hi in session.spans:
        harness_spans.setdefault(name, []).append((lo, hi))
    if n_files:
        calls = harness_spans.get("host: develop_files (decode, upload, save)", [])
        checks["driver_spans_cover_develop_files"] = S.covered(calls, rec.spans, main)
        total, under = S.idle_under(idle, calls, rec.spans, "stream.", main)
        checks["develop_files_idle_s"] = total / 1e9
        checks["develop_files_idle_under_stream_spans"] = under / total if total else None
    else:
        launching = [iv for name, ivs in harness_spans.items() if name.endswith("launching")
                     for iv in ivs]
        total, under = S.idle_under(idle, launching, rec.spans, "develop.", main)
        checks["launching_idle_s"] = total / 1e9
        checks["launching_idle_under_develop_spans"] = under / total if total else None
        stages = ("pipeline.detect", "pipeline.consensus", "pipeline.correct", "pipeline.fuse",
                  "develop")
        dev = {n: S.device_ms(S.named(rec.spans, n)) / n_items for n in stages}
        checks["device_ms_per_item_by_stage"] = dev
        checks["stages_device_ms_per_item"] = sum(
            v for k, v in dev.items() if k != "pipeline.consensus")
        checks["kernel_ms_per_item"] = on["trace"].kernel_s * 1e3 / n_items
        checks["ahd_kernel_ms_per_item"] = sum(
            s for n, s in on["trace"].by_kernel if "ahd_kernel" in n) * 1e3 / n_items
        checks["top_kernels_ms_per_item"] = [
            [n, s * 1e3 / n_items] for n, s in on["trace"].by_kernel[:5]]
        if S.named(rec.spans, "ca.remove"):
            checks.update(lens_checks(on, n_items))
    out["checks"] = checks
    return out


def lens_checks(on: dict, n_items: int) -> dict:
    """mf102.lens: the chain's spans an item, device and host ms; the CA's
    maps against its remaps and the warp's maps against its remap on the
    device; the remap kernel's device ms from the trace; the counters an
    item."""
    from isp_bench import roofline_remap, spans as S

    spans = on["rec"].spans
    dev = {n: S.device_ms(S.named(spans, n)) / n_items for n in LENS_SPANS[1:]}
    return {
        "lens_device_ms_per_item_by_span": dev,
        "lens_host_ms_per_item_by_span": {n: S.host_ms(S.named(spans, n)) / n_items
                                          for n in LENS_SPANS},
        "ca_maps_against_remaps_device_ms": [dev["ca.maps"], dev["ca.remap"]],
        "warp_maps_against_remap_device_ms": [dev["warp.maps"], dev["warp.remap"]],
        "remap_kernel_ms_per_item": sum(
            s for n, s in on["trace"].by_kernel if roofline_remap.is_remap_kernel(n))
        * 1e3 / n_items,
        "counters_per_item": {k: v / n_items for k, v in on["counters"].items()},
    }


def cost(ctx, driver, state, seconds: float, pairs: int) -> list:
    """Items completed in untraced windows, recorder off and on in turn."""
    from pysp_tpu_torch.utils import tracing

    rows = []
    for k in range(2 * pairs):
        record = k % 4 in (1, 2)            # off, on, on, off, ...
        _reset(ctx.run)
        if record:
            tracing.enable()
        driver.window(state, ctx, seconds, None)
        tracing.disable()
        n_spans = len(tracing.drain().spans)
        rows.append({"recorder": "on" if record else "off", "items": len(ctx.run.items),
                     "window_s": ctx.run.window_s,
                     "items_per_s": len(ctx.run.items) / ctx.run.window_s, "spans": n_spans})
    return rows


def span_cost(n: int = 200_000) -> dict:
    """Host ns of one ``with span(...)`` block, off and on, on this machine."""
    from pysp_tpu_torch.utils import tracing
    from pysp_tpu_torch.utils.tracing import span

    out = {}
    for state in ("off", "on"):
        if state == "on":
            tracing.enable()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("x"):
                pass
        out[f"{state}_ns"] = (time.perf_counter_ns() - t0) / n
        tracing.disable()
        tracing.drain()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 1817)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cost-seconds", type=float, default=5.0)
    ap.add_argument("--cost-pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", default=None, help="JSON of configuration keys to override "
                    "(small sizes for a CPU trial)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "span_report"))
    args = ap.parse_args()

    import torch

    from isp_bench import harness

    os.makedirs(args.out, exist_ok=True)
    scale = json.loads(args.scale) if args.scale else None
    for k, cell in enumerate(args.cells):
        ctx = harness.Context(cell, args.seed + k, device=args.device, scale=scale)
        driver = ctx.driver()
        state = driver.prepare(ctx, None)
        if args.device == "cuda":
            torch.cuda.synchronize()
        on = traced_window(ctx, driver, state, args.seconds, True)
        off = traced_window(ctx, driver, state, args.seconds, False)
        result = analyse(cell, on, off)
        if not ctx.run.files and args.cost_pairs:
            result["cost"] = cost(ctx, driver, state, args.cost_seconds, args.cost_pairs)
        driver.release(state)
        if args.device == "cuda":
            torch.cuda.empty_cache()
        with open(os.path.join(args.out, f"{cell}.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps({k: result[k] for k in ("cell", "window_s", "items", "files",
                                                  "spans", "span_metrics", "checks",
                                                  "counters")}), flush=True)
        print("idle gaps:", json.dumps(result["idle_gaps"][:12]), flush=True)
        print("benchmark's idle gaps:", json.dumps(result["idle_gaps_benchmark"][:6]), flush=True)
        print("per-layer, recorder on / off:", json.dumps(
            {m: [result["metrics_recorder_on"].get(m), v]
             for m, v in result["metrics_recorder_off"].items()}), flush=True)
        if "cost" in result:
            print("cost:", json.dumps(result["cost"]), flush=True)
    print("span cost:", json.dumps(span_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
