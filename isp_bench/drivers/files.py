"""A folder of raw files developed to PNGs, call after call of the
program's ``develop_files`` until the window is spent; the call in progress
is completed and counted.

Traffic parameters (``traffic/<mix>.json``): ``files`` (how many DNGs the
seed writes into the run's ``TMPDIR``), ``compressions`` (the DNG
compression of each file in turn: 1 uncompressed, 7 lossless JPEG),
``decode_workers`` and ``save_workers`` (``develop_files``' defaults when
absent). Each call writes into a directory of its own. Between calls, outside
the timed call, the harness keeps the bytes of one PNG of each input, from a
call drawn from the seed (a reservoir over the calls), and deletes every PNG
the call wrote, so that a run writes its eight inputs and little else to the
disk; after the window the kept PNGs are read by the harness's own reader and
checked against the plain reference.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import tempfile
import time
import zlib

import numpy as np
import torch

from isp_bench import gen, png
from isp_bench.drivers import resident
from isp_bench.harness import Comparison, Item
from isp_bench.reference import develop as ref


@dataclasses.dataclass
class State:
    entry: object                # (paths, out_dir) -> written paths
    root: str
    paths: list
    counts: list                 # the generator's counts of each file (int16)
    mp: float
    calls: int = 0
    kept: list = dataclasses.field(default_factory=list)    # PNG bytes of each input, or None


def _entry(ctx):
    from pysp_tpu_torch import DevelopConfig, QualityDemosaic, develop_files

    dev = ctx.config["develop"]
    cfg = DevelopConfig(quality=QualityDemosaic[ctx.traffic["quality"].capitalize()],
                        postprocess_stages=dev["postprocess_stages"],
                        clip_highlights=dev["clip_highlights"], gamma_encode=dev["gamma_encode"])
    kw = {k: ctx.traffic[k] for k in ("decode_workers", "save_workers") if k in ctx.traffic}
    if ctx.device != "cuda":
        kw["device"] = ctx.device
    return lambda paths, out_dir: develop_files(paths, out_dir, cfg, **kw)


def prepare(ctx, program=None) -> State:
    conf = ctx.config
    camera = conf["camera"]
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="isp_bench_files_")
    comps = ctx.traffic["compressions"]
    paths, counts = [], []
    for i in range(int(ctx.traffic["files"])):
        c = resident.make_counts(ctx, i)
        path = os.path.join(root, f"in_{i:02d}.dng")
        with open(path, "wb") as f:
            f.write(gen.dng_bytes(c, camera, comps[i % len(comps)]))
        paths.append(path)
        counts.append(c)
    state = State(entry=program or _entry(ctx), root=root, paths=paths, counts=counts,
                  mp=conf["height"] * conf["width"] / 1e6)
    t1 = time.perf_counter()
    ctx.setup_phases["inputs"] = t1 - t0
    # warm-up: one file of each compression and at least two, decoded,
    # developed and saved, so that the stream's overlap is warmed too
    warm = paths[: min(max(2, len(comps)), len(paths))]
    state.entry(warm, os.path.join(root, "warm"))
    shutil.rmtree(os.path.join(root, "warm"), ignore_errors=True)
    ctx.setup_phases["warm-up"] = time.perf_counter() - t1
    return state


def window(state: State, ctx, seconds: float, session=None) -> None:
    run = ctx.run
    if session:
        session.mark("lo")
    rng = np.random.default_rng(gen.sub_seed(ctx.seed, 6))
    state.kept = [None] * len(state.paths)
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        out_dir = os.path.join(state.root, f"out_{state.calls:03d}")
        w0 = time.time_ns()
        s = time.perf_counter_ns()
        written = state.entry(state.paths, out_dir)
        d = time.perf_counter_ns()
        w1 = time.time_ns()
        if session:
            session.span("host: develop_files (decode, upload, save)", w0, w1)
        state.calls += 1
        run.items.append(Item(s, d, state.mp * len(written), "develop_files"))
        run.files += sum(os.path.exists(p) for p in written)
        _keep_sample(state, out_dir, rng)
        if session:
            session.span("host: the harness keeps a sample, deletes the PNGs", w1, time.time_ns())
        if d / 1e9 >= end:
            break
    if session:
        session.mark("hi")
    run.window_s = time.perf_counter() - t0
    run.busy_window_s = sum(it.done_ns - it.submit_ns for it in run.items) / 1e9


def _keep_sample(state: State, out_dir: str, rng) -> None:
    """After call number ``state.calls``: each input's PNG of this call
    replaces the kept one with probability 1 / calls, so that the kept PNG is
    drawn evenly from the calls; a PNG missing from the call is kept as
    ``None``. Then the call's directory is deleted."""
    for i, src in enumerate(state.paths):
        if rng.integers(state.calls) == 0:
            dst = os.path.join(out_dir, _png_name(src))
            try:
                with open(dst, "rb") as f:
                    state.kept[i] = f.read()
            except OSError:
                state.kept[i] = None
    shutil.rmtree(out_dir, ignore_errors=True)


def _png_name(src: str) -> str:
    return os.path.splitext(os.path.basename(src))[0] + ".png"


def release(state: State) -> None:
    state.entry = None


def attempts(state: State, ctx):
    """(files attempted, files not written) of the window."""
    attempted = state.calls * len(state.paths)
    return attempted, attempted - ctx.run.files


def check(state: State, ctx) -> list:
    """The kept PNG of each input, from a call drawn from the seed, read by
    the harness's own reader and held against the reference's 8-bit image: the
    share of pixels off by more than one level in some channel, the RMS error
    and the largest error in levels. A file that was missing or is unreadable
    fails every number."""
    limits = ctx.limits
    conf = ctx.config
    worst = {name: Comparison(name, 0.0, limit) for name, limit in limits.items()}
    try:
        for i in range(len(state.paths)):
            try:
                if state.kept[i] is None:
                    raise ValueError("no PNG")
                got = torch.from_numpy(png.read_png(state.kept[i]))
            except (ValueError, struct.error, zlib.error):
                values = dict.fromkeys(limits, float("inf"))
            else:
                camera, dev = conf["camera"], conf["develop"]
                frame = ref.frame(state.counts[i].to(ctx.device), camera, None)
                want = ref.to_uint8(ref.develop(frame, ctx.traffic["quality"],
                                                dev["postprocess_stages"],
                                                dev["clip_highlights"], dev["gamma_encode"])).cpu()
                if got.shape != want.shape:
                    values = dict.fromkeys(limits, float("inf"))
                else:
                    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                    values = {"off_share": float((d > 1).any(dim=-1).to(torch.float32).mean()),
                              "rms": float(torch.sqrt((d.double() ** 2).mean())),
                              "max_abs": float(d.max())}
            for name in limits:
                if values[name] > worst[name].value:
                    worst[name] = Comparison(name, values[name], limits[name])
    finally:
        shutil.rmtree(state.root, ignore_errors=True)
    return list(worst.values())
