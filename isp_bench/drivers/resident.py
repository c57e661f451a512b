"""A closed loop of one request over inputs held on the card: each item
calls the program's entry on one input, synchronises, and the next is
submitted. The image stays on the card.

Traffic parameters (``traffic/<mix>.json``):

- ``inputs``: how many distinct inputs the seed makes (cycled in an order
  drawn from the seed);
- ``entry``: ``develop`` (one frame) or ``develop_pipeline`` (a burst of the
  configuration's brackets through its corrections);
- ``mix``: ``[[quality, share], ...]``, the develop tiers and their shares,
  drawn from the seed for every item.

A sample of the window's outputs, one of each (input, tier) drawn from the
seed by reservoir sampling, is kept and checked against the plain reference
after the window.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from isp_bench import gen
from isp_bench.harness import Comparison, Item
from isp_bench.reference import develop as ref


@dataclasses.dataclass
class State:
    entry: object                # (input, quality) -> image
    inputs: list                 # the program's frames or bursts
    counts: list                 # the generator's counts of each input (int16)
    brackets: list               # the exposure times of a burst's frames
    tiers: list
    shares: np.ndarray
    mp: float
    kept: dict = dataclasses.field(default_factory=dict)   # (input, tier) -> image
    seen: dict = dataclasses.field(default_factory=dict)


def _controller(camera: dict):
    """The port's white-balance controller for the camera's two calibration
    matrices and its as-shot neutral, as a DNG load builds it."""
    from pysp_tpu_torch.colorimetry.illuminants import (
        get_chromaticity_from_illuminant, get_illuminant_from_lightsource,
        get_series_from_illuminant, xy_to_xyz)
    from pysp_tpu_torch.colorimetry.spaces import MatXyzToCamera
    from pysp_tpu_torch.colorimetry.wb import CameraWhiteBalanceController

    def stored(v):
        return np.round(np.asarray(v, np.float64) * 10000) / 10000

    mats = []
    for k in (1, 2):
        ill = get_illuminant_from_lightsource(int(camera[f"illuminant_{k}"]))
        mats.append(MatXyzToCamera(stored(camera[f"color_matrix_{k}"]).reshape(3, 3),
                                   xy_to_xyz(get_chromaticity_from_illuminant(ill)),
                                   get_series_from_illuminant(ill)))
    return CameraWhiteBalanceController(mats, stored(camera["as_shot_neutral"]))


def _frame(counts: torch.Tensor, camera: dict, controller, exposure_time, device):
    """The program's frame of ``counts``: normalised on the card by the
    port's ``bayer_normalize`` with the DNG's levels, then ``frame_from_parts``."""
    from pysp_tpu_torch import BayerPattern, bayer_normalize, frame_from_parts

    levels = [float(camera["black_level"])] * 4, [float(camera["white_level"])] * 4
    sensor = bayer_normalize(counts.to(device), *levels)
    return frame_from_parts(sensor, BayerPattern.Rggb, controller,
                            ref.exposure_value(camera, exposure_time), device=device)


def _entry(ctx, **pipeline):
    """The program's call for one item, from the configuration; ``pipeline``
    overrides fields of the burst's ``PipelineConfig`` (the faults of
    ``faults.py``)."""
    from pysp_tpu_torch import DevelopConfig, PipelineConfig, QualityDemosaic, develop, develop_pipeline

    conf = ctx.config
    dev = conf["develop"]

    def dcfg(quality):
        return DevelopConfig(quality=QualityDemosaic[quality.capitalize()],
                             postprocess_stages=dev["postprocess_stages"],
                             clip_highlights=dev["clip_highlights"],
                             gamma_encode=dev["gamma_encode"])

    if ctx.traffic["entry"] == "develop":
        return lambda frame, quality: develop(frame, dcfg(quality))
    pipe = conf["pipeline"]
    fields = {"fuse_hdr": True, "repair_hot_pixels": True,
              **{k: pipe[k] for k in ("hot_pixel_multiplier", "hot_pixel_quantile",
                                      "hot_pixel_iterations", "hot_pixel_shared_ratio")},
              **pipeline}
    pcfg = {q: PipelineConfig(develop=dcfg(q), **fields) for q, _ in ctx.traffic["mix"]}
    return lambda burst, quality: develop_pipeline(burst, pcfg[quality])


def make_counts(ctx, i: int) -> torch.Tensor:
    """The counts of input ``i``: one frame (h, w), or a burst (n, h, w) of
    the configuration's brackets with its hot photosites."""
    conf, dev = ctx.config, ctx.device
    mosaic = gen.scene_mosaic(conf["height"], conf["width"], ctx.seed, i, dev)
    if "brackets" not in conf:
        return gen.to_counts(mosaic).to(torch.int16)
    hot = conf["hot_pixels"]
    sites = gen.hot_sites(mosaic, gen.sub_seed(ctx.seed, 3, i), hot["singles"], hot["clusters"])
    return gen.bracket_counts(mosaic, sites, conf["brackets"]["scales"]).to(torch.int16)


def prepare(ctx, program=None) -> State:
    from pysp_tpu_torch import stack_frames

    conf = ctx.config
    camera = conf["camera"]
    t0 = time.perf_counter()
    controller = _controller(camera)
    n = int(ctx.traffic["inputs"])
    counts = [make_counts(ctx, i) for i in range(n)]
    brackets = [tuple(t) for t in conf["brackets"]["exposure_times"]] if "brackets" in conf else []
    inputs = []
    for c in counts:
        if brackets:
            frames = [_frame(c[k], camera, controller, t, ctx.device) for k, t in enumerate(brackets)]
            inputs.append(stack_frames(frames, device=ctx.device))
        else:
            inputs.append(_frame(c, camera, controller, camera["exposure_time"], ctx.device))
    tiers = [q for q, _ in ctx.traffic["mix"]]
    shares = np.array([s for _, s in ctx.traffic["mix"]], np.float64)
    mp = conf["height"] * conf["width"] * max(1, len(brackets)) / 1e6
    state = State(entry=program or _entry(ctx), inputs=inputs, counts=counts,
                  brackets=brackets, tiers=tiers, shares=shares / shares.sum(), mp=mp)
    _sync(ctx.device)
    t1 = time.perf_counter()
    ctx.setup_phases["inputs"] = t1 - t0
    # warm-up: every input at every tier, twice, so that the kernels are built
    # and the allocator holds the window's blocks
    for _ in range(2):
        for x in inputs:
            for q in tiers:
                state.entry(x, q)
    _sync(ctx.device)
    ctx.setup_phases["warm-up"] = time.perf_counter() - t1
    return state


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def window(state: State, ctx, seconds: float, session=None) -> None:
    rng = np.random.default_rng(gen.sub_seed(ctx.seed, 4))
    pick = np.random.default_rng(gen.sub_seed(ctx.seed, 5))
    run = ctx.run
    n = len(state.inputs)
    order = []
    if session:
        session.mark("lo")
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    while True:
        if not order:
            order = list(rng.permutation(n))
        i = int(order.pop())
        q = state.tiers[int(rng.choice(len(state.tiers), p=state.shares))]
        w0 = time.time_ns()
        s = time.perf_counter_ns()
        out = state.entry(state.inputs[i], q)
        w1 = time.time_ns()
        _sync(ctx.device)
        d = time.perf_counter_ns()
        if session:
            session.span(f"host: {ctx.traffic['entry']} ({q}) launching", w0, w1)
            session.span("host: waiting for the card", w1, time.time_ns())
        run.items.append(Item(s, d, state.mp, q))
        key = (i, q)
        state.seen[key] = state.seen.get(key, 0) + 1
        if pick.random() * state.seen[key] < 1.0:     # keep with probability 1/seen
            state.kept[key] = out
        del out
        if d >= end:
            break
    if session:
        session.mark("hi")
    run.window_s = (d - t0) / 1e9


def release(state: State) -> None:
    """Frees the program's inputs; the kept outputs and the counts stay."""
    state.inputs.clear()
    state.entry = None


def attempts(state: State, ctx):
    """(items attempted, items failed) of the window."""
    return len(ctx.run.items), 0


def reference_image(state: State, ctx, i: int, quality: str, dtype=torch.float32) -> torch.Tensor:
    """The plain reference's image of input ``i`` at ``quality``."""
    conf = ctx.config
    camera, dev = conf["camera"], conf["develop"]
    c = state.counts[i]
    if state.brackets:
        burst = [ref.frame(c[k], camera, t, dtype) for k, t in enumerate(state.brackets)]
        return ref.hdr_pipeline(burst, conf["pipeline"], dev["postprocess_stages"])
    return ref.develop(ref.frame(c, camera, None, dtype), quality, dev["postprocess_stages"],
                       dev["clip_highlights"], dev["gamma_encode"])


# A pixel off by more than this in some channel counts as off: an AHD pick
# flipped at an exact tie moves a pixel by far more, rounding by far less.
OFF_TOLERANCE = 1e-4


def compare(got: torch.Tensor, want: torch.Tensor, limits: dict) -> list:
    """The numbers of one image against its reference: the share of pixels
    off by more than ``OFF_TOLERANCE`` in some channel, the RMS error and the
    largest error."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return [Comparison(name, float("inf"), limit) for name, limit in limits.items()]
    d = (got.to(torch.float32) - want.to(torch.float32)).abs()
    values = {"off_share": float((d > OFF_TOLERANCE).any(dim=-1).to(torch.float32).mean()),
              "rms": float(torch.sqrt((d.double() ** 2).mean())),
              "max_abs": float(d.max())}
    return [Comparison(name, values[name], limit) for name, limit in limits.items()]


def check(state: State, ctx) -> list:
    """Every kept output against the plain reference; each number is the
    worst over the sample."""
    worst = {}
    for (i, q), got in sorted(state.kept.items()):
        for c in compare(got, reference_image(state, ctx, i, q), ctx.limits):
            if c.name not in worst or c.value > worst[c.name].value:
                worst[c.name] = c
    state.kept.clear()
    return list(worst.values())
