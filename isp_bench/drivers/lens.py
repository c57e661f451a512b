"""A closed loop of the lens-corrected chain over frames held on the card:
each item is one ``develop_lens_corrected`` call on one frame (CA removal
with the configuration's Poly3 models, the hot-pixel heal, the develop and
the OpcodeList3 warp, as the command line's ``develop --params
--repair-hot-pixels --warp`` runs them after the load), synchronised before
the next is submitted; the loop itself is ``resident.window``'s.

Traffic parameters (``traffic/<mix>.json``): ``inputs``, the distinct frames
the seed makes (each with the configuration's hot photosites), and ``mix``,
the develop tiers and their shares, as in ``resident.py``.

In a traced run only (``--trace 1``), the port's span recorder
(``pysp_tpu_torch.utils.tracing``) is on over the window: it is enabled as
the loop starts, and after the loop ``drain()`` hands its spans and the
counters' change to the run (``run.spans``, ``run.counters``) for the
readers of ``metrics/``. An untraced run leaves it off.

A sample of the window's images, one of each (input, tier) drawn from the
seed, is checked after the window against the plain reference of
``reference/lens.py``, computed in row bands of ``BAND_ROWS``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from isp_bench import control as control_module
from isp_bench import gen
from isp_bench.drivers import resident
from isp_bench.reference import develop as ref
from isp_bench.reference import lens as ref_lens

# Output rows of a band of the reference's develop and warp: a 102 MP frame
# in five bands, each about a 24 MP develop.
BAND_ROWS = 2048


def _models(conf: dict):
    from pysp_tpu_torch import Poly3CorrectionModel

    models = conf["lens"]["ca_models"]
    return tuple(Poly3CorrectionModel(models[k]["k1"]) for k in ("r", "b"))


def _warp_block(conf: dict) -> bytes:
    from pysp_tpu_torch import encode_warp_rectilinear

    warp = conf["lens"]["warp_rectilinear"]
    return encode_warp_rectilinear(warp["coefficients"], tuple(warp["center"]))


def _dcfg(conf: dict, quality: str):
    from pysp_tpu_torch import DevelopConfig, QualityDemosaic

    dev = conf["develop"]
    return DevelopConfig(quality=QualityDemosaic[quality.capitalize()],
                         postprocess_stages=dev["postprocess_stages"],
                         clip_highlights=dev["clip_highlights"], gamma_encode=dev["gamma_encode"])


def _entry(ctx, **chain):
    """The program's call for one item; ``chain`` overrides the chain's
    keywords (the faults of ``FAULTS``)."""
    from pysp_tpu_torch import develop_lens_corrected

    conf = ctx.config
    kw = {"ca_models": _models(conf), "repair_hot_pixels": True,
          "warp_block": _warp_block(conf), **chain}
    cfgs = {q: _dcfg(conf, q) for q, _ in ctx.traffic["mix"]}
    return lambda frame, quality: develop_lens_corrected(frame, cfgs[quality], **kw)


def make_counts(ctx, i: int) -> torch.Tensor:
    """The (h, w) counts of input ``i``: the seed's scene with the
    configuration's hot photosites at full scale."""
    conf = ctx.config
    mosaic = gen.scene_mosaic(conf["height"], conf["width"], ctx.seed, i, ctx.device)
    hot = conf["hot_pixels"]
    sites = gen.hot_sites(mosaic, gen.sub_seed(ctx.seed, 3, i), hot["singles"], hot["clusters"])
    return gen.bracket_counts(mosaic, sites, [1.0])[0].to(torch.int16)


def prepare(ctx, program=None) -> resident.State:
    # a port without the chain fails here, before any input is made
    from pysp_tpu_torch import develop_lens_corrected  # noqa: F401

    conf = ctx.config
    camera = conf["camera"]
    t0 = time.perf_counter()
    controller = resident._controller(camera)
    counts = [make_counts(ctx, i) for i in range(int(ctx.traffic["inputs"]))]
    inputs = [resident._frame(c, camera, controller, camera["exposure_time"], ctx.device)
              for c in counts]
    tiers = [q for q, _ in ctx.traffic["mix"]]
    shares = np.array([s for _, s in ctx.traffic["mix"]], np.float64)
    state = resident.State(entry=program or _entry(ctx), inputs=inputs, counts=counts,
                           brackets=[], tiers=tiers, shares=shares / shares.sum(),
                           mp=conf["height"] * conf["width"] / 1e6)
    resident._sync(ctx.device)
    t1 = time.perf_counter()
    ctx.setup_phases["inputs"] = t1 - t0
    # warm-up: every input at every tier, twice (the kernels' build, the
    # warp's displacement bounds, the allocator's blocks)
    for _ in range(2):
        for x in inputs:
            for q in tiers:
                state.entry(x, q)
    resident._sync(ctx.device)
    ctx.setup_phases["warm-up"] = time.perf_counter() - t1
    return state


def window(state: resident.State, ctx, seconds: float, session=None) -> None:
    if session is None:
        resident.window(state, ctx, seconds, None)
        return
    from pysp_tpu_torch.utils import tracing

    tracing.drain()                 # nothing of the set-up
    before = tracing.counters()
    tracing.enable()
    try:
        resident.window(state, ctx, seconds, session)
    finally:
        tracing.disable()
    rec = tracing.drain()
    ctx.run.spans = rec.spans
    ctx.run.counters = {k: v - before.get(k, 0) for k, v in rec.counters.items()
                        if v != before.get(k, 0)}


release = resident.release
attempts = resident.attempts


def reference_image(state: resident.State, ctx, i: int, quality: str,
                    dtype=torch.float32) -> torch.Tensor:
    """The plain reference's image of input ``i``."""
    conf = ctx.config
    if quality != "best":
        raise ValueError(f"the reference develops at Best only, not {quality!r}")
    frame = ref.frame(state.counts[i], conf["camera"], None, dtype)
    return ref_lens.lens_chain(frame, conf["lens"], conf["detector"], conf["develop"], BAND_ROWS)


def check(state: resident.State, ctx) -> list:
    """Every kept image against the plain reference (``resident.compare``);
    each number is the worst over the sample."""
    worst = {}
    for (i, q), got in sorted(state.kept.items()):
        want = reference_image(state, ctx, i, q)
        for c in resident.compare(got, want, ctx.limits):
            if c.name not in worst or c.value > worst[c.name].value:
                worst[c.name] = c
        del want
    state.kept.clear()
    return list(worst.values())


# --- the control and the faults of ``calibrate_lens.py`` and the tests -------------

def control(ctx, dtype=torch.bfloat16):
    """The plain reference in ``dtype`` in the program's place."""
    conf = ctx.config
    return lambda frame, quality: ref_lens.lens_chain(
        control_module._frame(frame, dtype=dtype), conf["lens"], conf["detector"],
        conf["develop"], BAND_ROWS)


def no_ca(ctx):
    """The CA removal skipped."""
    return _entry(ctx, ca_models=None)


def no_heal(ctx):
    """The hot-pixel heal skipped."""
    return _entry(ctx, repair_hot_pixels=False)


def bilinear_warp(ctx):
    """The warp's Lanczos4 taken as bilinear."""
    from pysp_tpu_torch import apply_opcode_3_warp

    chain = _entry(ctx, warp_block=None)
    block = _warp_block(ctx.config)
    return lambda frame, quality: apply_opcode_3_warp(chain(frame, quality), block,
                                                      interpolation="bilinear")


FAULTS = (no_ca, no_heal, bilinear_warp)
