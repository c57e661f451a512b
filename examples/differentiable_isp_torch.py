"""Differentiable ISP on pysp_tpu_torch: optimize capture parameters by
gradient THROUGH develop.

The PyTorch counterpart of ``examples/differentiable_isp.py``. The Fast
develop (demosaic -> WB -> colour matrix -> gamma) is plain PyTorch on every
device, so autograd flows from a loss on the OUTPUT image back to exposure
gain and the white-balance neutral; no hand-written kernel needs a backward
(the JAX example takes the same route with ``use_pallas=False``).

Demo: a scene rendered under a known neutral is handed to the ISP with a wrong
neutral and wrong exposure; Adam descent (``torch.optim.Adam``) on a
gray-world + mean-exposure loss on the developed sRGB recovers both.

Run (on the card, or ``--device cpu``):
python -m examples.differentiable_isp_torch [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from pysp_tpu_torch.const import QualityDemosaic
from pysp_tpu_torch.core.frame import RawFrame
from pysp_tpu_torch.pipeline.develop import DevelopConfig, develop

# Fast tier: plain PyTorch on every device, differentiable end to end.
CFG = DevelopConfig(quality=QualityDemosaic.Fast, use_pallas=False)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method="cubic")`` along one
    axis when upsampling: Keys' cubic (a = -0.5) at the half-pixel-centred
    sample positions, normalized over the taps inside the input."""
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :])
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    return w / w.sum(axis=1, keepdims=True)


def make_scene(h: int = 256, w: int = 320, seed: int = 0):
    """A mosaic of a smooth gray-world scene under a non-neutral illuminant."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16, w // 16, 3), np.float32)
    rgb = np.einsum("Hh,hwc,Ww->HWc", _cubic_weights(h // 16, h), coarse,
                    _cubic_weights(w // 16, w)).astype(np.float32)
    rgb = np.clip(0.15 + 0.6 * rgb, 0.0, 1.0)
    neutral_true = np.array([0.55, 1.0, 0.7], np.float32)  # camera WB gains^-1
    bayer = np.empty((h, w), np.float32)
    bayer[0::2, 0::2] = rgb[0::2, 0::2, 0] * neutral_true[0]
    bayer[0::2, 1::2] = rgb[0::2, 1::2, 1]
    bayer[1::2, 0::2] = rgb[1::2, 0::2, 1]
    bayer[1::2, 1::2] = rgb[1::2, 1::2, 2] * neutral_true[2]
    # under-expose by 1.5 stops so the gain parameter has work to do
    return bayer * (2.0 ** -1.5), neutral_true


def initial_params(device) -> dict:
    """No gain, no WB: the starting point of the fit."""
    return {"log_gain": torch.zeros((), device=device),
            "neutral_rb": torch.ones(2, device=device)}


def develop_with_params(params, frame: RawFrame):
    """The differentiable surface: gain + neutral -> developed sRGB."""
    gain = torch.exp(params["log_gain"])
    neutral_rb = params["neutral_rb"]
    neutral = torch.cat([neutral_rb[:1], torch.ones_like(neutral_rb[:1]), neutral_rb[1:]])
    f = frame.replace(bayer=frame.bayer * gain, wb_neutral=neutral)
    return develop(f, CFG)


def loss_fn(params, frame: RawFrame):
    out = develop_with_params(params, frame)
    sl = out[8:-8, 8:-8]
    means = torch.mean(sl, dim=(0, 1))  # per-channel sRGB means
    gray_world = torch.sum((means - torch.mean(means)) ** 2)
    exposure = (torch.mean(means) - 0.5) ** 2
    return gray_world + exposure


def fit(frame: RawFrame, steps: int = 120, learning_rate: float = 5e-2):
    """Adam on ``loss_fn`` from :func:`initial_params`; returns the fitted
    parameters (detached) and the loss of the last step's parameters before
    its update, as the JAX example reports."""
    params = {k: v.requires_grad_() for k, v in initial_params(frame.device).items()}
    opt = torch.optim.Adam(params.values(), lr=learning_rate)
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(params, frame)
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}, float(loss.detach())


def main(device="cuda") -> dict:
    """Fit on the 256x320 scene on ``device``; prints and returns the loss
    before and after, the fitted parameters and the scene's true neutral."""
    bayer, neutral_true = make_scene()
    frame = RawFrame.synthetic(bayer, wb_neutral=np.ones(3, np.float32), device=device)
    with torch.no_grad():
        l0 = float(loss_fn(initial_params(frame.device), frame))
    params, loss = fit(frame)
    nr, nb = (float(v) for v in params["neutral_rb"])
    print(f"loss {l0:.5f} -> {loss:.6f}")
    print(f"recovered neutral R={nr:.3f} B={nb:.3f} "
          f"(scene {neutral_true[0]:.3f}/{neutral_true[2]:.3f}), "
          f"gain {float(torch.exp(params['log_gain'])):.2f}x "
          f"(under-exposed 2.83x)")
    return {"loss_initial": l0, "loss": loss, "params": params,
            "neutral_true": neutral_true, "frame": frame}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(parser.parse_args().device)
