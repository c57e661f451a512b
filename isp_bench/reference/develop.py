"""The plain develop and the corrections that precede it, from the
generator's counts and the camera's tags: normalisation, the white balance,
the hot-pixel detector (2x2 median, noise floor, count multisection), the
consensus masks, the heal (normalised-convolution fill and harmonic
smoothing), the Bayer-domain HDR fuse, the demosaic and the colour tail, and
the 8-bit quantisation of a saved PNG. A frozen copy of the port's plain
paths; it imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import colour, demosaic

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Frame:
    bayer: Tensor          # (H, W) RGGB, normalised to [0, 1] (or beyond for HDR)
    cam_mat: Tensor        # (3, 3) XYZ -> camera, float32
    cam_white: Tensor      # (3,) scene white XYZ, float32
    wb_neutral: Tensor     # (3,) camera neutral, float32
    ev: float
    lim_sat: float = 1.0
    is_hdr: bool = False


def normalise(counts: Tensor, camera: dict, dtype=torch.float32) -> Tensor:
    """clip(counts - black, 0, white) / white, as a DNG load scales them."""
    black = torch.tensor(float(camera["black_level"]), dtype=dtype, device=counts.device)
    white = torch.tensor(float(camera["white_level"]), dtype=dtype, device=counts.device)
    return torch.minimum(torch.clamp(counts.to(dtype) - black, min=0.0), white) / white


def exposure_value(camera: dict, exposure_time) -> float:
    n = camera["f_number"][0] / camera["f_number"][1]
    t = exposure_time[0] / exposure_time[1]
    return math.log2((100.0 * n * n) / (float(camera["iso"]) * t))


def frame(counts: Tensor, camera: dict, exposure_time=None, dtype=torch.float32) -> Frame:
    cam_mat, white, neutral = colour.white_balance(camera)
    dev = counts.device
    return Frame(
        bayer=normalise(counts, camera, dtype),
        cam_mat=torch.tensor(cam_mat, dtype=torch.float32, device=dev),
        cam_white=torch.tensor(white, dtype=torch.float32, device=dev),
        wb_neutral=torch.tensor(neutral, dtype=torch.float32, device=dev),
        ev=exposure_value(camera, exposure_time or camera["exposure_time"]),
    )


def develop(f: Frame, quality: str, stages: int = 1, clip: bool = True,
            gamma: bool = True) -> Tensor:
    """(H, W, 3) sRGB of ``f`` at ``quality`` (best, fast or draft), in the
    mosaic's dtype."""
    # the reference's float32 stays float32: no TF32 in its matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = f.bayer.dtype
    mat = colour.cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white).to(dt)
    wb = (1.0 / f.wb_neutral).to(dt)
    if quality == "best":
        r, g, b = demosaic.ahd(f.bayer, mat, wb, f.is_hdr, stages)
    elif quality == "fast":
        r, g, b = demosaic.eag(f.bayer, wb)
    elif quality == "draft":
        r, g, b = demosaic.draft(f.bayer, wb)
    else:
        raise ValueError(f"quality {quality!r}")
    return torch.stack(colour.colour_tail(r, g, b, mat, clip, gamma), dim=-1)


# --- corrections -------------------------------------------------------------

def planes(bayer: Tensor) -> Tensor:
    return torch.stack(demosaic.rgbg(bayer), dim=-3)


def unplanes(p: Tensor) -> Tensor:
    return demosaic.interleave(p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :], p[..., 3, :, :])


def _median2(x: Tensor) -> Tensor:
    """Mean of the two middle values of {self, E, S, SE}, reflect101 border."""
    h, w = x.shape[-2:]
    xp = demosaic.pad(x, 1, 1, 1, 1, "reflect")
    a, b = xp[..., 1:1 + h, 1:1 + w], xp[..., 1:1 + h, 2:2 + w]
    c, d = xp[..., 2:2 + h, 1:1 + w], xp[..., 2:2 + h, 2:2 + w]
    return (torch.maximum(torch.minimum(a, b), torch.minimum(c, d))
            + torch.minimum(torch.maximum(a, b), torch.maximum(c, d))) * 0.5


def hot_masks(bayer: Tensor, multiplier: float, quantile: float) -> Tensor:
    """(4, H/2, W/2) hot-photosite masks: the |delta| from the 2x2 median,
    less its plane mean, above ``multiplier`` times the plane's ``quantile``
    as four passes of a 16-point count multisection find it."""
    p = planes(bayer)
    delta = torch.abs(p - _median2(p))
    delta = torch.abs(delta - delta.mean(dim=(-2, -1), keepdim=True))
    n = delta.shape[-2] * delta.shape[-1]
    lo, hi = delta.amin(dim=(-2, -1)), delta.amax(dim=(-2, -1))
    target = torch.full((), float(np.float32(quantile * (n - 1))), device=delta.device)
    fr = torch.arange(1, 17, dtype=delta.dtype, device=delta.device) \
        / torch.full((), 17.0, dtype=delta.dtype, device=delta.device)
    for _ in range(4):
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]
        cnt = torch.stack([(delta[k][None] <= mids[k][:, None, None]).sum(dim=(-2, -1))
                           for k in range(4)])
        ok = (cnt.to(torch.float32) - 1.0) >= target
        hi = torch.where(ok, mids, hi[:, None]).amin(dim=1)
        lo = torch.where(ok, lo[:, None], mids).amax(dim=1)
    return delta > hi.reshape(4, 1, 1) * multiplier


def _nb_sum(x: Tensor) -> Tensor:
    return demosaic.shift(x, -1, 0) + demosaic.shift(x, 1, 0) + demosaic.shift(x, 0, -1) \
        + demosaic.shift(x, 0, 1)


def heal(p: Tensor, mask: Tensor, fill: int = 4, smooth: int = 2) -> Tensor:
    """Masked sites filled by normalised convolution (``fill`` sweeps, then
    the plane mean where no sweep reached) and ``smooth`` harmonic sweeps."""
    v = torch.logical_not(mask).to(p.dtype)
    x = p * v
    for _ in range(fill):
        xs, vs = _nb_sum(x), _nb_sum(v)
        x = torch.where(v > 0, x, xs / torch.clamp(vs, min=1.0))
        v = torch.clamp(v + vs, max=1.0)
    x = torch.where(v > 0, x, p.mean(dim=(-2, -1), keepdim=True))
    for _ in range(smooth):
        x = torch.where(mask, _nb_sum(x) * 0.25, p)
    return torch.where(mask, x, p)


def fuse(frames: list) -> Frame:
    """The burst's Bayer-domain HDR fuse: EV-normalised, tent-weighted with
    the noise bias, falling back to the brightest frame where no weight is."""
    dt = frames[0].bayer.dtype
    dev = frames[0].bayer.device
    evs = torch.tensor([f.ev for f in frames], dtype=torch.float32, device=dev)
    target = evs.mean()
    off = 2.0 ** (evs - target)
    wb = 1.0 / frames[0].wb_neutral
    wpat = torch.stack([torch.stack([wb[0], wb[1]]), torch.stack([wb[1], wb[2]])])
    bias = (1.6 ** (-0.1 * torch.abs(off[:, None, None] * wpat[None]))).to(dt)
    n = len(frames)
    h, w = frames[0].bayer.shape
    bayer = torch.stack([f.bayer for f in frames]).reshape(n, h // 2, 2, w // 2, 2)
    offd = off.to(dt)[:, None, None, None, None]
    weights = (0.5 - torch.abs(bayer - 0.5)) * bias[:, None, :, None, :]
    sw = weights.sum(dim=0)
    sp = (bayer * weights * offd).sum(dim=0)
    brightest = bayer[int(torch.argmax(off))] * off.max().to(dt)
    fused = torch.where(sw == 0, brightest, sp / sw).reshape(h, w)
    return dataclasses.replace(frames[0], bayer=fused, ev=float(target),
                               lim_sat=float(off.max()), is_hdr=True)


def hdr_pipeline(burst: list, pipe: dict, stages: int) -> Tensor:
    """Consensus hot-pixel masks over the burst, each frame healed, the fuse,
    the Best develop."""
    masks = [hot_masks(f.bayer, pipe["hot_pixel_multiplier"], pipe["hot_pixel_quantile"])
             for f in burst]
    need = float(np.ceil(np.float32(len(burst) * pipe["hot_pixel_shared_ratio"])))
    shared = sum(m.to(torch.int32) for m in masks) >= need
    healed = [dataclasses.replace(f, bayer=unplanes(heal(planes(f.bayer), shared,
                                                        pipe["hot_pixel_iterations"])))
              for f in burst]
    return develop(fuse(healed), "best", stages)


def to_uint8(img: Tensor) -> Tensor:
    """The 8-bit samples a PNG save writes: clip(x * 255 + 0.5, 0, 255)."""
    return torch.clamp(img.to(torch.float32) * 255.0 + 0.5, 0, 255).to(torch.uint8)
