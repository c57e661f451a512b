"""Blind in-raw chromatic aberration: model fitting orchestration + removal.

Counterpart of ``pysp_tpu/correct/ca/removal.py`` (pySP's corr_ca/ca_removal.py,
roughly following DOI 10.1109/ACCESS.2021.3096201):

- fit: structural instability (torch, on the frame's device) -> per-channel
  radial scale pairs (host ROI screening, then one batch of template matches
  on the device) -> model fit (host NumPy);
- removal: upsample G alone; warp G onto the R/B grids (inverse model +
  bilinear remap), G-guided upsample of R/B, forward-warp back onto the G grid,
  re-sample at the Bayer phase and overwrite the raw planes. On CUDA tensors
  the upsamples are the EAG kernels of ``ops.cuda_kernels`` (the G fill and
  each channel's upsample, one launch each over the burst), bit for bit their
  plain versions in ``demosaic/eag.py``, which CPU tensors run.

One path for a frame and a burst, on every device: a frame is a burst of one.
The coordinate maps depend only on the model and the shape, so each remap is
one launch of the remap kernel over the whole burst with the coordinates
shared by its frames: four launches for two models, two for one, whatever the
burst's length. On a CUDA tensor with a model that states its radial form
(``kernel_form()``: Poly3, Poly5, PTLens), the kernel computes the
coordinates itself (``ops.cuda_kernels.remap_radial_kernel``), and no
coordinate field is built in device memory; its output is the maps path's bit
for bit. Otherwise (CPU tensors, any other reversible model) each (model,
direction) field is built once with plain PyTorch and its clipped maps go to
``ops.cuda_kernels.remap_kernel`` (bilinear, ``bounds=None``), which runs its
plain version, ``remap_plain``, on CPU tensors.

``_model_bound_px`` is the static displacement bound of a model's maps (a
host sweep of the radial maps). The row-sharded pipeline
(``parallel/spatial_pipeline.py``) sizes its halo with it; the removal here
does not need it. Not carried: the JAX package's row, rectangle and grid
zones, the separable kinds and the VMEM gates. They serve Mosaic's
select-chain remap, which has no gather. Hopper gathers natively, and the
kernel's unbounded bilinear is bit-identical to ``remap_plain``'s gather.
Within the bound that ``_model_bound_px`` guarantees, that gather equals the
JAX package's bounded CPU path, which ``remap_bilinear_bounded`` holds
bit-identical to the gather (``pysp_tpu/ops/resample.py``).

With the recorder of ``utils/tracing.py`` on, a removal is the span
``ca.remove``, with ``ca.maps`` (one plain coordinate field and its clipped
maps; the counter ``ca.maps_built`` counts them), ``ca.resample`` (the
full-resolution green, then each of R and B upsampled with it) and
``ca.remap`` (one remap kernel launch) inside; every one is also timed on the
device, and none reads the thread's CPU clock. The counter
``ca.maps_in_kernel`` counts the remaps whose coordinates the kernel computed:
for two Poly3 models on the card it is 4 a call and ``ca.maps_built`` 0. The
counter ``ca.resample_in_kernel`` counts the resamples that launched an EAG
kernel (``demosaic.eag.resamples_in_kernel``): 3 a call with two models on the
card, 0 on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ...core.frame import RawFrame
from ...demosaic.eag import (
    resample_b,
    resample_g_to_full_resolution,
    resample_r,
    resamples_in_kernel,
)
from ...ops.cuda_kernels import remap_kernel, remap_radial_kernel
from ...utils.tracing import count, span
from .instability import compute_structural_instability
from .models import CaCorrectionModel, Poly5CorrectionModel, ReversibleModelMixin
from .solver import get_scale_pairs_using_pooled_tiler

Tensor = torch.Tensor


def compute_ca_lens_models_for_raw(
    frame: RawFrame,
    init_model_r: Optional[CaCorrectionModel] = None,
    init_model_b: Optional[CaCorrectionModel] = None,
    max_distortion_additional_scale: float = 0.004,
) -> Tuple[Optional[CaCorrectionModel], Optional[CaCorrectionModel]]:
    """Fit R->G and B->G alignment models from a single raw (ca_removal.py:15-46).

    A model given as ``None`` is a fresh Poly5 model, as in the JAX package
    (the reference's mutable-default instances are avoided). The instability
    map and the template matches stay on the frame's device; the ROI screening
    runs on a host copy of the R and B instability planes."""
    if init_model_r is None:
        init_model_r = Poly5CorrectionModel()
    if init_model_b is None:
        init_model_b = Poly5CorrectionModel()

    si = compute_structural_instability(frame)
    reference = si[..., 1].contiguous()

    init_model_r.compute_coefficients(
        get_scale_pairs_using_pooled_tiler(
            si[..., 0], reference, max_reach=max_distortion_additional_scale
        )
    )
    init_model_b.compute_coefficients(
        get_scale_pairs_using_pooled_tiler(
            si[..., 2], reference, max_reach=max_distortion_additional_scale
        )
    )
    return init_model_r, init_model_b


def _maps_from_offsets(coords: Tensor, h: int, w: int):
    """Center-relative (dy, dx) coordinate field -> clipped (map_x, map_y)."""
    map_x = torch.clamp(coords[..., 1] + (w - 1) / 2.0, 0, w - 1)
    map_y = torch.clamp(coords[..., 0] + (h - 1) / 2.0, 0, h - 1)
    return map_x.contiguous(), map_y.contiguous()


def _model_bound_px(model, h: int, w: int, cap: int = 12) -> Optional[int]:
    """Static per-axis displacement bound of a radial model's remaps on an
    (h, w) frame, in pixels, or None.

    |dy| = |y| |f(r)/r - 1| <= r_corner max_r |f(r) - r| for both the
    forward and the Newton-inverted map, taken on a sweep of 4096 radii in
    (0, 1] on the host, plus 2. None when the model has no inverse, its maps
    are not finite, or the bound exceeds ``cap``."""
    if not isinstance(model, ReversibleModelMixin):
        return None
    rs = torch.from_numpy(np.linspace(1e-4, 1.0, 4096).astype(np.float32))
    fwd = model.get_distorted(rs).double().numpy()
    inv = model.estimate_undistorted(rs).double().numpy()
    rs64 = rs.double().numpy()
    dev = max(np.abs(fwd - rs64).max(), np.abs(inv - rs64).max())
    if not np.isfinite(dev):
        return None
    r_corner = float(np.hypot((h - 1) / 2.0, (w - 1) / 2.0))
    bound = int(np.ceil(dev * r_corner)) + 2
    return bound if bound <= cap else None


def _kernel_form(model, stack: Tensor):
    """The radial form whose coordinates the remap kernel computes for
    ``model`` on ``stack``, or None (CPU tensors, models without one): then
    the plain coordinate maps."""
    return model.kernel_form() if stack.is_cuda else None


def remove_ca_from_raw(
    frame: RawFrame,
    lens_model_r: Optional[CaCorrectionModel],
    lens_model_b: Optional[CaCorrectionModel],
) -> RawFrame:
    """Align R/B onto G in the mosaic of a frame (H, W) or a burst (N, H, W);
    returns the corrected frame or burst (ca_removal.py:48-132).

    Models must be reversible (forward + inverse radial maps). A burst's
    frames share the maps and each remap is one kernel launch over all of
    them; the result equals the frames corrected one by one."""
    if lens_model_r is None and lens_model_b is None:
        return frame

    for name, model in (("Red", lens_model_r), ("Blue", lens_model_b)):
        if model is not None and not isinstance(model, ReversibleModelMixin):
            raise ValueError(
                f"{name} lens model is not reversible so green cannot be re-aligned "
                "to remove error. Use a reversible model and try again."
            )

    device = frame.bayer.device
    with span("ca.remove", device=device, cpu=False):
        single = frame.bayer.ndim == 2
        bayer = frame.bayer[None] if single else frame.bayer
        wb = frame.wb_reciprocal().reshape(-1, 3)[:, :, None, None]   # (N, 3, 1, 1)

        r, g1, b, g2 = bayer_to_rgbg(bayer)                           # (N, h2, w2)

        def resample(fn, *planes):
            if resamples_in_kernel(planes[0]):
                count("ca.resample_in_kernel")
            with span("ca.resample", device=device, cpu=False):
                return fn(*planes)

        g_res = resample(resample_g_to_full_resolution, g1, g2)      # (N, fh, fw)
        fh, fw = g_res.shape[-2], g_res.shape[-1]

        def remap(stack, model, inverse):
            form = _kernel_form(model, stack)
            if form is not None:
                count("ca.maps_in_kernel")
                with span("ca.remap", device=device, cpu=False):
                    return remap_radial_kernel(stack, form, inverse)
            coordinates = (model.get_undistorted_coordinates if inverse
                           else model.get_distorted_coordinates)
            with span("ca.maps", device=device, cpu=False):
                count("ca.maps_built")
                # g_res[0] carries the shape and device only: the maps read no pixel
                xy = _maps_from_offsets(coordinates(g_res[0]), fh, fw)
            with span("ca.remap", device=device, cpu=False):
                return remap_kernel(stack, *xy, "bilinear")

        if lens_model_r is not None:
            g_at_r = remap(g_res, lens_model_r, inverse=True)
            r_res = resample(resample_r, r * wb[:, 0], g_at_r)
            r_at_g = remap(r_res, lens_model_r, inverse=False)
            r = bayer_to_rgbg(r_at_g)[0] / wb[:, 0]

        if lens_model_b is not None:
            g_at_b = remap(g_res, lens_model_b, inverse=True)
            b_res = resample(resample_b, b * wb[:, 2], g_at_b)
            b_at_g = remap(b_res, lens_model_b, inverse=False)
            b = bayer_to_rgbg(b_at_g)[2] / wb[:, 2]

        out = rgbg_to_bayer(r, g1, b, g2)
    return frame.replace(bayer=out[0] if single else out)
