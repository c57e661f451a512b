"""Frame containers: RawFrame (Bayer domain) and DevelopedImage (RGB domain).

Counterpart of ``pysp_tpu/core/frame.py``. The flax pytrees become frozen
dataclasses of tensors; the behavioural switches (HDR flag, source pattern) are
plain fields. Every tensor of one instance lives on one device; ``.to(device)``
moves them together.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..const import BayerPattern
from .device import CARD, resolve_device

Tensor = torch.Tensor

# D65 whitepoint at Y=1
_D65_WHITE = (0.95043, 1.0, 1.08890)


def _f32(value, device) -> Tensor:
    """A float32 contiguous copy of ``value`` (an array, a number or a tensor
    on any device) on ``device``."""
    if isinstance(value, torch.Tensor):
        out = torch.empty(tuple(value.shape), dtype=torch.float32, device=device)
        return out.copy_(value)
    return torch.tensor(np.asarray(value, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class RawFrame:
    """A normalized, canonical-RGGB Bayer frame plus its colour metadata.

    ``cam_mat`` is the optimal XYZ->camera matrix and ``wb_neutral`` the camera
    neutral point from the host-side white-balance solver, so the reciprocal
    multipliers are ``1 / wb_neutral``.
    """

    bayer: Tensor                      # (H, W) float32 in [0,1] (RGGB order)
    cam_mat: Tensor                    # (3, 3) XYZ -> camera matrix
    cam_white: Tensor                  # (3,) scene illuminant XYZ
    wb_neutral: Tensor                 # (3,) camera neutral; reciprocal = WB gains
    ev: Tensor                         # () exposure value
    lim_sat: Tensor                    # () saturation ceiling (>1 for HDR stacks)
    is_hdr: bool = False
    source_pattern: BayerPattern = BayerPattern.Rggb

    @property
    def height(self) -> int:
        return self.bayer.shape[-2]

    @property
    def width(self) -> int:
        return self.bayer.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.bayer.device

    def wb_reciprocal(self) -> Tensor:
        """Reciprocal neutral multipliers."""
        return 1.0 / self.wb_neutral

    def replace(self, **changes) -> "RawFrame":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RawFrame":
        """The same frame with every tensor on ``device``."""
        return self.replace(
            bayer=self.bayer.to(device),
            cam_mat=self.cam_mat.to(device),
            cam_white=self.cam_white.to(device),
            wb_neutral=self.wb_neutral.to(device),
            ev=self.ev.to(device),
            lim_sat=self.lim_sat.to(device),
        )

    @classmethod
    def from_numpy(
        cls,
        bayer,
        cam_mat,
        cam_white,
        wb_neutral,
        ev,
        lim_sat,
        is_hdr: bool = False,
        source_pattern: BayerPattern = BayerPattern.Rggb,
        device=CARD,
    ) -> "RawFrame":
        """Build a frame from NumPy arrays (or anything ``np.asarray`` takes, or
        tensors), copied into float32 contiguous tensors on ``device`` (the
        card unless the caller asks for another)."""
        device = resolve_device(device)
        return cls(
            bayer=_f32(bayer, device),
            cam_mat=_f32(cam_mat, device),
            cam_white=_f32(cam_white, device),
            wb_neutral=_f32(wb_neutral, device),
            ev=_f32(ev, device),
            lim_sat=_f32(lim_sat, device),
            is_hdr=bool(is_hdr),
            source_pattern=BayerPattern(source_pattern),
        )

    @classmethod
    def synthetic(
        cls,
        bayer,
        cam_mat: Optional[np.ndarray] = None,
        cam_white: Optional[np.ndarray] = None,
        wb_neutral: Optional[np.ndarray] = None,
        ev: float = 10.0,
        lim_sat: float = 1.0,
        is_hdr: bool = False,
        source_pattern: BayerPattern = BayerPattern.Rggb,
        device=CARD,
    ) -> "RawFrame":
        """Build a frame with identity colour metadata, for tests and benchmarks,
        on ``device`` (the card unless the caller asks for another)."""
        return cls.from_numpy(
            bayer,
            np.eye(3) if cam_mat is None else cam_mat,
            _D65_WHITE if cam_white is None else cam_white,
            np.ones(3) if wb_neutral is None else wb_neutral,
            ev,
            lim_sat,
            is_hdr=is_hdr,
            source_pattern=source_pattern,
            device=device,
        )


_TENSOR_FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def stack_frames(frames, device=CARD) -> RawFrame:
    """One burst frame from N frames: every tensor gains a leading frame axis,
    the layout ``develop_burst`` and ``develop_pipeline`` take. The
    counterpart of ``jax.tree_util.tree_map(jnp.stack, *frames)``.

    The frames must agree in shape, source pattern and HDR flag. The burst
    lands on ``device`` (the card unless the caller asks for another)."""
    frames = list(frames)
    if not frames:
        raise ValueError("stack_frames needs at least one frame")
    device = resolve_device(device)
    kinds = {(tuple(f.bayer.shape), f.source_pattern, f.is_hdr) for f in frames}
    if len(kinds) != 1:
        raise ValueError(f"burst frames disagree in (shape, pattern, is_hdr): {kinds}")
    return frames[0].replace(**{
        k: torch.stack([getattr(f, k).to(device) for f in frames]) for k in _TENSOR_FIELDS
    })


def unstack_frames(burst: RawFrame) -> list:
    """The N frames of a burst frame (leading frame axis on every tensor), as views."""
    return [
        burst.replace(**{k: getattr(burst, k)[i] for k in _TENSOR_FIELDS})
        for i in range(burst.bayer.shape[0])
    ]


@dataclasses.dataclass(frozen=True)
class DevelopedImage:
    """Post-demosaic RGB container.

    ``image`` is camera-space RGB. WB application state is tracked functionally:
    ``wb_apply`` / ``wb_undo`` return new instances instead of mutating.
    """

    image: Tensor                      # (H, W, 3) camera-space RGB
    wb_coeff: Tensor                   # (3,) reciprocal multipliers used at demosaic
    cam_mat: Tensor                    # (3, 3) XYZ -> camera matrix
    cam_white: Tensor                  # (3,) scene illuminant XYZ
    ev: Tensor                         # ()
    wb_applied: bool = True
    wb_normalized: bool = False

    def replace(self, **changes) -> "DevelopedImage":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "DevelopedImage":
        """The same image with every tensor on ``device``."""
        return self.replace(
            image=self.image.to(device),
            wb_coeff=self.wb_coeff.to(device),
            cam_mat=self.cam_mat.to(device),
            cam_white=self.cam_white.to(device),
            ev=self.ev.to(device),
        )

    def wb_apply(self) -> "DevelopedImage":
        """Apply WB coefficients if not already applied."""
        if self.wb_applied:
            return self
        return self.replace(image=self.image * self.wb_coeff[:3], wb_applied=True)

    def wb_undo(self) -> "DevelopedImage":
        """Return to pure camera space, removing normalization."""
        if not self.wb_applied:
            return self
        image = self.image
        if self.wb_normalized:
            image = image * torch.max(self.wb_coeff)
        image = image / self.wb_coeff[:3]
        return self.replace(image=image, wb_applied=False, wb_normalized=False)

    def to_lin_srgb(self, clip_highlights: bool = True) -> Tensor:
        """WB-apply then convert camera RGB to linear sRGB."""
        from ..colorimetry.transforms import cam_to_lin_srgb

        applied = self.wb_apply()
        return cam_to_lin_srgb(
            applied.image, self.cam_mat, self.cam_white, clip_highlights
        )
