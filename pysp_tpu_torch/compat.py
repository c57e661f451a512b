"""Reference-compatible class API (the surface of bullbin/pySP's classes).

Counterpart of ``pysp_tpu/compat.py``: thin mutable wrappers over the
functional core, mirroring the reference's public classes (image.py:156-357,
base_types/image_base.py:19-124), on tensors. A pySP user can port

    image = RawBayerDataFromRaw(path)
    rgb = image.demosaic(QualityDemosaic.Best).to_lin_srgb()
    srgb = lin_srgb_to_srgb(rgb)

verbatim, with the imports changed to ``pysp_tpu_torch.compat``. The
constructors put float32 copies of their arrays or tensors on ``device``, the
card unless the caller asks for another. The demosaic is
the JAX package's: its plain version (``demosaic(..., use_pallas=False)``), on
any device. New code should prefer the functional API (``load_raw`` +
``develop``), whose Best develop is one launch of the AHD kernel on the card.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .colorimetry.transforms import cam_to_lin_srgb, lin_srgb_to_srgb  # noqa: F401
from .colorimetry.wb import CameraWhiteBalanceController
from .const import BayerPattern, QualityDemosaic
from .core.bayer import reversible_transform_rggb
from .core.device import CARD, resolve_device
from .core.frame import RawFrame, _f32
from .demosaic import demosaic as _demosaic
from .io.raw_loader import controller_for_source, load_raw

Tensor = torch.Tensor


class RawDemosaicData:
    """Post-demosaic RGB container (image_base.py:19-64). Mutable shim over
    DevelopedImage semantics."""

    def __init__(self, image, wb_coeff, wb_norm: bool = False, device=CARD):
        device = resolve_device(device)
        self.image = _f32(image, device)
        self._wb_coeff = _f32(wb_coeff, device)
        self._wb_applied = True
        self._wb_normalized = wb_norm
        self.mat_xyz = None  # MatXyzToCamera
        self.current_ev: float = float(np.inf)

    def is_valid(self) -> bool:
        return (
            self.image is not None
            and self._wb_coeff is not None
            and self.mat_xyz is not None
            and np.isfinite(self.current_ev)
        )

    def wb_apply(self) -> None:
        if not self._wb_applied:
            self.image = self.image * self._wb_coeff[:3]
            self._wb_applied = True

    def wb_undo(self) -> None:
        if self._wb_applied:
            if self._wb_normalized:
                self.image = self.image * torch.max(self._wb_coeff)
            self.image = self.image / self._wb_coeff[:3]
            self._wb_applied = False
            self._wb_normalized = False

    def to_lin_srgb(self) -> Tensor:
        self.wb_apply()
        device = self.image.device
        return cam_to_lin_srgb(
            self.image, _f32(self.mat_xyz.mat, device), _f32(self.mat_xyz.xyz, device)
        )


class RawRggbBayerData:
    """Canonical-RGGB raw container (image.py:156-183 + image_base.py:104-124)."""

    def __init__(
        self,
        sensor_scaled,
        cam_wb: CameraWhiteBalanceController,
        shot_ev: float,
        lim_sat: float = 1.0,
        source_pattern: BayerPattern = BayerPattern.Rggb,
        device=CARD,
    ):
        self.sensor_scaled = _f32(sensor_scaled, resolve_device(device))
        self.cam_wb = cam_wb
        self.current_ev = float(shot_ev)
        self.lim_sat = float(lim_sat)
        self.source_pattern = source_pattern
        self._is_hdr = False

    def set_hdr(self, is_hdr: bool) -> None:
        self._is_hdr = is_hdr

    def get_hdr(self) -> bool:
        return self._is_hdr

    def _to_frame(self) -> RawFrame:
        mat = self.cam_wb.get_matrix()
        device = self.sensor_scaled.device
        return RawFrame(
            bayer=self.sensor_scaled,
            cam_mat=_f32(mat.mat, device),
            cam_white=_f32(mat.xyz, device),
            wb_neutral=_f32(self.cam_wb.get_neutral(), device),
            ev=_f32(self.current_ev, device),
            lim_sat=_f32(self.lim_sat, device),
            is_hdr=self._is_hdr,
            source_pattern=self.source_pattern,
        )

    def demosaic(
        self, quality: QualityDemosaic, postprocess_steps: int = 1
    ) -> RawDemosaicData:
        frame = self._to_frame()
        dev = _demosaic(frame, quality, postprocess_steps)
        image = dev.image
        if self.source_pattern != BayerPattern.Rggb:
            image = reversible_transform_rggb(image, self.source_pattern)

        out = RawDemosaicData(image, dev.wb_coeff, wb_norm=False, device=image.device)
        out.mat_xyz = self.cam_wb.get_matrix()
        out.current_ev = self.current_ev
        return out


class RawBayerData(RawRggbBayerData):
    """Raw container in its native pattern; canonicalizes on demand
    (image.py:185-197)."""

    def __init__(
        self,
        sensor_scaled,
        cam_wb: CameraWhiteBalanceController,
        shot_ev: float,
        lim_sat: float = 1.0,
        sensor_pattern: BayerPattern = BayerPattern.Rggb,
        device=CARD,
    ):
        canonical = reversible_transform_rggb(
            _f32(sensor_scaled, resolve_device(device)), sensor_pattern
        )
        super().__init__(canonical, cam_wb, shot_ev, lim_sat, sensor_pattern, device=device)
        self.sensor_pattern = sensor_pattern

    def to_rggb(self) -> RawRggbBayerData:
        return RawRggbBayerData(
            self.sensor_scaled,
            self.cam_wb.copy(),
            self.current_ev,
            self.lim_sat,
            self.sensor_pattern,
            device=self.sensor_scaled.device,
        )


class RawBayerDataFromRaw(RawBayerData):
    """Decode a raw file into a Bayer container on ``device`` (image.py:199-307)."""

    def __init__(self, filename_or_data: Union[str, bytes], device=CARD):
        frame = load_raw(filename_or_data, device=device)
        # Rebuild the WB controller from the file so later update_by_* calls
        # work (EXIF matrices for DNG, loader-resolved fallback otherwise).
        cam_wb = controller_for_source(filename_or_data, frame)

        super().__init__(
            reversible_transform_rggb(frame.bayer, frame.source_pattern),
            cam_wb,
            float(frame.ev),
            float(frame.lim_sat),
            frame.source_pattern,
            device=device,
        )


# The reference's alternate libraw-postprocess loader (image.py:309-357) requires
# rawpy; gated here the same way.
class RawDebayerDataFromRaw(RawDemosaicData):
    def __init__(self, filename_or_data: Union[str, bytes], device=CARD):
        try:
            import rawpy  # type: ignore
        except ImportError as e:
            raise ValueError(
                "RawDebayerDataFromRaw needs rawpy/libraw for the postprocess path"
            ) from e

        from io import BytesIO

        from .io import tiff as T
        from .io.metadata import (
            compute_ev_from_tiff,
            exif_get_as_shot_neutral,
            exif_get_color_mat_sources,
        )

        reader = (
            filename_or_data
            if isinstance(filename_or_data, str)
            else BytesIO(filename_or_data)
        )
        with rawpy.imread(reader) as in_dng:
            wb_coeff = in_dng.daylight_whitebalance
            image = in_dng.postprocess(
                demosaic_algorithm=rawpy.DemosaicAlgorithm.AHD,
                fbdd_noise_reduction=rawpy.FBDDNoiseReductionMode.Full,
                gamma=(1, 1),
                use_camera_wb=True,
                use_auto_wb=False,
                output_color=rawpy.ColorSpace.raw,
                output_bps=16,
                no_auto_bright=True,
                highlight_mode=rawpy.HighlightMode.Clip,
            )

        super().__init__(np.asarray(image, np.float32) / (2**16 - 1), wb_coeff[:3],
                         device=device)

        tf = T.read_tiff(filename_or_data)
        cont = CameraWhiteBalanceController(
            exif_get_color_mat_sources(tf), exif_get_as_shot_neutral(tf)
        )
        cont.update_by_reference(np.asarray(wb_coeff[:3]))
        self.mat_xyz = cont.get_matrix()
        self.current_ev = compute_ev_from_tiff(filename_or_data)
        self._wb_applied = True
        self._wb_normalized = True
