"""pysp_tpu_torch — the PyTorch + CUDA port of pysp_tpu, for an NVIDIA H100.

Same module paths and function names as ``pysp_tpu``; plain PyTorch on
tensors, with hand-written CUDA kernels (``csrc/``) on the hot path, built with
``nvcc`` at first CUDA use. Importing the package imports neither JAX nor
``pysp_tpu``.

Entry points run on the GPU unless the caller asks for another device
(``device="cpu"``); without a GPU the default raises. Canonical flow:

    from pysp_tpu_torch import load_raw, develop, save_image, DevelopConfig, QualityDemosaic
    frame = load_raw("shot.dng")  # on the card
    srgb = develop(frame, DevelopConfig(quality=QualityDemosaic.Best))
    save_image("out.tif", srgb)

With sensor corrections (flat field, hot-pixel heal, denoise) and the
Bayer-domain HDR fuse of a bracketed burst, ``develop_pipeline``:

    from pysp_tpu_torch import PipelineConfig, develop_pipeline, stack_frames
    srgb = develop_pipeline(frame, PipelineConfig(flat_field=True, repair_hot_pixels=True),
                            flat=load_raw("flat.dng"))
    burst = stack_frames([load_raw(p) for p in paths])
    srgb = develop_pipeline(burst, PipelineConfig(fuse_hdr=True))

Lateral chromatic aberration: fit R->G and B->G radial models blind from the
mosaic, or by gradient descent, and remove them from a frame or a burst:

    model_r, model_b = compute_ca_lens_models_for_raw(frame)  # or fit_ca_models_gradient
    frame = remove_ca_from_raw(frame, model_r, model_b)

A DNG's OpcodeList1 (listed bad pixels) and OpcodeList2 (shading gains)
apply at load. Highlight reconstruction and per-develop statistics:

    srgb = develop(frame, DevelopConfig(highlights="reconstruct"))
    srgb, stats = develop_with_stats(frame, DevelopConfig())

The command line: ``python -m pysp_tpu_torch develop shot.dng -o out.tif
--deconv 1.0:20 --unsharp 0.5:2 --warp``; ``--highlights reconstruct`` and
``--stats``; ``--flat``, ``--dark``, ``--repair-hot-pixels``, ``--denoise``
and ``--hdr`` (several inputs) for the corrections; ``--ca
template|gradient|refine``, ``--save-params`` / ``--params`` (a JSON sidecar
of the fitted state) and ``--temperature``.
"""

from .colorimetry.transforms import (
    cam_to_clean_xyz,
    cam_to_lin_srgb,
    lin_srgb_to_oklab,
    lin_srgb_to_srgb,
    oklab_to_lin_srgb,
    srgb_to_lin_srgb,
)
from .colorimetry.wb import CameraWhiteBalanceController, controller_from_tags
from .const import BayerPattern, PatternDemosaic, QualityDemosaic
from .core.bayer import (
    bayer_to_planes,
    bayer_to_rgbg,
    planes_to_bayer,
    reversible_transform_rggb,
    rgbg_to_bayer,
)
from .core.frame import DevelopedImage, RawFrame, stack_frames
from .core.normalization import bayer_normalize
from .correct.bad_pixels import (
    find_erroneous_pixels_median,
    find_erroneous_pixels_threshold,
    find_shared_pixels,
    repair_bad_pixels,
)
from .correct.denoise import denoise_bayer_wavelet
from .correct.flat_field import (
    bias_frame_subtraction,
    dark_frame_subtraction,
    flat_frame_correction,
)
from .correct.hdr import fuse_exposures_from_debayer, fuse_exposures_to_raw
from .correct.ca.models import (
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
)
from .correct.ca.instability import compute_structural_instability
from .correct.ca.models import lensfun_poly3_remap_coords
from .correct.ca.removal import compute_ca_lens_models_for_raw, remove_ca_from_raw
from .correct.ca.gradfit import (
    fit_ca_models_gradient,
    fit_poly3_gradient,
    fit_radial_gradient,
    refine_ca_models_gradient,
)
from .demosaic import demosaic, demosaic_ahd, demosaic_draft, demosaic_eag
from .filters.blur import blur_gaussian
from .filters.sharpen import (
    gaussian_rt_deconvolution,
    gaussian_rt_deconvolution_lab,
    gaussian_rt_deconvolution_yuv,
    unsharp_mask_lab,
    unsharp_mask_per_channel,
)
from .io.image_out import save_image
from .io.metadata import (
    compute_ev,
    compute_ev_from_tiff,
    get_image_area_from_tiff,
    get_opcode_3_block,
    get_opcode_block,
)
from .io.raw_loader import frame_from_parts, load_raw, load_raw_dng
from .ops.resample import bilinear_sample, remap_bilinear, remap_lanczos4
from .pipeline.develop import (
    DevelopConfig,
    develop,
    develop_burst,
    develop_to_image,
    develop_with_stats,
)
from .pipeline.pipeline import PipelineConfig, develop_pipeline
from .warp.gain_opcodes import (
    GainMap,
    VignetteRadial,
    apply_gain_opcodes,
    encode_gain_map,
    encode_opcode_list,
    encode_vignette_radial,
)
from .warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear, stack_warp_prior
from .warp.rectilinear import (
    compute_offset_remapping_table,
    compute_remapping_table,
    warp_channel_rectilinear,
)

__version__ = "0.1.0"

__all__ = [
    "BayerPattern",
    "PatternDemosaic",
    "QualityDemosaic",
    "RawFrame",
    "DevelopedImage",
    "DevelopConfig",
    "PipelineConfig",
    "develop_pipeline",
    "stack_frames",
    "bayer_normalize",
    "bayer_to_planes",
    "bayer_to_rgbg",
    "planes_to_bayer",
    "reversible_transform_rggb",
    "rgbg_to_bayer",
    "cam_to_lin_srgb",
    "cam_to_clean_xyz",
    "lin_srgb_to_srgb",
    "srgb_to_lin_srgb",
    "lin_srgb_to_oklab",
    "oklab_to_lin_srgb",
    "CameraWhiteBalanceController",
    "controller_from_tags",
    "compute_ev",
    "compute_ev_from_tiff",
    "get_image_area_from_tiff",
    "get_opcode_3_block",
    "get_opcode_block",
    "find_erroneous_pixels_threshold",
    "find_erroneous_pixels_median",
    "find_shared_pixels",
    "repair_bad_pixels",
    "flat_frame_correction",
    "dark_frame_subtraction",
    "bias_frame_subtraction",
    "denoise_bayer_wavelet",
    "fuse_exposures_to_raw",
    "fuse_exposures_from_debayer",
    "Poly3CorrectionModel",
    "Poly5CorrectionModel",
    "PtLensCorrectionModel",
    "compute_structural_instability",
    "lensfun_poly3_remap_coords",
    "compute_ca_lens_models_for_raw",
    "remove_ca_from_raw",
    "demosaic",
    "demosaic_ahd",
    "demosaic_draft",
    "demosaic_eag",
    "develop",
    "develop_burst",
    "develop_to_image",
    "develop_with_stats",
    "frame_from_parts",
    "load_raw",
    "load_raw_dng",
    "save_image",
    "apply_opcode_3_warp",
    "apply_gain_opcodes",
    "GainMap",
    "VignetteRadial",
    "encode_gain_map",
    "encode_vignette_radial",
    "encode_opcode_list",
    "encode_warp_rectilinear",
    "stack_warp_prior",
    "compute_remapping_table",
    "compute_offset_remapping_table",
    "warp_channel_rectilinear",
    "remap_bilinear",
    "remap_lanczos4",
    "bilinear_sample",
    "blur_gaussian",
    "unsharp_mask_per_channel",
    "unsharp_mask_lab",
    "gaussian_rt_deconvolution",
    "gaussian_rt_deconvolution_lab",
    "gaussian_rt_deconvolution_yuv",
]
