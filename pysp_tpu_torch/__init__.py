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
    save_image("out.png", srgb)

``load_raw`` reads DNGs (uncompressed or lossless JPEG) and CR2, MRW, RAF,
ARW, ORF, RW2, PEF, SRW and NEF files with built-in decoders on the host (the
native ones compiled with ``g++`` at first use), then rawpy where it imports;
each format also has its own ``load_raw_<format>``. A dual-illuminant DNG's
calibration rows are harvested into a persistent camera-matrix cache
(``$PYSP_TPU_MATRIX_CACHE``, else ``~/.cache/pysp_tpu/``) that the other
formats' loads of the same body read; ``register_camera_matrices`` adds a body
by hand.

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

Many files: ``develop_files(paths, out_dir)`` (or ``develop_stream(paths)``,
which yields the images) overlaps the host decode, the copies to and from the
card and the develop on their own CUDA streams, and the saves;
``load_burst(paths)`` decodes a burst in threads and stacks it.
``pysp_tpu_torch.compat`` has the reference's class API
(``RawBayerDataFromRaw(path).demosaic(QualityDemosaic.Best).to_lin_srgb()``).

Several devices, or several shards on one card: a ('batch', 'spatial') mesh
driven from one process, one thread a shard. ``develop_burst_sharded``
splits a burst's frames over 'batch', ``develop_spatial`` one frame's rows
over 'spatial' with a halo exchange, ``develop_burst_spatial`` both;
``parallel.pipeline_sharded`` and ``parallel.spatial_pipeline`` run the
corrections, CA and warp under the mesh too:

    mesh = make_mesh((1, 4))                   # the visible cards; raises without one
    mesh = make_mesh((1, 4), ["cuda:0"] * 4)   # four shards on one card
    srgb = develop_spatial(frame, DevelopConfig(), mesh)

The command line: ``python -m pysp_tpu_torch develop shot.cr2 -o out.png
--deconv 1.0:20 --unsharp 0.5:2 --warp``; ``--bit-depth 16``;
``--highlights reconstruct`` and
``--stats``; several inputs (streamed into ``-o DIR``); ``--flat``,
``--dark``, ``--repair-hot-pixels``, ``--denoise`` and ``--hdr`` (several
inputs fused) for the corrections; ``--ca
template|gradient|refine``, ``--save-params`` / ``--params`` (a JSON sidecar
of the fitted state) and ``--temperature``; the ``info``, ``harvest`` and
``verify-decode`` subcommands.
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
from .io.arw import load_raw_arw
from .io.camera_matrices import register_camera_matrices
from .io.cr2 import load_raw_cr2
from .io.cr3 import cr3_info
from .io.image_out import save_image
from .io.metadata import (
    compute_ev,
    compute_ev_from_tiff,
    get_image_area_from_tiff,
    get_opcode_3_block,
    get_opcode_block,
)
from .io.mrw import load_raw_mrw
from .io.nef import load_raw_nef
from .io.orf import load_raw_orf
from .io.pef import load_raw_pef
from .io.raf import load_raw_raf
from .io.raw_loader import frame_from_parts, load_burst, load_raw, load_raw_dng
from .io.rw2 import load_raw_rw2
from .io.srw import load_raw_srw
from .ops.resample import bilinear_sample, remap_bilinear, remap_lanczos4
from .parallel.mesh import make_mesh
from .parallel.spatial import (
    develop_burst_sharded,
    develop_burst_spatial,
    develop_spatial,
)
from .pipeline.develop import (
    DevelopConfig,
    develop,
    develop_burst,
    develop_to_image,
    develop_with_stats,
)
from .pipeline.pipeline import PipelineConfig, develop_pipeline
from .pipeline.stream import develop_files, develop_stream
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
    "develop_files",
    "develop_stream",
    "make_mesh",
    "develop_spatial",
    "develop_burst_sharded",
    "develop_burst_spatial",
    "frame_from_parts",
    "load_burst",
    "load_raw",
    "load_raw_dng",
    "load_raw_arw",
    "load_raw_cr2",
    "load_raw_nef",
    "load_raw_orf",
    "cr3_info",
    "load_raw_mrw",
    "load_raw_pef",
    "load_raw_srw",
    "load_raw_raf",
    "load_raw_rw2",
    "register_camera_matrices",
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
