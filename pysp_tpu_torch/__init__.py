"""pysp_tpu_torch — the PyTorch + CUDA port of pysp_tpu, for an NVIDIA H100.

Same module paths and function names as ``pysp_tpu``; plain PyTorch on
tensors, with hand-written CUDA kernels (``csrc/``) on the hot path, built with
``nvcc`` at first CUDA use. Importing the package imports neither JAX nor
``pysp_tpu``.

Canonical flow:

    from pysp_tpu_torch import load_raw, develop, DevelopConfig, QualityDemosaic
    frame = load_raw("shot.dng").to("cuda")
    srgb = develop(frame, DevelopConfig(quality=QualityDemosaic.Best))
    save_image("out.tif", srgb)
"""

from .const import BayerPattern, QualityDemosaic
from .core.frame import DevelopedImage, RawFrame
from .demosaic import demosaic
from .io.image_out import save_image
from .io.raw_loader import frame_from_parts, load_raw, load_raw_dng
from .pipeline.develop import DevelopConfig, develop, develop_burst, develop_to_image

__all__ = [
    "BayerPattern",
    "QualityDemosaic",
    "RawFrame",
    "DevelopedImage",
    "DevelopConfig",
    "demosaic",
    "develop",
    "develop_burst",
    "develop_to_image",
    "frame_from_parts",
    "load_raw",
    "load_raw_dng",
    "save_image",
]
