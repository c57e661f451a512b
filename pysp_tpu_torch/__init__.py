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

The command line: ``python -m pysp_tpu_torch develop shot.dng -o out.tif
--deconv 1.0:20 --unsharp 0.5:2 --warp``.
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
