"""The port's hand-written CUDA kernels for Hopper and their Python wrappers.

Two kernels, both CUDA C++ under ``pysp_tpu_torch/csrc/``:

- ``ahd.cu``: the whole AHD demosaic plus the optional develop colour tail,
  counterpart of ``pysp_tpu/ops/pallas_kernels.py::ahd_mega_pallas``;
- ``postprocess.cu``: one AHD chroma-median stage, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::postprocess_color_pallas_channels``.

At the first CUDA call the sources are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface under
``pysp_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source rebuilds), which is loaded with ``ctypes``. Kernels launch on
PyTorch's current stream and allocate nothing; the wrappers allocate outputs.

A wrapper given CPU tensors runs the kernel's plain PyTorch version instead;
given CUDA tensors it launches the kernel or raises. Each wrapper counts its
launches in a module-level integer (``ahd_kernel_launches``,
``postprocess_kernel_launches``), incremented only where the kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.phase_kernels import BayerPatternPosition, get_rgbg_kernel
from ..ops.stencil import GAUSSIAN3_SIGMA1

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("ahd.cu", "postprocess.cu")
_HEADERS = ("median5.cuh",)
# -fmad=false: no FMA contraction, so the kernels round where the plain
# PyTorch versions (separate multiply and add kernels) round.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# Chroma-median stages the AHD kernel takes (a template parameter in ahd.cu).
AHD_MAX_STAGES = 2

ahd_kernel_launches = 0
postprocess_kernel_launches = 0

# The loaded library and what its build printed; set by load_library().
_lib = None
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of pysp_tpu_torch are built at first use and need it"
        )
    return found


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpysp_kernels_{digest.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp,
               *(str(CSRC / s) for s in _SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}"
            )
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pysp_ahd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.pysp_ahd.restype = i32
    lib.pysp_postprocess_color.argtypes = [ptr] * 6 + [i32, i32, ptr]
    lib.pysp_postprocess_color.restype = i32
    _lib = lib
    return lib


def _check(t: Tensor, name: str, shape=None, device=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# --- AHD ------------------------------------------------------------------------

_F_TAIL, _F_CLIP, _F_GAMMA, _F_INTERLEAVED = 1, 2, 4, 8


def _ahd_constants() -> np.ndarray:
    """The host constants of the parameter block (layout: ahd.cu's P_* enum)."""
    from ..colorimetry.transforms import _CV2_LAB_WHITE, _CV2_RGB_TO_XYZ
    from ..demosaic.ahd import _H

    k_r = get_rgbg_kernel(BayerPatternPosition.TOP_LEFT)
    k_b = get_rgbg_kernel(BayerPatternPosition.BOTTOM_RIGHT)
    parts = [_H, GAUSSIAN3_SIGMA1, *k_r, *k_b, _CV2_RGB_TO_XYZ, _CV2_LAB_WHITE]
    return np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])


def _ahd_params(mat: Tensor, wb: Tensor) -> Tensor:
    consts = torch.from_numpy(_ahd_constants()).to(mat.device)
    return torch.cat([mat.reshape(9), wb.reshape(3), consts]).contiguous()


def ahd_kernel(
    bayer: Tensor, mat: Tensor, wb: Tensor, is_hdr: bool,
    postprocess_stages: int = 1, tail: tuple | None = None,
) -> Tensor:
    """AHD of a canonical-RGGB mosaic (H, W) with ``postprocess_stages``
    chroma-median stages, by the AHD kernel.

    ``mat`` is the cam->lin-sRGB matrix (3, 3), ``wb`` the reciprocal WB gains
    (3,). Without ``tail`` the result is the three demosaiced planes (3, H, W);
    with ``tail = (clip_highlights, gamma_encode)`` it is the developed image
    (H, W, 3) after develop's colour tail. Pixels within
    ``4 * postprocess_stages + 5`` of the border are computed from a replicate
    border of each CFA phase plane and are the caller's to overwrite (see
    ``demosaic.ahd_mega``). On CPU tensors the plain version runs instead over
    the whole frame."""
    global ahd_kernel_launches
    stages = max(int(postprocess_stages), 0)
    if bayer.device.type == "cpu":
        return ahd_plain(bayer, mat, wb, is_hdr, stages, tail)
    if stages > AHD_MAX_STAGES:
        raise ValueError(f"the AHD kernel takes 0..{AHD_MAX_STAGES} stages, got {stages}")
    if bayer.ndim != 2 or bayer.shape[0] % 2 or bayer.shape[1] % 2:
        raise ValueError(f"bayer must be (H, W) with H and W even, got {tuple(bayer.shape)}")
    mat, wb = mat.contiguous(), wb.contiguous()
    _check(bayer, "bayer")
    _check(mat, "mat", (3, 3), bayer.device)
    _check(wb, "wb", (3,), bayer.device)
    h, w = bayer.shape
    flags = 0
    if tail is not None:
        clip_highlights, gamma_encode = tail
        flags = _F_TAIL | _F_INTERLEAVED
        flags |= _F_CLIP if clip_highlights else 0
        flags |= _F_GAMMA if gamma_encode else 0
        out = torch.empty((h, w, 3), dtype=torch.float32, device=bayer.device)
    else:
        out = torch.empty((3, h, w), dtype=torch.float32, device=bayer.device)
    params = _ahd_params(mat, wb)
    lib = load_library()
    with torch.cuda.device(bayer.device):
        stream = torch.cuda.current_stream(bayer.device).cuda_stream
        err = lib.pysp_ahd(
            bayer.data_ptr(), params.data_ptr(), out.data_ptr(), h, w, stages,
            int(bool(is_hdr)), flags, stream,
        )
    _raise_on_error(err, "AHD kernel")
    ahd_kernel_launches += 1
    return out


def ahd_plain(bayer, mat, wb, is_hdr, stages, tail=None) -> Tensor:
    """The AHD kernel's plain version over the whole frame, in the kernel's
    output layout: ``demosaic.ahd.ahd_channels``, then develop's colour tail
    when ``tail`` is given."""
    from ..demosaic.ahd import ahd_channels
    from ..pipeline.develop import _color_tail_channels

    r, g, b = ahd_channels(bayer, mat, wb, is_hdr, stages)
    if tail is None:
        return torch.stack([r, g, b], dim=0)
    r, g, b = _color_tail_channels(r, g, b, mat, *tail)
    return torch.stack([r, g, b], dim=-1)


# --- chroma-median postprocess stage --------------------------------------------


def postprocess_color_kernel(r: Tensor, g: Tensor, b: Tensor):
    """One AHD chroma-median stage on (H, W) channels by the postprocess kernel;
    bit-identical to ``demosaic.ahd.postprocess_color_channels``, which runs
    instead on CPU tensors."""
    global postprocess_kernel_launches
    if r.device.type == "cpu":
        from ..demosaic.ahd import postprocess_color_channels

        return postprocess_color_channels(r, g, b)
    if r.ndim != 2:
        raise ValueError(f"channels must be (H, W), got {tuple(r.shape)}")
    _check(r, "r")
    _check(g, "g", r.shape, r.device)
    _check(b, "b", r.shape, r.device)
    h, w = r.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=r.device)
    lib = load_library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.pysp_postprocess_color(
            r.data_ptr(), g.data_ptr(), b.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), h, w, stream,
        )
    _raise_on_error(err, "postprocess kernel")
    postprocess_kernel_launches += 1
    return out[0], out[1], out[2]
