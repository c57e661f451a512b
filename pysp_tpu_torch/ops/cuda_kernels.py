"""The port's hand-written CUDA kernels for Hopper and their Python wrappers.

Eight kernels, all CUDA C++ under ``pysp_tpu_torch/csrc/``, one for every
function of the JAX package that reaches ``pl.pallas_call``:

- ``ahd.cu``: the whole AHD demosaic plus the optional develop colour tail,
  counterpart of ``pysp_tpu/ops/pallas_kernels.py::ahd_mega_pallas``;
- ``postprocess.cu``: one AHD chroma-median stage on three planes or on an
  (H, W, 3) image, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::postprocess_color_pallas_channels`` and
  ``postprocess_color_pallas``;
- ``rl.cu``: one Richardson-Lucy iteration over every channel, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::rl_deconv_pallas``;
- ``remap.cu``: the bilinear / Lanczos4 remap over every channel, counterpart
  of ``pysp_tpu/ops/pallas_kernels.py::remap_bounded_pallas``;
- ``heal.cu``: every sweep of the hot-pixel heal on the four CFA planes,
  counterpart of ``pysp_tpu/ops/pallas_kernels.py::masked_fill_pallas``;
- ``median5.cu``: the 5x5 median of a plane, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::median5_pallas``;
- ``homogeneity.cu``: one direction's AHD homogeneity count, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::homogeneity_map_pallas``;
- ``decision.cu``: the fused AHD direction pick, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::ahd_decision_pallas``.

At the first CUDA call the sources are compiled with ``nvcc`` for ``sm_90a``
(one process for each source, all at once) into one shared library with a
plain C interface under
``pysp_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source rebuilds), which is loaded with ``ctypes``. Kernels launch on
PyTorch's current stream and allocate nothing; the wrappers allocate outputs.

A wrapper given CPU tensors runs the kernel's plain PyTorch version instead;
given CUDA tensors it launches the kernel or raises. Each wrapper counts its
launches in a module-level integer (``ahd_kernel_launches``,
``postprocess_kernel_launches``, ``rl_kernel_launches``,
``remap_kernel_launches``, ``heal_kernel_launches``,
``median5_kernel_launches``, ``homogeneity_kernel_launches``,
``decision_kernel_launches``), incremented only where the kernel launches,
under a lock: the shards of ``parallel/`` launch from several threads.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
_SOURCES = ("ahd.cu", "postprocess.cu", "rl.cu", "remap.cu", "heal.cu", "median5.cu",
            "homogeneity.cu", "decision.cu")
_HEADERS = ("median5_columns.cuh", "ahd_lab.cuh", "tile_loops.cuh")
# -fmad=false: no FMA contraction, so the kernels round where the plain
# PyTorch versions (separate multiply and add kernels) round.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# Chroma-median stages the AHD kernel takes (a template parameter in ahd.cu).
AHD_MAX_STAGES = 2
# The AHD kernel's smallest frame side: the largest reach of one stage's border
# rule (3 px, the B plane's reflect-101 upsample) plus one.
AHD_MIN_SIDE = 4

# The RL kernel's largest PSF reach (taps // 2), as the JAX kernel's gate.
RL_MAX_REACH = 32
REMAP_KINDS = ("bilinear", "lanczos4")
# The heal kernel's largest fill + smooth sweep count, the JAX kernel's gate.
HEAL_MAX_SWEEPS = 8

ahd_kernel_launches = 0
postprocess_kernel_launches = 0
rl_kernel_launches = 0
remap_kernel_launches = 0
heal_kernel_launches = 0
median5_kernel_launches = 0
homogeneity_kernel_launches = 0
decision_kernel_launches = 0

# Shard threads (``parallel/shard.py``) launch at once: the counts and the
# first build are taken under these locks.
_count_lock = threading.Lock()
_load_lock = threading.Lock()


def _count_launch(kernel: str) -> None:
    """One more launch in ``<kernel>_kernel_launches``."""
    name = f"{kernel}_kernel_launches"
    with _count_lock:
        globals()[name] += 1


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


def _library_path(csrc: Path | None = None, flags=None) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode())
        digest.update((csrc / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS if flags is None else flags).encode())
    return BUILD_DIR / f"libpysp_kernels_{digest.hexdigest()[:16]}.so"


def build_library(csrc: Path | None = None, flags=None):
    """Compile the sources of ``csrc`` (default ``CSRC``) with ``flags``
    (default ``NVCC_FLAGS``) into the library that :func:`_library_path`
    names, unless it is there: one nvcc process for each source, all started
    together, then one link. Returns (path, the compilers' output, seconds)."""
    csrc = CSRC if csrc is None else Path(csrc)
    flags = NVCC_FLAGS if flags is None else tuple(flags)
    path = _library_path(csrc, flags)
    if path.exists():
        return path, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compile_flags = [f for f in flags if f != "-shared"]
        jobs = []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [_nvcc(), *compile_flags, f"-I{csrc}", "-c", "-o", obj, str(csrc / name)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{logs[-1]}")
        out = os.path.join(tmp, path.name)
        cmd = [_nvcc(), "-shared", "-o", out, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{logs[-1]}")
        os.replace(out, path)
    return path, "".join(logs), time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        path, log, seconds = build_library()
        if log:
            build_log, build_seconds = log, seconds
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pysp_ahd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.pysp_ahd.restype = i32
        lib.pysp_postprocess_color.argtypes = [ptr] * 6 + [i32, i32, ptr]
        lib.pysp_postprocess_color.restype = i32
        lib.pysp_postprocess_color_hwc.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.pysp_postprocess_color_hwc.restype = i32
        i64 = ctypes.c_longlong
        lib.pysp_rl_iter.argtypes = [ptr, ptr, ptr, i32, i32, i32, i64, i32,
                                     ctypes.POINTER(ctypes.c_float), i32, ptr]
        lib.pysp_rl_iter.restype = i32
        lib.pysp_remap.argtypes = [ptr] * 4 + [i32] * 3 + [i64, i32, i64] + [i32] * 6 + [ptr]
        lib.pysp_remap.restype = i32
        lib.pysp_heal.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        lib.pysp_heal.restype = i32
        lib.pysp_median5.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.pysp_median5.restype = i32
        lib.pysp_homogeneity.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.pysp_homogeneity.restype = i32
        lib.pysp_ahd_decision.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
        lib.pysp_ahd_decision.restype = i32
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


@functools.lru_cache(maxsize=None)
def _ahd_constants_on(device: torch.device) -> Tensor:
    """The host constants on ``device``: copied there once, not at every launch."""
    return torch.from_numpy(_ahd_constants()).to(device)


def _ahd_params(mat: Tensor, wb: Tensor) -> Tensor:
    return torch.cat([mat.reshape(9), wb.reshape(3), _ahd_constants_on(mat.device)]).contiguous()


def ahd_kernel_admits(shape, postprocess_stages: int) -> bool:
    """Whether the AHD kernel takes a mosaic of ``shape`` with this many
    chroma-median stages: (H, W) with H and W even and at least
    ``AHD_MIN_SIDE`` (4), and at most ``AHD_MAX_STAGES`` stages. The caller
    develops the rest by the staged route."""
    return (
        len(shape) == 2 and int(postprocess_stages) <= AHD_MAX_STAGES
        and all(n % 2 == 0 and n >= AHD_MIN_SIDE for n in shape)
    )


def ahd_kernel(
    bayer: Tensor, mat: Tensor, wb: Tensor, is_hdr: bool,
    postprocess_stages: int = 1, tail: tuple | None = None,
) -> Tensor:
    """AHD of a canonical-RGGB mosaic (H, W) with ``postprocess_stages``
    chroma-median stages, by the AHD kernel, one launch for the whole frame.

    ``mat`` is the cam->lin-sRGB matrix (3, 3), ``wb`` the reciprocal WB gains
    (3,). Without ``tail`` the result is the three demosaiced planes (3, H, W);
    with ``tail = (clip_highlights, gamma_encode)`` it is the developed image
    (H, W, 3) after develop's colour tail. Every pixel, the border's included,
    is the plain version's: the kernel applies each stage's border rule to
    that stage's own field. It differs from :func:`ahd_plain` only where
    ``cbrtf`` rounds CIELAB differently from the plain cube root and flips an
    H/V pick at an exact tie of the homogeneity sums. On CPU tensors the plain
    version runs instead. Raises for a mosaic outside
    :func:`ahd_kernel_admits`."""
    stages = max(int(postprocess_stages), 0)
    if bayer.device.type == "cpu":
        return ahd_plain(bayer, mat, wb, is_hdr, stages, tail)
    if stages > AHD_MAX_STAGES:
        raise ValueError(f"the AHD kernel takes 0..{AHD_MAX_STAGES} stages, got {stages}")
    if not ahd_kernel_admits(tuple(bayer.shape), stages):
        raise ValueError(
            f"bayer must be (H, W) with H and W even and at least {AHD_MIN_SIDE}, "
            f"got {tuple(bayer.shape)}"
        )
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
    _count_launch("ahd")
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
    _count_launch("postprocess")
    return out[0], out[1], out[2]


def postprocess_color_image_kernel(image: Tensor) -> Tensor:
    """One AHD chroma-median stage on a contiguous (H, W, 3) image by the
    postprocess kernel, which reads and writes the interleaved layout itself;
    returns (H, W, 3), bit-identical to ``demosaic.ahd.postprocess_color``'s
    plain stage, which runs instead on a CPU tensor."""
    if image.device.type == "cpu":
        from ..demosaic.ahd import postprocess_color

        return postprocess_color(image)
    if image.ndim != 3 or image.shape[-1] != 3 or image.numel() == 0:
        raise ValueError(f"image must be a non-empty (H, W, 3), got {tuple(image.shape)}")
    _check(image, "image")
    h, w, _ = image.shape
    out = torch.empty_like(image)
    lib = load_library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.pysp_postprocess_color_hwc(image.data_ptr(), out.data_ptr(), h, w, stream)
    _raise_on_error(err, "postprocess kernel")
    _count_launch("postprocess")
    return out


def _layout(t: Tensor, channels_last: bool):
    """(H, W, C, plane stride, pixel stride) of a contiguous (H, W), (C, H, W)
    or, with ``channels_last``, (H, W, C) tensor, in elements."""
    if t.ndim == 2:
        h, w = t.shape
        return h, w, 1, h * w, 1
    if t.ndim != 3:
        raise ValueError(f"image must be 2-D or 3-D, got {tuple(t.shape)}")
    if channels_last:
        h, w, c = t.shape
        return h, w, c, 1, c
    c, h, w = t.shape
    return h, w, c, h * w, 1


# --- Richardson-Lucy iteration ----------------------------------------------------


def rl_kernel_admits(shape, taps) -> bool:
    """Whether the RL kernel takes an (H, W) or (H, W, C) image of ``shape``
    with these 1-D taps: an odd count of at least 3 taps, reach (taps // 2) at
    most ``RL_MAX_REACH``, and H and W at least twice the reach, the gate of
    the JAX package's kernel. The caller runs the plain loop for the rest."""
    n = len(np.asarray(taps).reshape(-1))
    reach = n // 2
    return (
        len(shape) in (2, 3) and n >= 3 and n % 2 == 1 and reach <= RL_MAX_REACH
        and shape[0] >= 2 * reach and shape[1] >= 2 * reach
    )


def rl_kernel(image: Tensor, taps, iterations: int) -> Tensor:
    """``iterations`` Richardson-Lucy iterations with the separable symmetric
    PSF ``taps`` on an (H, W) or (H, W, C) float32 image, starting from the
    image, by the RL kernel: one launch per iteration over every channel, the
    estimate in two buffers that take turns. Equal to :func:`rl_plain`, which
    runs instead on CPU tensors. Raises for an image outside
    :func:`rl_kernel_admits`."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    if image.device.type == "cpu":
        return rl_plain(image, taps, iterations)
    if not rl_kernel_admits(tuple(image.shape), taps):
        raise ValueError(
            f"the RL kernel does not take {len(taps)} taps on {tuple(image.shape)} "
            f"(odd taps, reach <= {RL_MAX_REACH}, H and W >= 2 * reach)"
        )
    image = image.contiguous()
    _check(image, "image")
    h, w, c, plane, pix = _layout(image, channels_last=True)
    host_taps = (ctypes.c_float * len(taps))(*taps.tolist())
    bufs = (torch.empty_like(image), torch.empty_like(image))
    lib = load_library()
    est = image
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        for it in range(int(iterations)):
            out = bufs[it % 2]
            err = lib.pysp_rl_iter(
                est.data_ptr(), image.data_ptr(), out.data_ptr(), h, w, c, plane, pix,
                host_taps, len(taps), stream,
            )
            _raise_on_error(err, "RL kernel")
            _count_launch("rl")
            est = out
    return est


def rl_plain(image: Tensor, taps, iterations: int) -> Tensor:
    """The RL kernel's plain version, the JAX package's loop:
    ``est <- est * blur(image / (blur(est) + 1e-25))`` with the separable blur
    of ``filters.blur.blur_taps`` (symmetric border)."""
    from ..filters.blur import blur_taps

    taps = np.asarray(taps, np.float32).reshape(-1)
    est = image
    for _ in range(int(iterations)):
        blurred = blur_taps(est, taps)
        est = est * blur_taps(image / (blurred + 1e-25), taps)
    return est


# --- remap ------------------------------------------------------------------------


def _check_remap_args(img, map_x, map_y, kind, bounds, channels_last):
    if kind not in REMAP_KINDS:
        raise ValueError(f"remap kind must be one of {REMAP_KINDS}, got {kind!r}")
    if map_x.shape != map_y.shape or map_x.ndim not in (2, 3):
        raise ValueError(
            f"maps must be (H, W) or (C, H, W) and alike, got {tuple(map_x.shape)} "
            f"and {tuple(map_y.shape)}"
        )
    if channels_last and img.ndim != 3:
        raise ValueError(f"a channels-last image must be (H, W, C), got {tuple(img.shape)}")
    h, w, c = _layout(img, channels_last)[:3]
    if tuple(map_x.shape[-2:]) != (h, w):
        raise ValueError(f"maps {tuple(map_x.shape)} do not fit the image {tuple(img.shape)}")
    if map_x.ndim == 3 and (img.ndim != 3 or map_x.shape[0] != c):
        raise ValueError(
            f"per-channel maps {tuple(map_x.shape)} need an image with "
            f"{map_x.shape[0]} channels, got {tuple(img.shape)}"
        )
    if bounds is not None and any(int(lo) > int(hi) for lo, hi in bounds):
        raise ValueError(f"bounds must be ((dy0, dy1), (dx0, dx1)) with lo <= hi, got {bounds}")


def remap_kernel(
    img: Tensor, map_x: Tensor, map_y: Tensor, kind: str = "bilinear",
    bounds=None, channels_last: bool = False,
) -> Tensor:
    """Remap ``img`` by the remap kernel, one launch over every channel.

    ``img`` is an (H, W) plane, a (C, H, W) stack or, with ``channels_last``,
    an (H, W, C) image, and the result has its layout. The maps are float32
    (H, W), shared by the channels, or (C, H, W), one per channel. ``kind`` is
    "bilinear" or "lanczos4". ``bounds = ((dy0, dy1), (dx0, dx1))`` clips each
    floor displacement from the identity grid into them first (the bounded
    remap); None is the plain gather. Bilinear is bit-identical to
    :func:`remap_plain`, which runs instead on CPU tensors; Lanczos4 takes an
    axis's weights from one ``sinf`` and one ``sincosf`` (``csrc/remap.cu``)
    and is within 5e-6 of it on images in [0, 1]."""
    _check_remap_args(img, map_x, map_y, kind, bounds, channels_last)
    if img.device.type == "cpu":
        return remap_plain(img, map_x, map_y, kind, bounds, channels_last)
    img, map_x, map_y = img.contiguous(), map_x.contiguous(), map_y.contiguous()
    _check(img, "img")
    _check(map_x, "map_x", device=img.device)
    _check(map_y, "map_y", device=img.device)
    h, w, c, plane, pix = _layout(img, channels_last)
    map_plane = h * w if map_x.ndim == 3 else 0
    (dy0, dy1), (dx0, dx1) = bounds if bounds is not None else ((0, 0), (0, 0))
    out = torch.empty_like(img)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.pysp_remap(
            img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(),
            h, w, c, plane, pix, map_plane, REMAP_KINDS.index(kind),
            int(bounds is not None), int(dy0), int(dy1), int(dx0), int(dx1), stream,
        )
    _raise_on_error(err, "remap kernel")
    _count_launch("remap")
    return out


def remap_plain(
    img: Tensor, map_x: Tensor, map_y: Tensor, kind: str = "bilinear",
    bounds=None, channels_last: bool = False,
) -> Tensor:
    """The remap kernel's plain version: ``ops.resample``'s gather remaps
    (``remap_at_bounds`` with bounds), plane by plane where the maps are per
    channel."""
    from .resample import remap_at_bounds, remap_bilinear, remap_lanczos4

    _check_remap_args(img, map_x, map_y, kind, bounds, channels_last)

    def one(planes, mx, my):
        if bounds is not None:
            return remap_at_bounds(planes, mx, my, bounds[0], bounds[1], kind)
        return (remap_lanczos4 if kind == "lanczos4" else remap_bilinear)(planes, mx, my)

    planes = img.movedim(-1, 0) if channels_last else img
    if map_x.ndim == 3:
        out = torch.stack([one(planes[k], map_x[k], map_y[k]) for k in range(map_x.shape[0])])
    else:
        out = one(planes, map_x, map_y)
    return out.movedim(0, -1).contiguous() if channels_last else out


# --- hot-pixel heal ---------------------------------------------------------------


def heal_kernel_admits(fill_iterations: int, smooth_iterations: int) -> bool:
    """Whether the heal kernel takes these sweep counts: none negative and at
    most ``HEAL_MAX_SWEEPS`` in all, the JAX kernel's iteration gate. Any
    plane size goes. The caller runs the dense fill for the rest."""
    fill, smooth = int(fill_iterations), int(smooth_iterations)
    return fill >= 0 and smooth >= 0 and fill + smooth <= HEAL_MAX_SWEEPS


def heal_kernel(planes: Tensor, masks: Tensor, fill_iterations: int = 4,
                smooth_iterations: int = 2) -> Tensor:
    """Heal the masked sites of the four CFA planes (4, H/2, W/2) float32 by
    the heal kernel, one launch for every sweep of every plane; ``masks`` is
    bool of the same shape. Bit-identical to :func:`heal_plain`, which runs
    instead on CPU tensors. Raises for sweep counts outside
    :func:`heal_kernel_admits`."""
    if planes.device.type == "cpu":
        return heal_plain(planes, masks, fill_iterations, smooth_iterations)
    if not heal_kernel_admits(fill_iterations, smooth_iterations):
        raise ValueError(
            f"the heal kernel takes at most {HEAL_MAX_SWEEPS} sweeps in all, got "
            f"{fill_iterations} fill and {smooth_iterations} smooth"
        )
    if planes.ndim != 3 or planes.shape[0] != 4:
        raise ValueError(f"planes must be (4, H, W), got {tuple(planes.shape)}")
    planes, masks = planes.contiguous(), masks.contiguous()
    _check(planes, "planes")
    # The seeds of unreached sites, taken as heal_plain takes them; launched
    # before the masks' checks, which then run while the card computes them.
    means = planes.mean(dim=(-2, -1)).contiguous()
    if masks.dtype != torch.bool:
        raise TypeError(f"masks must be bool, got {masks.dtype}")
    if masks.device != planes.device or masks.shape != planes.shape:
        raise ValueError(
            f"masks must be {tuple(planes.shape)} on {planes.device}, got "
            f"{tuple(masks.shape)} on {masks.device}"
        )
    _, h, w = planes.shape
    out = torch.empty_like(planes)
    lib = load_library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.pysp_heal(
            planes.data_ptr(), masks.data_ptr(), means.data_ptr(), out.data_ptr(),
            h, w, int(fill_iterations), int(smooth_iterations), stream,
        )
    _raise_on_error(err, "heal kernel")
    _count_launch("heal")
    return out


def heal_plain(planes: Tensor, masks: Tensor, fill_iterations: int = 4,
               smooth_iterations: int = 2) -> Tensor:
    """The heal kernel's plain version: ``correct.bad_pixels.masked_fill_inpaint``."""
    from ..correct.bad_pixels import masked_fill_inpaint

    return masked_fill_inpaint(planes, masks, fill_iterations, smooth_iterations)


# --- the staged AHD route: median, homogeneity count, direction pick ------------------


def median5_kernel(x: Tensor) -> Tensor:
    """5x5 median of an (H, W) float32 plane with a replicate border
    (``cv2.medianBlur(src, 5)``) by the median kernel; bit-identical to
    ``ops.stencil.median5``, which runs instead on a CPU tensor. Any H and W of
    at least 1 go."""
    if x.device.type == "cpu":
        from .stencil import median5

        return median5(x)
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (H, W) plane, got {tuple(x.shape)}")
    _check(x, "x")
    h, w = x.shape
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pysp_median5(x.data_ptr(), out.data_ptr(), h, w, stream)
    _raise_on_error(err, "median5 kernel")
    _count_launch("median5")
    return out


def homogeneity_kernel(lum: Tensor, a: Tensor, b: Tensor, is_vertical: bool) -> Tensor:
    """One direction's AHD homogeneity count (3x3 window, symmetric border,
    values 3..9) on (H, W) float32 L, a, b planes by the homogeneity kernel;
    bit-identical to ``demosaic.homogeneity.homogeneity_map_channels``, which
    runs instead on CPU tensors."""
    if lum.device.type == "cpu":
        from ..demosaic.homogeneity import homogeneity_map_channels

        return homogeneity_map_channels(lum, a, b, is_vertical)
    if lum.ndim != 2 or lum.numel() == 0:
        raise ValueError(f"planes must be non-empty (H, W), got {tuple(lum.shape)}")
    _check(lum, "lum")
    _check(a, "a", lum.shape, lum.device)
    _check(b, "b", lum.shape, lum.device)
    h, w = lum.shape
    out = torch.empty_like(lum)
    lib = load_library()
    with torch.cuda.device(lum.device):
        stream = torch.cuda.current_stream(lum.device).cuda_stream
        err = lib.pysp_homogeneity(
            lum.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), h, w,
            int(bool(is_vertical)), stream,
        )
    _raise_on_error(err, "homogeneity kernel")
    _count_launch("homogeneity")
    return out


def decision_kernel(
    r_h: Tensor, g_h: Tensor, b_h: Tensor, r_v: Tensor, g_v: Tensor, b_v: Tensor,
    mat: Tensor, wb: Tensor, is_hdr: bool,
) -> Tensor:
    """The AHD direction pick from the six candidate fields (H, W) float32, by
    the decision kernel: 1.0 where the box-summed homogeneity of the horizontal
    candidate is below the vertical one's, else 0.0.

    ``mat`` is the cam->lin-sRGB matrix (3, 3), ``wb`` the reciprocal WB gains
    (3,). H and W must be at least 2 (the box sum's reflect-101 border). Equal
    to ``demosaic.ahd.ahd_decision_plain``, which runs instead on CPU tensors,
    except where the two sums tie and ``cbrtf`` rounds CIELAB differently from
    the plain cube root."""
    fields = (r_h, g_h, b_h, r_v, g_v, b_v)
    if r_h.device.type == "cpu":
        from ..demosaic.ahd import ahd_decision_plain

        return ahd_decision_plain(*fields, mat, wb, is_hdr)
    if r_h.ndim != 2 or min(r_h.shape) < 2:
        raise ValueError(f"fields must be (H, W) with H, W >= 2, got {tuple(r_h.shape)}")
    mat, wb = mat.contiguous(), wb.contiguous()
    for name, f in zip(("r_h", "g_h", "b_h", "r_v", "g_v", "b_v"), fields):
        _check(f, name, r_h.shape, r_h.device)
    _check(mat, "mat", (3, 3), r_h.device)
    _check(wb, "wb", (3,), r_h.device)
    h, w = r_h.shape
    params = _ahd_params(mat, wb)
    out = torch.empty_like(r_h)
    lib = load_library()
    with torch.cuda.device(r_h.device):
        stream = torch.cuda.current_stream(r_h.device).cuda_stream
        err = lib.pysp_ahd_decision(
            *(f.data_ptr() for f in fields), params.data_ptr(), out.data_ptr(), h, w,
            int(bool(is_hdr)), stream,
        )
    _raise_on_error(err, "decision kernel")
    _count_launch("decision")
    return out
