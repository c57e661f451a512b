"""The port's hand-written CUDA kernels for Hopper and their Python wrappers.

Ten kernel sources, all CUDA C++ under ``pysp_tpu_torch/csrc/``: one for every
function of the JAX package that reaches ``pl.pallas_call``,

- ``ahd.cu``: the whole AHD demosaic plus the optional develop colour tail,
  counterpart of ``pysp_tpu/ops/pallas_kernels.py::ahd_mega_pallas``;
- ``postprocess.cu``: one AHD chroma-median stage on three planes or on an
  (H, W, 3) image, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::postprocess_color_pallas_channels`` and
  ``postprocess_color_pallas``;
- ``rl.cu``: one Richardson-Lucy iteration over every channel, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::rl_deconv_pallas``;
- ``remap.cu``: the bilinear / Lanczos4 remap over every channel, counterpart
  of ``pysp_tpu/ops/pallas_kernels.py::remap_bounded_pallas``, and its radial
  kind (``remap_radial_kernel``), the bilinear remap through a radial CA
  model's coordinates computed in the kernel, which has no Pallas
  counterpart (the JAX package builds those maps in XLA);
- ``heal.cu``: every sweep of the hot-pixel heal on the four CFA planes,
  counterpart of ``pysp_tpu/ops/pallas_kernels.py::masked_fill_pallas``;
- ``median5.cu``: the 5x5 median of a plane, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::median5_pallas``;
- ``homogeneity.cu``: one direction's AHD homogeneity count, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::homogeneity_map_pallas``;
- ``decision.cu``: the fused AHD direction pick, counterpart of
  ``pysp_tpu/ops/pallas_kernels.py::ahd_decision_pallas``;

and two without a Pallas counterpart:

- ``multisection.cu``: one pass of the hot-pixel detector's count
  multisection, with the narrowing of the bracket after it
  (``correct.bad_pixels._bisect_quantile``);
- ``eag_resample.cu``: the EAG resamples of CA removal, the full-resolution
  green fill (``eag_fill_kernel``) and a channel's upsample with the green's
  high frequencies (``eag_upsample_kernel``), each one launch over a burst.

At the first CUDA call the sources are compiled with ``nvcc`` for ``sm_90a``
(one process for each source, all at once) into one shared library with a
plain C interface under
``pysp_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source rebuilds), which is loaded with ``ctypes``. Kernels launch on
PyTorch's current stream and allocate nothing; the wrappers allocate outputs.

A wrapper given CPU tensors runs the kernel's plain PyTorch version instead;
given CUDA tensors it checks them and launches the kernel through
:func:`_launch` or raises. ``_ENTRIES`` names each C entry of the library
with its ctypes arguments and the launch counter it adds to. The counters are
the dict ``launch_counts`` (``{"ahd": n, "postprocess": n, ...}``),
incremented only where a kernel launches, under a lock: the shards of
``parallel/`` launch from several threads. Read them through
``utils.tracing.counters()``, which hands each back as
``kernels.<name>.launches``, with the recorder's own counters; a build of the
library is the span ``kernels.build`` and counts in ``kernels.builds``.
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
from ..utils.tracing import count, span

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("ahd.cu", "postprocess.cu", "rl.cu", "remap.cu", "heal.cu", "median5.cu",
            "homogeneity.cu", "decision.cu", "multisection.cu", "eag_resample.cu")
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
# The radial forms whose coordinates the remap kernel computes itself, in the
# order of remap.cu's RadialForm, with the count of float32 constants each
# takes (a model's ``kernel_form()``, correct/ca/models.py).
RADIAL_FORMS = {"poly3": 3, "poly5": 4, "ptlens": 6}
RADIAL_NEWTON_STEPS = 8
# The heal kernel's largest fill + smooth sweep count, the JAX kernel's gate.
HEAL_MAX_SWEEPS = 8
# The multisection kernel's most branches a pass (its counters a thread).
MULTISECTION_MAX_BRANCHES = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOATS = ctypes.POINTER(ctypes.c_float)
# Each C entry of the library: the launch counter it adds to, its name in a
# launch error, and its arguments before the last one, the CUDA stream. Every
# entry returns a cudaError.
_ENTRIES = {
    "pysp_ahd": ("ahd", "AHD kernel", (_P, _P, _P, _I, _I, _I, _I, _I)),
    "pysp_postprocess_color": ("postprocess", "postprocess kernel", (_P,) * 6 + (_I, _I)),
    "pysp_postprocess_color_hwc": ("postprocess", "postprocess kernel", (_P, _P, _I, _I)),
    "pysp_rl_iter": ("rl", "RL kernel", (_P, _P, _P, _I, _I, _I, _L, _I, _FLOATS, _I)),
    "pysp_remap": ("remap", "remap kernel", (_P,) * 4 + (_I,) * 3 + (_L, _I, _L) + (_I,) * 6),
    "pysp_remap_radial": ("remap", "radial remap kernel",
                          (_P, _P, _I, _I, _I, _L, _I, _I, _FLOATS)),
    "pysp_heal": ("heal", "heal kernel", (_P,) * 4 + (_I,) * 4),
    "pysp_median5": ("median5", "median5 kernel", (_P, _P, _I, _I)),
    "pysp_homogeneity": ("homogeneity", "homogeneity kernel", (_P,) * 4 + (_I,) * 3),
    "pysp_ahd_decision": ("decision", "decision kernel", (_P,) * 8 + (_I,) * 3),
    "pysp_multisection": ("multisection", "multisection kernel",
                          (_P, _I, _I, _L, _P, _P, _P, _I, ctypes.c_float, _I)),
    "pysp_eag_fill": ("eag_resample", "EAG fill kernel", (_P,) * 3 + (_I,) * 3 + (_L,) * 3 + (_I,)),
    "pysp_eag_upsample": ("eag_resample", "EAG upsample kernel",
                          (_P,) * 3 + (_I,) * 4 + (_FLOATS,)),
}
# Launches of each kernel since the process started, every kernel's key from
# the start.
launch_counts = {counter: 0 for counter, _, _ in _ENTRIES.values()}

# Shard threads (``parallel/shard.py``) launch at once: the counts and the
# first build are taken under these locks.
_count_lock = threading.Lock()
_load_lock = threading.Lock()


def _count_launch(kernel: str) -> None:
    """One more launch in ``launch_counts[kernel]``."""
    with _count_lock:
        launch_counts[kernel] += 1


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
    with span("kernels.build"):
        out = _build(csrc, flags, path)
    count("kernels.builds")
    return out


def _build(csrc: Path, flags: tuple, path: Path):
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
        for entry, (_, _, argtypes) in _ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = [*argtypes, _P]
            fn.restype = _I
        _lib = lib
        return lib


def _check(t: Tensor, name: str, shape=None, device=None, contiguous=True) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, device: torch.device, *calls: tuple) -> None:
    """Launch the C entry ``entry`` once for each tuple of arguments in
    ``calls``, in turn, on ``device``'s current stream; raises at the first
    launch that fails and counts each launch."""
    kernel, what, _ = _ENTRIES[entry]
    fn = getattr(load_library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for args in calls:
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"{what} launch failed: cudaError {err}")
            _count_launch(kernel)


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
    _launch("pysp_ahd", bayer.device, (bayer.data_ptr(), params.data_ptr(), out.data_ptr(),
                                       h, w, stages, int(bool(is_hdr)), flags))
    return out


def ahd_plain(bayer, mat, wb, is_hdr, stages, tail=None) -> Tensor:
    """The AHD kernel's plain version over the whole frame, in the kernel's
    output layout: ``demosaic.ahd.ahd_channels``, then develop's colour tail
    when ``tail`` is given."""
    from ..colorimetry.transforms import color_tail_channels
    from ..demosaic.ahd import ahd_channels

    r, g, b = ahd_channels(bayer, mat, wb, is_hdr, stages)
    if tail is None:
        return torch.stack([r, g, b], dim=0)
    r, g, b = color_tail_channels(r, g, b, mat, *tail)
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
    _launch("pysp_postprocess_color", r.device, (
        r.data_ptr(), g.data_ptr(), b.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), h, w))
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
    _launch("pysp_postprocess_color_hwc", image.device, (image.data_ptr(), out.data_ptr(), h, w))
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
    # the estimate in two buffers that take turns, from the image
    ests = [image] + [bufs[it % 2] for it in range(int(iterations))]
    _launch("pysp_rl_iter", image.device, *(
        (est.data_ptr(), image.data_ptr(), out.data_ptr(), h, w, c, plane, pix, host_taps,
         len(taps)) for est, out in zip(ests, ests[1:])))
    return ests[-1]


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
    _launch("pysp_remap", img.device, (
        img.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(),
        h, w, c, plane, pix, map_plane, REMAP_KINDS.index(kind),
        int(bounds is not None), int(dy0), int(dy1), int(dx0), int(dx1)))
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


def _check_radial_form(form) -> None:
    kind, constants = form
    if kind not in RADIAL_FORMS or len(constants) != RADIAL_FORMS[kind]:
        raise ValueError(f"a radial form is one of {RADIAL_FORMS} with as many constants, "
                         f"got {form!r}")


def _radial_params(form, h: int, w: int) -> np.ndarray:
    """The radial kernel's host parameters: cy, cx and 1 / r_corner as the
    plain maps round them on the card (PyTorch there divides a float32 tensor
    by a Python scalar as a multiply by the float32 rounding of the scalar's
    reciprocal, taken in double), then the form's constants, padded to six."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    params = np.zeros(9, np.float32)
    params[:3] = cy, cx, 1.0 / float(np.hypot(cy, cx))
    constants = np.asarray(form[1], np.float32)
    params[3:3 + constants.size] = constants
    return params


def radial_plain(form, u: Tensor) -> Tensor:
    """f(u) of a radial form from its float32 constants, in the kernel's order
    of operations (``radial_f`` in ``csrc/remap.cu``)."""
    kind, c = form[0], [float(v) for v in form[1]]
    if kind == "poly3":
        return u * u * u * c[0] + u * c[1]
    if kind == "poly5":
        r2 = u * u
        return u * (r2 * (r2 * c[1] + c[0]) + 1.0)
    return u * (u * (u * (u * c[0] + c[1]) + c[2]) + c[3])


def radial_prime_plain(form, u: Tensor) -> Tensor:
    """f'(u) of a radial form, in the kernel's order (``radial_df``)."""
    kind, c = form[0], [float(v) for v in form[1]]
    if kind == "poly3":
        return u * u * c[2] + c[1]
    if kind == "poly5":
        r2 = u * u
        return r2 * (r2 * c[3] + c[2]) + 1.0
    return u * (u * (u * 4.0 * c[0] + c[4]) + c[5]) + c[3]


def radial_inverse_plain(form, r: Tensor) -> Tensor:
    """u with f(u) = r: RADIAL_NEWTON_STEPS Newton steps from zero, no early
    exit."""
    u = torch.zeros_like(r)
    for _ in range(RADIAL_NEWTON_STEPS):
        u = u - (radial_plain(form, u) - r) / radial_prime_plain(form, u)
    return u


def radial_maps_plain(form, inverse: bool, h: int, w: int, device) -> tuple:
    """The clipped (map_x, map_y) of a radial form on an (h, w) frame, in the
    radial kernel's order of operations; on the card they equal
    ``_maps_from_offsets(model.get_*_coordinates(...))`` of the model that
    gave the form."""
    _check_radial_form(form)
    cy, cx, inv_r_corner = (float(v) for v in _radial_params(form, h, w)[:3])
    ys = (torch.arange(h, dtype=torch.float32, device=device) - cy)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=device) - cx)[None, :]
    # the kernel's square root is IEEE's, as the card's float32 torch.sqrt;
    # the CPU's vectorised one is not always: take it in double and round
    r = torch.sqrt((ys * ys + xs * xs).double()).float() * inv_r_corner
    centre = r == 0
    r_safe = torch.where(centre, torch.ones_like(r), r)
    u = (radial_inverse_plain if inverse else radial_plain)(form, r_safe)
    scale = torch.where(centre, torch.ones_like(r), u / r_safe)
    map_x = torch.clamp(xs * scale + cx, 0, w - 1)
    map_y = torch.clamp(ys * scale + cy, 0, h - 1)
    return map_x.contiguous(), map_y.contiguous()


def remap_radial_kernel(img: Tensor, form, inverse: bool) -> Tensor:
    """The bilinear remap of an (H, W) plane or a (C, H, W) stack through a
    radial model's clipped maps, which the kernel computes itself (one launch,
    the coordinates shared by the channels): ``form`` is a model's
    ``kernel_form()``, ``(kind, float32 constants)``, and ``inverse`` takes
    its Newton inverse. On the card it is bit-identical to
    ``remap_kernel(img, *_maps_from_offsets(model.get_*_coordinates(...)),
    "bilinear")``. CPU tensors run :func:`remap_radial_plain`."""
    _check_radial_form(form)
    if img.ndim not in (2, 3):
        raise ValueError(f"image must be (H, W) or (C, H, W), got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return remap_radial_plain(img, form, inverse)
    img = img.contiguous()
    _check(img, "img")
    h, w, c, plane, _ = _layout(img, False)
    params = _radial_params(form, h, w)
    out = torch.empty_like(img)
    _launch("pysp_remap_radial", img.device, (
        img.data_ptr(), out.data_ptr(), h, w, c, plane, list(RADIAL_FORMS).index(form[0]),
        int(bool(inverse)), params.ctypes.data_as(_FLOATS)))
    return out


def remap_radial_plain(img: Tensor, form, inverse: bool) -> Tensor:
    """The radial remap's plain version: :func:`radial_maps_plain`, then
    :func:`remap_plain`."""
    h, w = img.shape[-2:]
    return remap_plain(img, *radial_maps_plain(form, inverse, h, w, img.device), "bilinear")


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
    _launch("pysp_heal", planes.device, (
        planes.data_ptr(), masks.data_ptr(), means.data_ptr(), out.data_ptr(),
        h, w, int(fill_iterations), int(smooth_iterations)))
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
    _launch("pysp_median5", x.device, (x.data_ptr(), out.data_ptr(), h, w))
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
    _launch("pysp_homogeneity", lum.device, (
        lum.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), h, w,
        int(bool(is_vertical))))
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
    _launch("pysp_ahd_decision", r_h.device, (
        *(f.data_ptr() for f in fields), params.data_ptr(), out.data_ptr(), h, w,
        int(bool(is_hdr))))
    return out


# --- the hot-pixel detector's count multisection ---------------------------------------


def multisection_kernel_admits(delta: Tensor, branches: int) -> bool:
    """Whether the multisection kernel takes ``delta`` with this many branches
    a pass: (P, H, W) float32, at most 65535 planes of fewer than 2**31
    samples, and 1 to ``MULTISECTION_MAX_BRANCHES`` branches. The caller runs
    the plain passes for the rest."""
    if delta.ndim != 3 or delta.dtype != torch.float32:
        return False
    p, h, w = delta.shape
    return 1 <= p <= 65535 and 0 < h * w < 2**31 and 1 <= int(branches) <= MULTISECTION_MAX_BRANCHES


def multisection_kernel(delta: Tensor, lo: Tensor, hi: Tensor, target: float, iters: int = 4,
                        branches: int = 16, psum_counts=None):
    """``iters`` passes of the hot-pixel detector's count multisection on the
    (P, H, W) float32 planes ``delta``, from the bracket ``lo``, ``hi`` (P,)
    toward the rank ``target``; returns the last bracket (lo, hi).

    On CUDA planes each pass is one launch of the multisection kernel, which
    reads each plane in place (a row slice of a stack included). Without
    ``psum_counts`` the kernel also narrows the bracket: the passes share one
    zeroed count buffer, the bracket stays on the card and nothing waits for
    the host. With it (the shards of a row-sharded frame) each launch only
    counts, for ``multisection_plain``'s loop, which sums the int32 counts
    over the shards with ``psum_counts`` and narrows. The bracket has
    lo <= hi (or NaN), as ``amin`` and ``amax`` give it. Bit-identical to
    ``correct.bad_pixels.multisection_plain``, which runs instead on CPU
    planes. Raises outside :func:`multisection_kernel_admits`."""
    from ..correct.bad_pixels import multisection_plain

    if delta.device.type == "cpu":
        return multisection_plain(delta, lo, hi, target, iters, branches, psum_counts)
    if not multisection_kernel_admits(delta, branches):
        raise ValueError(
            f"the multisection kernel takes (P, H, W) float32 planes of under 2**31 samples "
            f"and 1..{MULTISECTION_MAX_BRANCHES} branches, got {tuple(delta.shape)} "
            f"{delta.dtype} and {branches}"
        )
    if not delta[0].is_contiguous():
        delta = delta.contiguous()
    p, h, w = delta.shape
    branches = int(branches)

    def args(bracket: Tensor, counts: Tensor, narrow: bool) -> tuple:
        return (delta.data_ptr(), p, h * w, delta.stride(0), bracket.data_ptr(),
                counts.data_ptr(), counts[p * branches:].data_ptr(), branches, float(target),
                int(narrow))

    def count(lo: Tensor, hi: Tensor) -> Tensor:
        # one pass's counts (P, B), and the ticket that a counting launch leaves alone
        counts = torch.zeros(p * branches + 1, dtype=torch.int32, device=delta.device)
        bracket = torch.stack([lo, hi])
        _check(bracket, "bracket", (2, p), delta.device)
        _launch("pysp_multisection", delta.device, args(bracket, counts, False))
        return counts[:-1].view(p, branches)

    with torch.cuda.device(delta.device):
        if psum_counts is not None:
            return multisection_plain(delta, lo, hi, target, iters, branches, psum_counts,
                                      count)
        bracket = torch.stack([lo, hi])
        _check(bracket, "bracket", (2, p), delta.device)
        # a pass's counts (P, B) and the ticket of its last block, a row a pass
        counts = torch.zeros((int(iters), p * branches + 1), dtype=torch.int32,
                             device=delta.device)
        _launch("pysp_multisection", delta.device,
                *(args(bracket, counts[it], True) for it in range(int(iters))))
        return bracket[0], bracket[1]


# --- CA removal's EAG resamples ----------------------------------------------------------

# The quad positions of the planes the upsample kernel takes (R and B).
EAG_POSITIONS = (BayerPatternPosition.TOP_LEFT, BayerPatternPosition.BOTTOM_RIGHT)
# The most frames one launch takes (the grid's third dimension).
EAG_MAX_FRAMES = 65535


@functools.lru_cache(maxsize=None)
def _eag_taps(position: BayerPatternPosition) -> np.ndarray:
    """The upsample kernel's host constants (``Taps`` in
    ``csrc/eag_resample.cu``): ``get_rgbg_kernel(position)`` in its order,
    then ``GAUSSIAN3_SIGMA1``."""
    parts = [*get_rgbg_kernel(position), GAUSSIAN3_SIGMA1]
    return np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])


def _frames(t: Tensor, name: str, rest) -> Tensor:
    """``t`` (..., h, w) as (N, h, w), a view where its layout allows."""
    if t.ndim < 2 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (..., H, W), got {tuple(t.shape)}")
    flat = t.reshape(-1, *rest)
    if flat.shape[0] > EAG_MAX_FRAMES:
        raise ValueError(f"{name} holds {flat.shape[0]} frames, more than {EAG_MAX_FRAMES}")
    return flat


def eag_fill_kernel(g1: Tensor, g2: Tensor, use_bilinear_weighting: bool = True) -> Tensor:
    """The full-resolution green (..., 2h, 2w) of a mosaic from its green
    phases ``g1`` and ``g2`` (..., h, w) float32 by the EAG fill kernel, one
    launch over every frame; the phases may be strided views of the mosaic
    (``core.bayer.bayer_to_rgbg``'s) and are read in place. Bit-identical to
    ``demosaic.eag.resample_g_to_full_resolution_plain``."""
    if g1.shape != g2.shape:
        raise ValueError(f"g1 and g2 must be alike, got {tuple(g1.shape)} and {tuple(g2.shape)}")
    lead, (h, w) = g1.shape[:-2], g1.shape[-2:]
    g1, g2 = _frames(g1, "g1", (h, w)), _frames(g2, "g2", (h, w))
    if g1.stride() != g2.stride():
        g1, g2 = g1.contiguous(), g2.contiguous()
    _check(g1, "g1", contiguous=False)
    _check(g2, "g2", device=g1.device, contiguous=False)
    out = torch.empty((g1.shape[0], 2 * h, 2 * w), dtype=torch.float32, device=g1.device)
    _launch("pysp_eag_fill", g1.device, (
        g1.data_ptr(), g2.data_ptr(), out.data_ptr(), g1.shape[0], h, w, *g1.stride(),
        int(bool(use_bilinear_weighting))))
    return out.view(*lead, 2 * h, 2 * w)


def eag_upsample_kernel(sub: Tensor, g: Tensor, position) -> Tensor:
    """A channel at full resolution (..., 2h, 2w) from its quarter-res plane
    ``sub`` (..., h, w) at the quad ``position`` (TOP_LEFT for R, BOTTOM_RIGHT
    for B) and the full-resolution green ``g`` (..., 2h, 2w), float32, by the
    EAG upsample kernel, one launch over every frame: the photosite-phase
    upsample of ``sub`` plus ``g`` less its 3x3 Gaussian blur. h and w must be
    at least 2 (the reflect-101 border of the quarter plane). Bit-identical to
    ``demosaic.eag.resample_channel_plain``."""
    position = BayerPatternPosition(position)
    if position not in EAG_POSITIONS:
        raise ValueError(f"the upsample kernel takes the positions {EAG_POSITIONS}, got {position}")
    h, w = sub.shape[-2:] if sub.ndim >= 2 else (0, 0)
    if h < 2 or w < 2 or tuple(g.shape) != (*sub.shape[:-2], 2 * h, 2 * w):
        raise ValueError(f"sub must be (..., h, w) with h, w >= 2 and g (..., 2h, 2w), got "
                         f"{tuple(sub.shape)} and {tuple(g.shape)}")
    lead = g.shape[:-2]
    sub = _frames(sub, "sub", (h, w)).contiguous()
    g = _frames(g, "g", (2 * h, 2 * w)).contiguous()
    _check(sub, "sub")
    _check(g, "g", device=sub.device)
    out = torch.empty_like(g)
    _launch("pysp_eag_upsample", sub.device, (
        sub.data_ptr(), g.data_ptr(), out.data_ptr(), sub.shape[0], h, w, int(position),
        _eag_taps(position).ctypes.data_as(_FLOATS)))
    return out.view(*lead, 2 * h, 2 * w)
