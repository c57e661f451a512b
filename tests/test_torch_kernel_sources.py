"""The CUDA kernels' device code, compiled for the CPU, against the plain versions.

There is no nvcc without the card, but the kernels in pysp_tpu_torch/csrc are
plain C++ inside their CUDA qualifiers: every loop strides by ``blockDim.x``
and ``__syncthreads()`` separates the stages, so running each block with one
thread, block after block, is a valid schedule of the kernel. g++ compiles the
sources with a small header that maps the CUDA names to that schedule (the
launchers sit under ``#ifdef __CUDACC__`` and drop out), and the result is held
against the plain PyTorch versions on CPU tensors with the card's tolerances.
Shared memory starts filled with NaN, so a read of a cell no stage wrote shows
up in the output.

This checks indexing, halos, buffer reuse and the order of operations. The
nvcc build, races between threads and launch limits are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix
from pysp_tpu_torch.core.frame import RawFrame
from pysp_tpu_torch.demosaic.ahd import postprocess_color_channels
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)

DRIVER = r"""
#include <math.h>
#include <stddef.h>
#include <string.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(n)
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
static inline void __syncthreads() {}
namespace { float smem[1 << 17]; }
#include KERNEL_SOURCE
static void each_block(int H, int W, void (*run)(void*), void* arg) {
  for (unsigned by = 0; by < (unsigned)((H + kTile - 1) / kTile); ++by)
    for (unsigned bx = 0; bx < (unsigned)((W + kTile - 1) / kTile); ++bx) {
      blockIdx.x = bx;
      blockIdx.y = by;
      memset(smem, 0xff, sizeof(smem));
      run(arg);
    }
}
struct Args { const float *a, *b, *c; float *x, *y, *z; int H, W, s, hdr, flags; };
extern "C" {
#ifdef EMULATE_AHD
static void run_ahd(void* p) {
  Args* a = (Args*)p;
  if (a->s == 0) ahd_kernel<0>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
  if (a->s == 1) ahd_kernel<1>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
  if (a->s == 2) ahd_kernel<2>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
}
void emulate(const float* bayer, const float* params, float* out, int H, int W,
             int stages, int is_hdr, int flags) {
  Args a{bayer, params, nullptr, out, nullptr, nullptr, H, W, stages, is_hdr, flags};
  each_block(H, W, run_ahd, &a);
}
#else
static void run_pp(void* p) {
  Args* a = (Args*)p;
  postprocess_kernel(a->a, a->b, a->c, a->x, a->y, a->z, a->H, a->W);
}
void emulate(const float* r, const float* g, const float* b, float* ro, float* go,
             float* bo, int H, int W) {
  Args a{r, g, b, ro, go, bo, H, W, 0, 0, 0};
  each_block(H, W, run_pp, &a);
}
#endif
}
"""


def _build(tmp_path_factory, source: str, define: str | None, n_ptrs: int,
           n_ints: int) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("emulated")
    driver = out / "driver.cpp"
    driver.write_text(DRIVER)
    lib = out / f"{source}.so"
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
           f"-I{K.CSRC}", f'-DKERNEL_SOURCE="{K.CSRC / source}"',
           "-o", str(lib), str(driver)]
    if define:
        cmd.insert(1, f"-D{define}")
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.emulate.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
    dll.emulate.restype = None
    return dll


@pytest.fixture(scope="module")
def ahd_lib(tmp_path_factory):
    return _build(tmp_path_factory, "ahd.cu", "EMULATE_AHD", n_ptrs=3, n_ints=5)


@pytest.fixture(scope="module")
def postprocess_lib(tmp_path_factory):
    return _build(tmp_path_factory, "postprocess.cu", None, n_ptrs=6, n_ints=2)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@pytest.mark.parametrize("shape", [(37, 50), (64, 96), (90, 70)])
def test_postprocess_source_bit_exact(postprocess_lib, shape):
    h, w = shape
    rgb = torch.from_numpy(make_scene(h, w, seed=h)).permute(2, 0, 1).contiguous()
    out = torch.full((3, h, w), float("nan"))
    postprocess_lib.emulate(*(_ptr(rgb[k]) for k in range(3)),
                            *(_ptr(out[k]) for k in range(3)), h, w)
    for got, want in zip(out, postprocess_color_channels(rgb[0], rgb[1], rgb[2])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(96, 128), (90, 118)])
@pytest.mark.parametrize("tail", [None, (True, True), (False, True)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_source_against_plain(ahd_lib, is_hdr, stages, tail, shape):
    h, w = shape  # whole tiles, and tiles that overhang the frame
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=stages)), cam_mat=CAM,
                               wb_neutral=WB, is_hdr=is_hdr)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    params = K._ahd_params(mat, wb)
    if tail is None:
        flags, out = 0, torch.full((3, h, w), float("nan"))
    else:
        flags = K._F_TAIL | K._F_INTERLEAVED
        flags |= (K._F_CLIP if tail[0] else 0) | (K._F_GAMMA if tail[1] else 0)
        out = torch.full((h, w, 3), float("nan"))
    ahd_lib.emulate(_ptr(frame.bayer), _ptr(params), _ptr(out), h, w, stages,
                    int(is_hdr), flags)
    assert not bool(torch.isnan(out).any())

    want = K.ahd_plain(frame.bayer, mat, wb, is_hdr, stages, tail)
    e = 4 * stages + 5  # the kernel's halo: values nearer the border are the strips'
    inner = np.s_[:, e:-e, e:-e] if tail is None else np.s_[e:-e, e:-e]
    got, ref = out[inner].numpy(), want[inner].numpy()
    assert psnr(got, ref) >= 50
    assert np.mean(np.abs(got - ref) > 1e-4) < 0.05
