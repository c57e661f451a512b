"""The CUDA kernels' device code, compiled for the CPU, against the plain versions.

There is no nvcc without the card, but the kernels in pysp_tpu_torch/csrc are
plain C++ inside their CUDA qualifiers: every loop strides by ``blockDim.x``
and ``__syncthreads()`` separates the stages, so running each block with one
thread, block after block, is a valid schedule of the kernel. g++ compiles the
sources with a small header that maps the CUDA names to that schedule (the
launchers sit under ``#ifdef __CUDACC__`` and drop out), and the result is held
against the plain PyTorch versions on CPU tensors with the card's tolerances.
Shared memory starts filled with NaN, so a read of a cell no stage wrote shows
up in the output, and a 16-byte access off its alignment traps, as it faults on
the card. With one thread, ``__syncthreads_or`` returns that thread's
own predicate, which it took over the whole block.

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
from pysp_tpu_torch.correct.ca.models import (
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
)
from pysp_tpu_torch.demosaic.ahd import postprocess_color_channels
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.utils.testing import (
    EAG_KINDS,
    HEAL_TILE_KINDS,
    chroma_case,
    eag_case,
    heal_case,
    heal_tile_case,
    make_scene,
    mosaic_rggb,
    multisection_case,
    psnr,
    same_bits,
)

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
#define __launch_bounds__(...)
#define __align__(n)
#define __ldg(p) (*(p))
struct Dim3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1}, gridDim{1, 1, 1};
static inline void __syncthreads() {}
static inline int __syncthreads_or(int p) { return p; }
static inline void __threadfence() {}
static inline int atomicAdd(int* p, int v) { const int old = *p; *p = old + v; return old; }
#define __reduce_or_sync(mask, v) (v)
#define __reduce_add_sync(mask, v) (v)
#define __ldcg(p) (*(p))
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
#define __fsqrt_rn(a) sqrtf(a)
#define __int2float_rn(i) ((float)(i))
#define __ffs(x) __builtin_ffs(x)
#define __popc(x) __builtin_popcount(x)
namespace { alignas(16) float smem[1 << 17]; }
#include KERNEL_SOURCE
static void each_block(unsigned gx, unsigned gy, unsigned gz, void (*run)(void*),
                       void* arg) {
  gridDim.x = gx;
  gridDim.y = gy;
  gridDim.z = gz;
  for (unsigned bz = 0; bz < gz; ++bz)
    for (unsigned by = 0; by < gy; ++by)
      for (unsigned bx = 0; bx < gx; ++bx) {
        blockIdx.x = bx;
        blockIdx.y = by;
        blockIdx.z = bz;
        memset(smem, 0xff, sizeof(smem));
        run(arg);
      }
}
static unsigned cdiv(int n, int d) { return (unsigned)((n + d - 1) / d); }
struct Args {
  const float *a, *b, *c, *d, *e, *f, *g; float *x, *y, *z;
  int H, W, s, hdr, flags, C, plane, pix, map_plane, kind, bounded, lo_y, hi_y, lo_x, hi_x;
  const void* taps; int r;
};
extern "C" {
#if defined(EMULATE_AHD)
static void run_ahd(void* p) {
  Args* a = (Args*)p;
  if (a->s == 0) ahd_kernel<0>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
  if (a->s == 1) ahd_kernel<1>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
  if (a->s == 2) ahd_kernel<2>(a->a, a->b, a->x, a->H, a->W, a->hdr, a->flags);
}
void emulate(const float* bayer, const float* params, float* out, int H, int W,
             int stages, int is_hdr, int flags) {
  Args a{};
  a.a = bayer; a.b = params; a.x = out; a.H = H; a.W = W; a.s = stages;
  a.hdr = is_hdr; a.flags = flags;
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_ahd, &a);
}
#elif defined(EMULATE_RL)
static void run_rl(void* p) {
  Args* a = (Args*)p;
  const Taps& t = *(const Taps*)a->taps;
  switch (a->r) {
#define RL_RUN(R) \
  case R: rl_fixed_kernel<R>(a->a, a->b, a->x, a->H, a->W, a->plane, a->pix, t); return;
    RL_FIXED_REACHES(RL_RUN)
#undef RL_RUN
  }
  rl_iter_kernel(a->a, a->b, a->x, a->H, a->W, a->plane, a->pix, t, a->r);
}
void emulate(const float* est, const float* img, float* out, const float* taps,
             int H, int W, int C, int plane, int pix, int n_taps) {
  Taps t;
  for (int i = 0; i < kMaxTaps; ++i) t.w[i] = i < n_taps ? taps[i] : 0.0f;
  Args a{};
  a.a = est; a.b = img; a.x = out; a.H = H; a.W = W; a.plane = plane; a.pix = pix;
  a.taps = &t; a.r = n_taps / 2;
  const bool fixed = a.r <= kMaxFixedReach;
  each_block(cdiv(W, fixed ? kTW : kTile), cdiv(H, fixed ? kTH : kTile), (unsigned)C,
             run_rl, &a);
}
#elif defined(EMULATE_REMAP)
static BilinearFn bilinear;
static void run_remap(void* p) {
  Args* a = (Args*)p;
  if (a->kind == 1)
    lanczos4_kernel(a->a, a->b, a->c, a->x, a->H, a->W, a->C, a->plane, a->pix,
                    a->map_plane, a->bounded, a->lo_y, a->hi_y, a->lo_x, a->hi_x);
  else
    bilinear(a->a, a->b, a->c, a->x, a->H, a->W, a->C, a->plane, a->pix, a->map_plane,
             a->bounded, a->lo_y, a->hi_y, a->lo_x, a->hi_x);
}
static void remap(const float* img, const float* map_x, const float* map_y, float* out,
                  int H, int W, int C, int plane, int pix, int map_plane, int kind,
                  int bounded, int dy0, int dy1, int dx0, int dx1, bool wide) {
  Args a{};
  a.a = img; a.b = map_x; a.c = map_y; a.x = out; a.H = H; a.W = W; a.C = C;
  a.plane = plane; a.pix = pix; a.map_plane = map_plane; a.kind = kind;
  a.bounded = bounded; a.lo_y = dy0; a.hi_y = dy1; a.lo_x = dx0; a.hi_x = dx1;
  if (kind == 1) {
    each_block(cdiv(W, kTileX), cdiv(H, kTileY), 1, run_remap, &a);
  } else {
    bilinear = bilinear_variant(H, W, C, map_plane, wide);
    each_block(cdiv(W, kBlTileX), cdiv(H, kBlTileY), 1, run_remap, &a);
  }
}
void emulate(const float* img, const float* map_x, const float* map_y, float* out,
             int H, int W, int C, int plane, int pix, int map_plane, int kind,
             int bounded, int dy0, int dy1, int dx0, int dx1) {
  remap(img, map_x, map_y, out, H, W, C, plane, pix, map_plane, kind, bounded, dy0, dy1,
        dx0, dx1, false);
}
// The bilinear kind with 64-bit offsets, which the launcher takes only for
// more than 2^31 elements.
void emulate_wide(const float* img, const float* map_x, const float* map_y, float* out,
                  int H, int W, int C, int plane, int pix, int map_plane, int kind,
                  int bounded, int dy0, int dy1, int dx0, int dx1) {
  remap(img, map_x, map_y, out, H, W, C, plane, pix, map_plane, kind, bounded, dy0, dy1,
        dx0, dx1, true);
}
// The radial kind on a (C, H, W) stack: the coordinates of `form` (forward or
// inverse) from `params` (cy, cx, 1 / r_corner, six constants).
static RadialFn radial;
static RadialModel radial_params;
static void run_radial(void* p) {
  Args* a = (Args*)p;
  radial(a->a, a->x, a->H, a->W, a->C, a->plane, radial_params);
}
int emulate_radial(const float* img, float* out, int H, int W, int C, int form,
                   int inverse, const float* params, int wide) {
  radial = radial_variant(H, W, C, form, inverse != 0, wide != 0);
  if (radial == nullptr) return 1;
  radial_params = radial_model(params);
  Args a{};
  a.a = img; a.x = out; a.H = H; a.W = W; a.C = C; a.plane = H * W;
  const dim3 grid = radial_grid(H, W);
  each_block(grid.x, grid.y, 1, run_radial, &a);
  return 0;
}
#elif defined(EMULATE_HEAL)
static void run_heal(void* p) {
  Args* a = (Args*)p;
  heal_kernel(a->a, (const unsigned char*)a->b, a->c, a->x, a->H, a->W, a->s, a->r,
              a->flags);
}
void emulate(const float* chan, const void* mask, const float* means, float* out,
             int H, int W, int fill, int smooth) {
  Args a{};
  a.a = chan; a.b = (const float*)mask; a.c = means; a.x = out; a.H = H; a.W = W;
  a.s = fill; a.r = smooth;
  a.flags = W % kGroup == 0 && (size_t)chan % 16 == 0 && (size_t)out % 16 == 0 &&
            (size_t)mask % 8 == 0;
  each_block(cdiv(W, kCopyW), cdiv(H, kCopyH), 4, run_heal, &a);
}
#elif defined(EMULATE_MEDIAN5)
static void run_median5(void* p) {
  Args* a = (Args*)p;
  median5_kernel(a->a, a->x, a->H, a->W, a->flags);
}
void emulate(const float* x, float* out, int H, int W) {
  Args a{};
  a.a = x; a.x = out; a.H = H; a.W = W;
  const void* const planes[2] = {x, out};
  a.flags = (int)rows_aligned(W, planes, 2);
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_median5, &a);
}
#elif defined(EMULATE_HOMOGENEITY)
static void run_homogeneity(void* p) {
  Args* a = (Args*)p;
  if (a->s)
    homogeneity_kernel<true>(a->a, a->b, a->c, a->x, a->H, a->W, a->flags);
  else
    homogeneity_kernel<false>(a->a, a->b, a->c, a->x, a->H, a->W, a->flags);
}
void emulate(const float* lum, const float* la, const float* lb, float* out, int H,
             int W, int vertical) {
  Args a{};
  a.a = lum; a.b = la; a.c = lb; a.x = out; a.H = H; a.W = W; a.s = vertical;
  const void* const planes[4] = {lum, la, lb, out};
  a.flags = (int)rows_aligned(W, planes, 4);
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_homogeneity, &a);
}
#elif defined(EMULATE_DECISION)
static void run_decision(void* p) {
  Args* a = (Args*)p;
  decision_kernel(a->a, a->b, a->c, a->d, a->e, a->f, a->g, a->x, a->H, a->W, a->hdr);
}
void emulate(const float* r_h, const float* g_h, const float* b_h, const float* r_v,
             const float* g_v, const float* b_v, const float* params, float* out,
             int H, int W, int is_hdr) {
  Args a{};
  a.a = r_h; a.b = g_h; a.c = b_h; a.d = r_v; a.e = g_v; a.f = b_v; a.g = params;
  a.x = out; a.H = H; a.W = W; a.hdr = is_hdr;
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_decision, &a);
}
#elif defined(EMULATE_MULTISECTION)
struct MultisectionArgs {
  const float* x; float* bracket; int* counts; int* ticket;
  int P, n; long long stride; int branches; float target; int narrow;
};
static void run_multisection(void* p) {
  MultisectionArgs* a = (MultisectionArgs*)p;
  multisection_kernel(a->x, a->P, a->n, a->stride, a->bracket, a->counts, a->ticket,
                      a->branches, a->target, a->narrow);
}
// One pass over P planes of n samples, `blocks` blocks a plane.
void emulate(const float* x, float* bracket, int* counts, int* ticket, int P, int n,
             long long stride, int branches, float target, int narrow, int blocks) {
  MultisectionArgs a{x, bracket, counts, ticket, P, n, stride, branches, target, narrow};
  each_block((unsigned)blocks, (unsigned)P, 1, run_multisection, &a);
}
#elif defined(EMULATE_EAG)
struct FillArgs {
  const float *g1, *g2; float* out; int h, w; long long frame, row, col; int weighted;
};
static void run_fill(void* p) {
  FillArgs* a = (FillArgs*)p;
  if (a->weighted)
    eag_fill_kernel<true>(a->g1, a->g2, a->out, a->h, a->w, a->frame, a->row, a->col);
  else
    eag_fill_kernel<false>(a->g1, a->g2, a->out, a->h, a->w, a->frame, a->row, a->col);
}
// The green fill of N frames whose phases have the strides frame, row, col.
void emulate(const float* g1, const float* g2, float* out, int N, int h, int w,
             long long frame, long long row, long long col, int weighted) {
  FillArgs a{g1, g2, out, h, w, frame, row, col, weighted};
  each_block(cdiv(w, kFillQW), cdiv(h, kFillQH), (unsigned)N, run_fill, &a);
}
struct UpsampleArgs {
  const float *sub, *g; float* out; int h, w, position, aligned; Taps k;
};
static void run_upsample(void* p) {
  UpsampleArgs* a = (UpsampleArgs*)p;
  if (a->position == 0)
    eag_upsample_kernel<0, 0>(a->sub, a->g, a->out, a->h, a->w, a->k, a->aligned);
  else
    eag_upsample_kernel<1, 1>(a->sub, a->g, a->out, a->h, a->w, a->k, a->aligned);
}
// The upsample of N frames at `position` (0 or 3) with the host's 45 Taps
// floats; `aligned` as the launcher takes it. Returns 1 for another position.
int emulate_upsample(const float* sub, const float* g, float* out, int N, int h, int w,
                     int position, const float* params) {
  if (position != 0 && position != 3) return 1;
  UpsampleArgs a{sub, g, out, h, w, position, 0, {}};
  memcpy(&a.k, params, sizeof(Taps));
  const void* const quarter[1] = {sub};
  const void* const full[2] = {g, out};
  a.aligned = rows_aligned(w, quarter, 1) && rows_aligned(2 * w, full, 2);
  each_block(cdiv(2 * w, kTW), cdiv(2 * h, kTH), (unsigned)N, run_upsample, &a);
  return 0;
}
#else
static void run_pp(void* p) {
  Args* a = (Args*)p;
  const void* const planes[6] = {a->a, a->b, a->c, a->x, a->y, a->z};
  postprocess_kernel(a->a, a->b, a->c, a->x, a->y, a->z, a->H, a->W,
                     (int)rows_aligned(a->W, planes, 6));
}
void emulate(const float* r, const float* g, const float* b, float* ro, float* go,
             float* bo, int H, int W) {
  Args a{};
  a.a = r; a.b = g; a.c = b; a.x = ro; a.y = go; a.z = bo; a.H = H; a.W = W;
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_pp, &a);
}
static void run_pp_hwc(void* p) {
  Args* a = (Args*)p;
  const void* const images[2] = {a->a, a->x};
  postprocess_hwc_kernel(a->a, a->x, a->H, a->W, (int)rows_aligned(a->W, images, 2));
}
void emulate_hwc(const float* img, float* out, int H, int W) {
  Args a{};
  a.a = img; a.x = out; a.H = H; a.W = W;
  each_block(cdiv(W, kTW), cdiv(H, kTH), 1, run_pp_hwc, &a);
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
    # A load or store through a pointer off its type's alignment (a 16-byte
    # Vec4 access to a plane whose rows are not 16-byte aligned) traps, as it
    # faults on the card.
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
           "-fno-strict-aliasing", "-fsanitize=alignment",
           "-fsanitize-undefined-trap-on-error", f"-I{K.CSRC}", f'-DKERNEL_SOURCE="{K.CSRC / source}"',
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
    dll = _build(tmp_path_factory, "postprocess.cu", None, n_ptrs=6, n_ints=2)
    dll.emulate_hwc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    dll.emulate_hwc.restype = None
    return dll


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _chroma_planes(h, w, seed, pad=0):
    """``chroma_case`` as (3, H, W) CPU planes; ``pad`` floats shift the planes'
    start, which takes the rows off their 16-byte alignment."""
    store = torch.zeros(3 * h * w + pad)
    planes = store[pad:].view(3, h, w)
    planes.copy_(torch.from_numpy(chroma_case(h, w, seed)))
    return planes


# The tile is 32 rows by 64 columns and a block is free of border code when its
# tile plus 4 px lies inside a frame whose rows are 16-byte aligned.
POSTPROCESS_SHAPES = [
    (37, 50), (64, 96), (90, 70),   # one and a half tiles a side
    (100, 200),   # 4 x 4 tiles: blocks without border code, edge blocks on each side
    (100, 202),   # the same with rows off the 16-byte alignment: no block is fast
    (96, 256),    # whole tiles: the last row and column of blocks touch the edge
    (70, 20), (20, 70),   # narrower, and lower, than one tile
    (3, 5), (1, 7), (7, 1), (1, 1),   # smaller than the medians' window
]


@pytest.mark.parametrize("shape", POSTPROCESS_SHAPES)
def test_postprocess_source_bit_exact(postprocess_lib, shape):
    """One chroma-median stage's device code equals the plain stage bit for
    bit. Each of these mutants of the source fails here: the second medians'
    input mirrored instead of clamped at the border, a halo load shifted by one
    cell, the strip's window started one row off."""
    h, w = shape
    rgb = _chroma_planes(h, w, seed=h + w)
    out = torch.full((3, h, w), float("nan"))
    postprocess_lib.emulate(*(_ptr(rgb[k]) for k in range(3)),
                            *(_ptr(out[k]) for k in range(3)), h, w)
    for got, want in zip(out, postprocess_color_channels(rgb[0], rgb[1], rgb[2])):
        assert torch.equal(got, want)


def test_postprocess_source_unaligned_planes(postprocess_lib):
    """Planes that start off a 16-byte boundary take the path without 16-byte
    accesses and give the same bytes as aligned ones."""
    h, w = 100, 200
    rgb = _chroma_planes(h, w, seed=5, pad=1)
    assert rgb.data_ptr() % 16 != 0
    out = torch.full((3, h, w), float("nan"))
    postprocess_lib.emulate(*(_ptr(rgb[k]) for k in range(3)),
                            *(_ptr(out[k]) for k in range(3)), h, w)
    for got, want in zip(out, postprocess_color_channels(rgb[0], rgb[1], rgb[2])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("shape", POSTPROCESS_SHAPES)
def test_postprocess_hwc_source_bit_exact(postprocess_lib, shape, pad):
    """The (H, W, 3) entry's device code (a pixel stride of 3, a strip of four
    pixels as three 16-byte accesses) equals the plain stage bit for bit;
    ``pad`` takes the image off its 16-byte alignment, so that no block takes
    the 16-byte path. Each of these mutants fails here: the strip's channels
    split in the wrong order on load, or interleaved in the wrong order on
    store, and the general path's pixel stride left at 1."""
    h, w = shape
    store = torch.zeros(h * w * 3 + pad)
    image = store[pad:].view(h, w, 3)
    image.copy_(torch.from_numpy(chroma_case(h, w, seed=h * w)).permute(1, 2, 0))
    out = torch.full((h, w, 3), float("nan"))
    postprocess_lib.emulate_hwc(_ptr(image), _ptr(out), h, w)
    want = postprocess_color_channels(image[..., 0], image[..., 1], image[..., 2])
    assert torch.equal(out, torch.stack(want, dim=-1))


def _ahd_emulated(ahd_lib, frame, stages, tail):
    """The AHD kernel's device code on a CPU frame, and its plain version."""
    h, w = frame.bayer.shape
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
                    int(frame.is_hdr), flags)
    assert not bool(torch.isnan(out).any())
    want = K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)
    if tail is None:
        out, want = out.permute(1, 2, 0), want.permute(1, 2, 0)
    return out, want


# Pixels whose H/V pick may flip against the plain version: cbrtf and powf
# round CIELAB differently from torch's, which matters only at an exact tie of
# the two box-summed counts. At most this share of the frame.
MAX_AHD_FLIPS = 1e-4


def _assert_ahd_equal_but_for_flips(ahd_lib, frame, stages, tail):
    """Whole frame, border included: without stages all pixels but the flipped
    ones are bit-equal; a chroma-median stage spreads a flipped pixel over its
    two 5x5 windows, 4 px, so with S stages every pixel outside the 4 S px
    dilation of the flipped set is bit-equal. After the colour tail the rest
    is within 2e-6: the host's powf is not torch's in the gamma."""
    got0, want0 = _ahd_emulated(ahd_lib, frame, 0, None)
    flipped = (got0 != want0).any(dim=-1)
    assert float(flipped.float().mean()) <= MAX_AHD_FLIPS
    if stages == 0 and tail is None:
        return
    got, want = _ahd_emulated(ahd_lib, frame, stages, tail)
    k = 8 * stages + 1
    near = torch.nn.functional.max_pool2d(flipped[None, None].float(), k, 1, k // 2)[0, 0] > 0
    err = (got - want).abs().amax(dim=-1)
    assert float(err[~near].max()) <= (0.0 if tail is None else 2e-6)
    assert psnr(got.numpy(), want.numpy()) >= 50


@pytest.mark.parametrize("shape", [(96, 128), (90, 118)])
@pytest.mark.parametrize("tail", [None, (True, True), (False, True)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_source_against_plain(ahd_lib, is_hdr, stages, tail, shape):
    h, w = shape  # whole tiles, and tiles that overhang the frame
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=stages)), cam_mat=CAM,
                               wb_neutral=WB, is_hdr=is_hdr, device="cpu")
    _assert_ahd_equal_but_for_flips(ahd_lib, frame, stages, tail)


def _noisy_frame(h, w, seed, is_hdr):
    """A noisy scene, so that greens, counts and chroma differ from row to row
    up to the frame's edge and each border rule gives its own values there."""
    rng = np.random.default_rng(seed)
    mosaic = mosaic_rggb(make_scene(h, w, seed=seed))
    mosaic = np.clip(mosaic + rng.normal(0, 0.03, mosaic.shape), 0.02, 0.98).astype(np.float32)
    return RawFrame.synthetic(mosaic, cam_mat=CAM, wb_neutral=WB, is_hdr=is_hdr, device="cpu")


@pytest.mark.parametrize("shape", [(96, 128), (90, 118), (20, 200), (4, 6)])
@pytest.mark.parametrize("stages", [0, 1, 2])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_ahd_source_border_rules(ahd_lib, is_hdr, stages, shape):
    """Every stage's border rule, applied by the kernel itself: on noisy scenes
    the whole frame equals the plain version but for tie flips, at whole tiles,
    at tiles that overhang on both axes, at a single tile row and at the
    smallest frame the kernel takes. Each of these mutants of the source fails
    here: the counts read through a clamp instead of reflect-101, CIELAB read
    through reflect-101 instead of the symmetric border, the medians' inputs
    through reflect-101 instead of the replicate border."""
    h, w = shape
    frame = _noisy_frame(h, w, seed=h + stages, is_hdr=is_hdr)
    _assert_ahd_equal_but_for_flips(ahd_lib, frame, stages, None)


@pytest.fixture(scope="module")
def rl_lib(tmp_path_factory):
    return _build(tmp_path_factory, "rl.cu", "EMULATE_RL", n_ptrs=4, n_ints=6)


@pytest.fixture(scope="module")
def remap_lib(tmp_path_factory):
    dll = _build(tmp_path_factory, "remap.cu", "EMULATE_REMAP", n_ptrs=4, n_ints=12)
    dll.emulate_wide.argtypes = dll.emulate.argtypes
    dll.emulate_wide.restype = None
    dll.emulate_radial.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p, ctypes.c_int])
    dll.emulate_radial.restype = ctypes.c_int
    return dll


def _rl_image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    img = make_scene(h, w, seed=seed)[..., :c] * 0.9 + 0.05
    img = img + rng.normal(0, 0.01, img.shape).astype(np.float32)
    img = np.clip(img, 0.01, 1.0).astype(np.float32)
    return torch.from_numpy(img[..., 0] if c == 1 else img).contiguous()


@pytest.mark.parametrize("sigma,iters,shape", [
    (1.0, 3, (45, 70)),     # reach 3; tiles overhang the frame on both axes
    (2.0, 2, (37, 50)),     # reach 6, the largest with a kernel of its own
    (2.0, 2, (12, 40)),     # H = 2 * reach, the gate's edge
    (10.5, 1, (64, 80)),    # reach 31, next to the gate's largest: the generic kernel
    (0.5, 3, (2, 6)),       # reach 1 at the gate's edge
    (0.5, 2, (33, 130)),    # reach 1; three tile columns, the last one pixel wide
    (0.7, 2, (70, 66)),     # reach 2
    (1.0, 2, (6, 6)),       # reach 3, H = W = 2 * reach: both edges in one block
    (1.0, 2, (64, 128)),    # reach 3, whole tiles
    (1.4, 2, (40, 140)),    # reach 4
    (1.6, 2, (37, 50)),     # reach 5
    (2.5, 1, (37, 50)),     # reach 7, the smallest on the generic kernel
])
@pytest.mark.parametrize("channels", [1, 3])
def test_rl_source_bit_exact(rl_lib, sigma, iters, shape, channels):
    """The RL iteration's device code equals the plain loop bit for bit,
    mirrored ratio border included, in the (H, W) and (H, W, C) layouts."""
    from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter

    h, w = shape
    taps = torch.from_numpy(get_1d_gaussian_filter(sigma))
    assert K.rl_kernel_admits((h, w), taps.numpy())
    img = _rl_image(h, w, channels, seed=h + channels)
    est = img
    for _ in range(iters):
        out = torch.full_like(img, float("nan"))
        rl_lib.emulate(_ptr(est), _ptr(img), _ptr(out), _ptr(taps), h, w, channels,
                       1 if channels > 1 else h * w, channels, len(taps))
        est = out
    assert torch.equal(est, K.rl_plain(img, taps.numpy(), iters))


def _warp_maps(h, w, c, seed):
    """Smooth lens-like maps (C, H, W) with a few samples pushed past the frame."""
    from pysp_tpu_torch.warp.rectilinear import compute_remapping_table

    xs, ys = [], []
    for k in range(c):
        kr1 = -0.02 + 0.01 * k + 0.001 * seed
        mx, my = compute_remapping_table((1.0, kr1, 0.002, 0.0, 0.001, -0.001), w, h,
                                         (0.45, 0.55), device="cpu")
        xs.append(mx)
        ys.append(my)
    mx, my = torch.stack(xs), torch.stack(ys)
    mx[:, 0, :5] -= 3.5        # off the left edge: clamped gathers
    my[:, -1, -4:] += 2.25     # off the bottom edge
    my[:, h // 2, 8:12] += 2.5  # inside the frame, beyond the bounds tested
    return mx.contiguous(), my.contiguous()


# Lanczos4 against ``remap_plain`` on images in [0, 1]: the kernel takes an
# axis's eight weights from one sinf and one sincosf, the plain version from
# sixteen sines of pi t rounded to float; the weights differ by up to 4.8e-7.
LANCZOS4_ATOL = 5e-6
# ... and against the same remap in float64 the kernel may be this much further
# off than the float32 plain version is.
LANCZOS4_F64_SLACK = 1e-6


def _remap_emulated(remap_lib, img, mx, my, kind, bounds, channels_last=None,
                    wide=False):
    """The remap's device code on CPU tensors: an (H, W) plane, an (H, W, C)
    image or, with ``channels_last=False``, a (C, H, W) stack; ``wide`` takes
    the bilinear kind's 64-bit offsets."""
    if channels_last is None:
        channels_last = img.ndim == 3
    h, w, channels, plane, pix = K._layout(img, channels_last)
    out = torch.full_like(img, float("nan"))
    (dy0, dy1), (dx0, dx1) = bounds or ((0, 0), (0, 0))
    run = remap_lib.emulate_wide if wide else remap_lib.emulate
    run(_ptr(img), _ptr(mx), _ptr(my), _ptr(out), h, w, channels, plane, pix,
        h * w if mx.ndim == 3 else 0, K.REMAP_KINDS.index(kind), int(bounds is not None),
        dy0, dy1, dx0, dx1)
    assert not bool(torch.isnan(out).any())
    return out


def _assert_remap_close(out, img, mx, my, kind, bounds, channels_last=None):
    """Bilinear bit-exact; Lanczos4 within its tolerance of the plain version
    and no further from the float64 remap than the plain version is."""
    if channels_last is None:
        channels_last = img.ndim == 3
    want = K.remap_plain(img, mx, my, kind, bounds, channels_last)
    if kind == "bilinear":
        assert torch.equal(out, want)
        return
    assert (out - want).abs().max().item() <= LANCZOS4_ATOL
    exact = K.remap_plain(img.double(), mx.double(), my.double(), kind, bounds, channels_last)
    plain_err = (want.double() - exact).abs().max().item()
    assert (out.double() - exact).abs().max().item() <= plain_err + LANCZOS4_F64_SLACK


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("bounds", [None, ((-2, 1), (-1, 2))])
@pytest.mark.parametrize("channels,shape,maps", [
    (1, (40, 70), "shared"), (3, (37, 45), "shared"), (3, (37, 45), "per_channel"),
])
def test_remap_source_against_plain(remap_lib, kind, bounds, channels, shape, maps):
    """The remap's device code against ``remap_plain``: bilinear bit-exact,
    Lanczos4 within 5e-6 and as close to the float64 remap as the plain
    version. The bounds are tighter than the maps' displacement, so the clip is
    exercised."""
    h, w = shape
    img = _rl_image(h, w, channels, seed=w)           # (H, W) or (H, W, C)
    mx, my = _warp_maps(h, w, channels if maps == "per_channel" else 1, seed=h)
    if maps == "shared":
        mx, my = mx[0].contiguous(), my[0].contiguous()
    out = _remap_emulated(remap_lib, img, mx, my, kind, bounds)
    _assert_remap_close(out, img, mx, my, kind, bounds)


def _random_maps(h, w, seed):
    """Maps that send every pixel anywhere in the frame and a little past it."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-3, w + 2, (h, w)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (h, w)).astype(np.float32)
    return torch.from_numpy(mx), torch.from_numpy(my)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
@pytest.mark.parametrize("case", [
    "shared", "per_channel", "planes", "plane", "clipped", "tiny", "random",
])
def test_remap_source_layouts_and_maps(remap_lib, kind, case):
    """The remap's device code over three by three tiles that overhang the
    frame on both axes: an (H, W, 3) image with shared maps (Lanczos4 sums its
    three channels together) and with a map for each channel, a (3, H, W)
    stack, one plane, bounds that clip, a frame smaller than the taps' reach,
    and random maps that send every pixel anywhere in the frame and past it."""
    h, w = (5, 6) if case == "tiny" else (70, 75)
    channels = 1 if case == "plane" else 3
    img = _rl_image(h, w, channels, seed=h)
    if case == "random":
        mx, my = _random_maps(h, w, seed=3)
    else:
        mx, my = _warp_maps(h, w, 3 if case == "per_channel" else 1, seed=h)
        if case != "per_channel":
            mx, my = mx[0].contiguous(), my[0].contiguous()
    bounds = ((-2, 1), (-1, 2)) if case == "clipped" else None
    channels_last = channels > 1 and case != "planes"
    if case == "planes":
        img = img.permute(2, 0, 1).contiguous()
    out = _remap_emulated(remap_lib, img, mx, my, kind, bounds, channels_last)
    _assert_remap_close(out, img, mx, my, kind, bounds, channels_last)


def _stack_case(planes, maps, layout, h=37, w=45):
    """A bilinear case: ``planes`` planes as a (C, H, W) stack, an (H, W, C)
    image or, for one plane, an (H, W) plane, with lens maps shared by the
    planes or one for each (a (1, H, W) map for one plane), on a frame whose
    tiles overhang both axes (32 x 8 px)."""
    img = _rl_image(h, w, 3, seed=planes + h)
    img = torch.cat([img * (1 - 0.05 * k) for k in range(-(-planes // 3))], dim=-1)
    img = img[..., :planes].contiguous()
    mx, my = _warp_maps(h, w, planes if maps == "per_channel" else 1, seed=planes)
    if maps == "shared":
        mx, my = mx[0].contiguous(), my[0].contiguous()
    channels_last = layout == "hwc"
    if planes == 1 and maps == "shared":
        img = img[..., 0].contiguous()
    elif not channels_last:
        img = img.permute(2, 0, 1).contiguous()
    return img, mx, my, channels_last


@pytest.mark.parametrize("offsets", ["32-bit", "64-bit"])
@pytest.mark.parametrize("bounds", [None, ((-2, 1), (-1, 2))])
@pytest.mark.parametrize("maps", ["shared", "per_channel"])
@pytest.mark.parametrize("planes,layout", [(16, "chw"), (7, "chw"), (6, "chw"), (5, "chw"),
                                           (1, "chw"), (5, "hwc")])
def test_remap_source_bilinear_stacks(remap_lib, planes, layout, maps, bounds, offsets):
    """The bilinear kind's device code on (C, H, W) stacks of 16 planes
    (config 5's CA burst), of 7, 6 and 5 (a part group of three, two and one
    channels after whole groups of four), on one plane and on an (H, W, 5)
    image, maps shared or one for each plane, bounded (tighter than the maps'
    displacement) or not, with 32- and 64-bit offsets, over tiles that
    overhang both axes: ``torch.equal`` to ``remap_plain``."""
    img, mx, my, channels_last = _stack_case(planes, maps, layout)
    out = _remap_emulated(remap_lib, img, mx, my, "bilinear", bounds, channels_last,
                          wide=offsets == "64-bit")
    assert torch.equal(out, K.remap_plain(img, mx, my, "bilinear", bounds, channels_last))


def test_lanczos4_weights_near_whole_phases(remap_lib):
    """Phases next to 0 and 1, where one tap takes almost all the weight and
    sin(pi frac) is a small difference from a rounded argument: a shift by
    almost a whole pixel stays within the tolerance of the plain version."""
    h, w = 12, 40
    img = _rl_image(h, w, 1, seed=2)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    eps = torch.tensor([10.0 ** -(k % 8) for k in range(w)]) * 0.3
    mx = (xs + torch.where(xs % 2 == 0, eps, 1 - eps)).contiguous()
    my = (ys + torch.where(ys % 2 == 0, 1 - eps[:h, None], eps[:h, None])).contiguous()
    out = _remap_emulated(remap_lib, img, mx, my, "lanczos4", None)
    _assert_remap_close(out, img, mx, my, "lanczos4", None)


# CA removal's radial models: Poly3 at the mf102 configuration's k1 and at
# +-0.3, Poly5 and PTLens.
RADIAL_MODELS = {
    "poly3_mf102_r": (Poly3CorrectionModel, (0.000714,)),
    "poly3_mf102_b": (Poly3CorrectionModel, (-0.000714,)),
    "poly3_strong": (Poly3CorrectionModel, (0.3,)),
    "poly3_strong_neg": (Poly3CorrectionModel, (-0.3,)),
    "poly5": (Poly5CorrectionModel, (0.015, -0.008)),
    "ptlens": (PtLensCorrectionModel, (0.01, -0.02, 0.015)),
}


def _radial_emulated(remap_lib, img, form, inverse, wide=False):
    """The radial kind's device code on an (H, W) plane or a (C, H, W) stack."""
    h, w = img.shape[-2:]
    channels = 1 if img.ndim == 2 else img.shape[0]
    params = K._radial_params(form, h, w)
    out = torch.full_like(img, float("nan"))
    assert remap_lib.emulate_radial(_ptr(img), _ptr(out), h, w, channels,
                                    list(K.RADIAL_FORMS).index(form[0]), int(inverse),
                                    params.ctypes.data, int(wide)) == 0
    assert not bool(torch.isnan(out).any())
    return out


@pytest.mark.parametrize("offsets", ["32-bit", "64-bit"])
@pytest.mark.parametrize("shape", [(37, 45), (3, 37, 45), (5, 24, 71), (2, 38, 64), (1, 7),
                                   (2, 3, 1)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("model", list(RADIAL_MODELS))
def test_remap_source_radial_kind(remap_lib, model, inverse, shape, offsets):
    """The radial kind's device code, the coordinates of each model form
    computed in the kernel, forward and Newton-inverted: ``torch.equal`` to
    its plain version (``remap_radial_plain``: the maps in the kernel's order
    of operations, then ``remap_plain``) on an odd-by-odd plane (its centre
    pixel at r = 0, its middle row and column their own mirrors), a
    three-frame burst of it, a five-plane stack (a part group after a whole
    one) with an even and an odd side, an even-by-even pair, a single row and
    a single column, over tiles that overhang, with 32- and 64-bit offsets.
    The output starts as NaN, so a pixel that no mirror writes fails."""
    cls, coeffs = RADIAL_MODELS[model]
    form = cls(*coeffs).kernel_form()
    planes = int(np.prod(shape[:-2]))
    img = _rl_image(shape[-2], shape[-1], 3, seed=planes)
    img = torch.cat([img * (1 - 0.05 * k) for k in range(-(-planes // 3))], dim=-1)
    img = img[..., :planes].permute(2, 0, 1).reshape(shape).contiguous()
    out = _radial_emulated(remap_lib, img, form, inverse, wide=offsets == "64-bit")
    assert torch.equal(out, K.remap_radial_plain(img, form, inverse))


def test_remap_source_radial_refuses_an_unknown_form(remap_lib):
    img = torch.zeros(4, 4)
    params = np.zeros(9, np.float32)
    assert remap_lib.emulate_radial(_ptr(img), _ptr(img), 4, 4, 1, len(K.RADIAL_FORMS), 0,
                                    params.ctypes.data, 0) == 1


@pytest.fixture(scope="module")
def heal_lib(tmp_path_factory):
    return _build(tmp_path_factory, "heal.cu", "EMULATE_HEAL", n_ptrs=4, n_ints=4)



def _heal_emulated(heal_lib, planes, mask, fill, smooth):
    assert K.heal_kernel_admits(fill, smooth)
    means = planes.mean(dim=(-2, -1)).contiguous()
    out = torch.full_like(planes, float("nan"))
    heal_lib.emulate(_ptr(planes), _ptr(mask), _ptr(means), _ptr(out), planes.shape[1],
                     planes.shape[2], fill, smooth)
    return out


@pytest.mark.parametrize("sweeps", [(4, 2), (6, 2)])
@pytest.mark.parametrize("density", [1e-4, 3e-3, 0.6])
@pytest.mark.parametrize("shape", [(256, 384), (253, 381), (3, 5), (1, 1)])
def test_heal_source_bit_exact(heal_lib, shape, density, sweeps):
    """The heal's device code equals the dense masked fill bit for bit, at
    whole and overhanging tiles, at rows that take 16-byte accesses (384) and
    rows that do not (381), and at planes smaller than the halo."""
    planes, mask = map(torch.from_numpy, heal_case(*shape, density, seed=shape[1]))
    out = _heal_emulated(heal_lib, planes, mask, *sweeps)
    assert torch.equal(out, K.heal_plain(planes, mask, *sweeps))


@pytest.mark.parametrize("sweeps", [(4, 2), (6, 2)])
@pytest.mark.parametrize("kind", HEAL_TILE_KINDS)
@pytest.mark.parametrize("shape", [(64, 128), (61, 133), (3, 5), (1, 1)])
def test_heal_source_tiling(heal_lib, shape, kind, sweeps):
    """The copy tiles and sweep sub-tiles: planes with no site (every block
    copies and stops), a site in every sub-tile (every block sweeps all of
    its sub-tiles, one after another in the same shared memory), and sites on
    every sub-tile corner and R - 1 sites before and past it (the shrinking
    sweep regions and the halo's reach)."""
    planes, mask = map(torch.from_numpy, heal_tile_case(*shape, kind, seed=shape[1]))
    out = _heal_emulated(heal_lib, planes, mask, *sweeps)
    assert torch.equal(out, K.heal_plain(planes, mask, *sweeps))
    if kind == "no_site":
        assert torch.equal(out, planes)


# --- the staged AHD route's kernels: median5, homogeneity count, direction pick --------

# Whole tiles, tiles that overhang the plane on both axes, and planes smaller
# than the windows.
SMALL_SHAPES = [(64, 96), (37, 50), (33, 70), (3, 5), (2, 2)]
# The median5 kernel's 16x64 and the homogeneity kernel's 32x64 tiles: blocks
# free of border code beside edge blocks on every side (100x260), rows off the
# 16-byte alignment (97x203, 130x190: no block takes the 16-byte path), and
# planes one pixel wide or high, where both neighbours of a direction clamp to
# one cell and the median's window repeats one column or row five times.
TILE_SHAPES = [(100, 260), (97, 203), (130, 190), (1, 1), (1, 7), (7, 1)]


@pytest.fixture(scope="module")
def median5_lib(tmp_path_factory):
    return _build(tmp_path_factory, "median5.cu", "EMULATE_MEDIAN5", n_ptrs=2, n_ints=2)


@pytest.fixture(scope="module")
def homogeneity_lib(tmp_path_factory):
    return _build(tmp_path_factory, "homogeneity.cu", "EMULATE_HOMOGENEITY", n_ptrs=4,
                  n_ints=3)


@pytest.fixture(scope="module")
def decision_lib(tmp_path_factory):
    return _build(tmp_path_factory, "decision.cu", "EMULATE_DECISION", n_ptrs=8, n_ints=3)


def _set_corners(plane: torch.Tensor, values) -> torch.Tensor:
    """Outliers at the four corners: they enter a border pixel's window as often
    as the border rule repeats them, so another rule gives another result."""
    h, w = plane.shape
    for (y, x), v in zip(((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)), values):
        plane[y, x] = v
    return plane


def _chroma_plane(h, w, seed, pad=0):
    """R - G of a scene with outlier corners; ``pad`` floats shift the plane's
    start off its 16-byte alignment."""
    rgb = torch.from_numpy(make_scene(h, w, seed=seed))
    store = torch.zeros(h * w + pad)
    x = store[pad:].view(h, w)
    x.copy_(rgb[..., 0] - rgb[..., 1])
    return _set_corners(x, (1.5, -1.5, -1.0, 1.0))


@pytest.mark.parametrize("shape", SMALL_SHAPES + TILE_SHAPES)
def test_median5_source_bit_exact(median5_lib, shape):
    """The median's device code equals the plain network bit for bit. Each of
    these mutants of the source fails here: the strip's window started one
    row off, the edge blocks' clamp replaced by a reflect, the 16-byte halo
    load shifted by one quad."""
    from pysp_tpu_torch.ops.stencil import median5

    h, w = shape
    x = _chroma_plane(h, w, seed=h + w)
    out = torch.full_like(x, float("nan"))
    median5_lib.emulate(_ptr(x), _ptr(out), h, w)
    assert torch.equal(out, median5(x))


def test_median5_source_unaligned_plane(median5_lib):
    """A plane that starts off a 16-byte boundary takes the path without
    16-byte accesses and gives the plain median."""
    from pysp_tpu_torch.ops.stencil import median5

    h, w = 100, 260
    x = _chroma_plane(h, w, seed=3, pad=1)
    assert x.data_ptr() % 16 != 0
    out = torch.full_like(x, float("nan"))
    median5_lib.emulate(_ptr(x), _ptr(out), h, w)
    assert torch.equal(out, median5(x))


def _lab_planes(h, w, seed, pad=0):
    """CIELAB planes of a scene with outlier corners; ``pad`` floats shift the
    planes' start off their 16-byte alignment."""
    from pysp_tpu_torch.colorimetry.transforms import rgb_to_lab_channels

    rgb = torch.from_numpy(make_scene(h, w, seed=seed))
    store = torch.zeros(3 * h * w + pad)
    lum, a, b = store[pad:].view(3, h, w)
    for dst, src in zip((lum, a, b), rgb_to_lab_channels(*rgb.unbind(-1))):
        dst.copy_(src)
    _set_corners(lum, (90.0, 5.0, 60.0, 20.0))
    _set_corners(a, (40.0, -40.0, 25.0, -25.0))
    return lum, a, b


def _homogeneity_emulated(homogeneity_lib, lum, a, b, is_vertical):
    h, w = lum.shape
    out = torch.full_like(lum, float("nan"))
    homogeneity_lib.emulate(_ptr(lum), _ptr(a), _ptr(b), _ptr(out), h, w, int(is_vertical))
    return out


@pytest.mark.parametrize("is_vertical", [False, True])
@pytest.mark.parametrize("shape", SMALL_SHAPES + TILE_SHAPES)
def test_homogeneity_source_bit_exact(homogeneity_lib, shape, is_vertical):
    """The count's device code equals the plain count bit for bit. Each of
    these mutants of the source fails here: the 16-byte halo load shifted by
    one row, the edge blocks' clamp replaced by a reflect, the run's window
    read one column off."""
    from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels

    h, w = shape
    lum, a, b = _lab_planes(h, w, seed=h)
    out = _homogeneity_emulated(homogeneity_lib, lum, a, b, is_vertical)
    want = homogeneity_map_channels(lum, a, b, is_vertical)
    assert torch.equal(out, want)
    assert 3.0 <= float(out.min()) and float(out.max()) <= 9.0


@pytest.mark.parametrize("is_vertical", [False, True])
def test_homogeneity_source_unaligned_planes(homogeneity_lib, is_vertical):
    """Planes that start off a 16-byte boundary take the path without 16-byte
    accesses and give the plain count."""
    from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels

    lum, a, b = _lab_planes(100, 260, seed=5, pad=1)
    assert lum.data_ptr() % 16 != 0
    out = _homogeneity_emulated(homogeneity_lib, lum, a, b, is_vertical)
    assert torch.equal(out, homogeneity_map_channels(lum, a, b, is_vertical))


# Picks may differ from the plain version's where the box sums tie and cbrtf
# rounds CIELAB differently from the port's cube root: at most this share.
MAX_PICK_FLIPS = 5e-4


def _decision_case(h, w, seed, is_hdr):
    """Candidate fields of a noisy scene (so that the counts vary from row to
    row), the colour parameters and the plain pick."""
    from pysp_tpu_torch.demosaic.ahd import ahd_candidates, ahd_decision_plain

    rng = np.random.default_rng(seed)
    mosaic = mosaic_rggb(make_scene(h, w, seed=seed))
    mosaic = np.clip(mosaic + rng.normal(0, 0.03, mosaic.shape), 0.02, 0.98).astype(np.float32)
    frame = RawFrame.synthetic(mosaic, cam_mat=CAM, wb_neutral=WB, is_hdr=is_hdr, device="cpu")
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    fields = [f.contiguous() for f in ahd_candidates(frame.bayer, wb)]
    return fields, mat, wb, ahd_decision_plain(*fields, mat, wb, is_hdr)


def _ring(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[0], t[-1], t[:, 0], t[:, -1]])


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("shape", [(64, 96), (38, 50), (34, 70), (4, 6), (130, 190),
                                   (62, 122)])
def test_decision_source_against_plain(decision_lib, shape, is_hdr):
    """The pick's device code against ``ahd_decision_plain``, at frames that
    are not a whole number of the kernel's 60x60 tiles; 130x190 has blocks
    whose CIELAB region lies inside the frame (no border code) beside edge
    blocks. On the frame's outermost ring the box sum reads counts across the
    border, mirrored without the edge (reflect-101); a box sum with the
    symmetric border of the counts' own window would pick differently there,
    which the case first shows."""
    from pysp_tpu_torch.demosaic.ahd import _build_homogeneity_map
    from pysp_tpu_torch.ops.stencil import box_sum3, pad_reflect

    h, w = shape
    fields, mat, wb, want = _decision_case(h, w, seed=h + int(is_hdr), is_hdr=is_hdr)
    out = torch.full_like(want, float("nan"))
    params = K._ahd_params(mat, wb)
    decision_lib.emulate(*(_ptr(f) for f in fields), _ptr(params), _ptr(out), h, w,
                         int(is_hdr))
    assert not bool(torch.isnan(out).any())
    assert float((out != want).float().mean()) <= MAX_PICK_FLIPS
    if h < 8:
        return

    def wrong_sum(count):  # the box sum over a symmetric border
        return box_sum3(pad_reflect(count, 1))[1:-1, 1:-1]

    c_h = _build_homogeneity_map(*fields[:3], mat, wb, is_hdr, False)
    c_v = _build_homogeneity_map(*fields[3:], mat, wb, is_hdr, True)
    wrong = (wrong_sum(c_h) < wrong_sum(c_v)).float()
    assert int((_ring(wrong) != _ring(want)).sum()) >= 8
    assert int((_ring(out) != _ring(want)).sum()) <= 1


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (2, 5), (3, 2)])
def test_decision_source_tiny_frames(decision_lib, shape, is_hdr):
    """Frames of 2 and 3 px a side, where every reflect-101 count is a mirror
    of an in-frame one and CIELAB's clamp repeats the edge, on random fields."""
    from pysp_tpu_torch.demosaic.ahd import ahd_decision_plain

    _, mat, wb, _ = _decision_case(8, 8, seed=1, is_hdr=is_hdr)
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    fields = [torch.from_numpy(rng.random(shape).astype(np.float32)) for _ in range(6)]
    out = torch.full(shape, float("nan"))
    params = K._ahd_params(mat, wb)
    decision_lib.emulate(*(_ptr(f) for f in fields), _ptr(params), _ptr(out), shape[0],
                         shape[1], int(is_hdr))
    assert torch.equal(out, ahd_decision_plain(*fields, mat, wb, is_hdr))


def test_decision_source_white_point_is_the_plain_versions():
    """decision.cu divides by cv2's white point as compile-time constants; they
    are the float32 values of colorimetry.transforms._CV2_LAB_WHITE."""
    import re

    from pysp_tpu_torch.colorimetry.transforms import _CV2_LAB_WHITE

    src = (K.CSRC / "decision.cu").read_text()
    found = re.search(r"kWhiteX = F32\(([0-9.e+-]+)\), kWhiteY = F32\(([0-9.e+-]+)\), "
                      r"kWhiteZ = F32\(([0-9.e+-]+)\)", src)
    assert found is not None
    consts = np.array([float(v) for v in found.groups()], np.float32)
    assert consts.tobytes() == np.asarray(_CV2_LAB_WHITE, np.float32).tobytes()


# --- the hot-pixel detector's count multisection ---------------------------------------


@pytest.fixture(scope="module")
def multisection_lib(tmp_path_factory):
    dll = _build(tmp_path_factory, "multisection.cu", "EMULATE_MULTISECTION", n_ptrs=4,
                 n_ints=0)
    dll.emulate.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
    return dll


def _multisection_delta(kind, shape, seed):
    """A case's delta planes; ``core_rows`` is rows 5 to H - 7 of a ``noise``
    stack, a slice whose planes lie a whole stack plane apart, and
    ``nan_bracket`` the ``nan_samples`` planes."""
    if kind == "core_rows":
        full = torch.from_numpy(multisection_case(shape[0] + 12, shape[1], "noise", seed))
        delta = full[:, 5:-7]
        assert not delta.is_contiguous() and delta[0].is_contiguous()
        return delta
    if kind == "nan_bracket":
        kind = "nan_samples"
    return torch.from_numpy(multisection_case(*shape, kind, seed))


def _bracket(delta, kind):
    """The first bracket: ``amin`` / ``amax`` as the detector takes them (NaN
    on a plane that holds a NaN, for ``nan_bracket``), but for
    ``nan_samples`` over the samples that are not NaN, so that NaN samples
    meet numeric mids."""
    if kind == "nan_samples":
        delta = delta.nan_to_num(nan=0.0)
    return delta.amin(dim=(-2, -1)), delta.amax(dim=(-2, -1))


def _same(a, b):
    """Equal, with NaN in the same places (a NaN's payload is not compared)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def _multisection_emulated(multisection_lib, delta, lo, hi, target, iters, branches, blocks,
                           narrow=True):
    """``iters`` launches of the kernel's device code over ``blocks`` blocks a
    plane; returns the bracket (2, P) and the count buffer (iters, P * B + 1)."""
    p, h, w = delta.shape
    bracket = torch.stack([lo, hi]).contiguous()
    counts = torch.zeros((iters, p * branches + 1), dtype=torch.int32)
    for it in range(iters):
        multisection_lib.emulate(_ptr(delta), _ptr(bracket), _ptr(counts[it]),
                                 _ptr(counts[it, p * branches:]), p, h * w, delta.stride(0),
                                 branches, target, int(narrow), blocks)
    return bracket, counts


def _assert_multisection_equal(multisection_lib, delta, q, iters, branches, blocks,
                               kind="noise"):
    """Passes with the kernel's narrowing against ``multisection_plain``, bit
    for bit, and one counting pass against the plain counts; each launch's
    ticket counts every block."""
    from pysp_tpu_torch.correct.bad_pixels import multisection_plain

    p, h, w = delta.shape
    lo, hi = _bracket(delta, kind)
    target = float(np.float32(q * (h * w - 1)))
    bracket, counts = _multisection_emulated(multisection_lib, delta, lo, hi, target, iters,
                                             branches, blocks)
    want_lo, want_hi = multisection_plain(delta, lo, hi, target, iters, branches)
    assert _same(bracket[0], want_lo) and _same(bracket[1], want_hi)
    assert counts[:, -1].tolist() == [blocks * p] * iters

    bracket, counts = _multisection_emulated(multisection_lib, delta, lo, hi, target, 1,
                                             branches, blocks, narrow=False)
    plain_counts = []
    multisection_plain(delta, lo, hi, target, 1, branches,
                       psum_counts=lambda c: plain_counts.append(c) or c)
    assert torch.equal(counts[0, :-1].view(p, branches).long(), plain_counts[0])
    assert torch.equal(bracket.view(torch.int32), torch.stack([lo, hi]).view(torch.int32))
    assert int(counts[0, -1]) == 0


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind,shape", [
    ("noise", (1, 1)), ("noise", (3, 5)),
    ("noise", (61, 133)),   # planes off the 16-byte alignment: a scalar head and tail
    ("noise", (64, 96)),    # 16-byte aligned planes: no head, no tail
    ("constant", (20, 30)), ("at_mids", (61, 133)), ("levels", (40, 50)),
    ("nan_samples", (37, 41)), ("nan_bracket", (37, 41)), ("core_rows", (64, 97)),
])
def test_multisection_source_bit_exact(multisection_lib, kind, shape, blocks):
    """The multisection pass's device code: four passes with its narrowing
    (the last block's) equal ``multisection_plain``'s bracket bit for bit, and
    a counting pass the plain (P, 16, H, W) compare's counts, on one and on
    three blocks a plane (the grid stride, the block-0 head and tail, the
    atomic sums and the ticket), on planes of one sample, of five, off the
    16-byte alignment, constant (lo == hi), with a third of the samples on
    the mids, all ties, with NaN samples (under a numeric bracket, and under
    the NaN bracket that ``amin`` / ``amax`` give such a plane), and a row
    slice read through the plane stride."""
    delta = _multisection_delta(kind, shape, seed=shape[0] * 7 + blocks)
    _assert_multisection_equal(multisection_lib, delta, 0.9999, 4, 16, blocks, kind)


@pytest.mark.parametrize("q,iters,branches", [
    (0.999, 4, 16), (0.5, 6, 16), (0.0, 3, 16), (1.0, 4, 16), (0.9, 4, 5), (0.9, 3, 1),
])
def test_multisection_source_ranks_and_branches(multisection_lib, q, iters, branches):
    """Other ranks (the lowest, the median, the highest), more passes, and
    fewer branches than the kernel's 16 counters, on three blocks a plane."""
    delta = _multisection_delta("at_mids", (45, 70), seed=int(q * 10) + branches)
    _assert_multisection_equal(multisection_lib, delta, q, iters, branches, 3)



# --- CA removal's EAG resamples ---------------------------------------------------------


@pytest.fixture(scope="module")
def eag_lib(tmp_path_factory):
    dll = _build(tmp_path_factory, "eag_resample.cu", "EMULATE_EAG", n_ptrs=3, n_ints=0)
    dll.emulate.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int]
    dll.emulate_upsample.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    dll.emulate_upsample.restype = ctypes.c_int
    return dll


def _fill_emulated(eag_lib, g1, g2, weighted):
    h, w = g1.shape[-2:]
    f1, f2 = g1.reshape(-1, h, w), g2.reshape(-1, h, w)
    assert f1.stride() == f2.stride()
    out = torch.full((f1.shape[0], 2 * h, 2 * w), float("nan"))
    eag_lib.emulate(_ptr(f1), _ptr(f2), _ptr(out), f1.shape[0], h, w, *f1.stride(),
                    int(weighted))
    return out.view(*g1.shape[:-2], 2 * h, 2 * w)


# Quarter planes: one photosite quad, 2x2 up, odd sizes, and sizes around the
# fill's 4 x 64 quads a block.
EAG_FILL_SHAPES = [(1, 1), (2, 2), (1, 7), (3, 5), (4, 64), (5, 65), (37, 133)]


@pytest.mark.parametrize("kind", EAG_KINDS)
@pytest.mark.parametrize("layout", ["mosaic", "burst", "planes"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", EAG_FILL_SHAPES)
def test_eag_fill_source_bit_exact(eag_lib, shape, weighted, layout, kind):
    """The green fill's device code equals ``resample_g_to_full_resolution_plain``
    bit for bit: reading the green phases in place as strided views of a
    mosaic (H, W) or of a burst of three (N, H, W), or as contiguous planes,
    with the direction-weighted infill and the plain mean, on noise, on
    three levels (four equal greens: a sum of deltas of 0), on signed zeros
    and with NaN and infinite samples."""
    from pysp_tpu_torch.core.bayer import bayer_to_rgbg
    from pysp_tpu_torch.demosaic.eag import resample_g_to_full_resolution_plain

    h, w = shape
    lead = (3,) if layout == "burst" else ()
    mosaic = torch.from_numpy(eag_case((*lead, 2 * h, 2 * w), kind, seed=h * 131 + w))
    _, g1, _, g2 = bayer_to_rgbg(mosaic)
    if layout == "planes":
        g1, g2 = g1.contiguous(), g2.contiguous()
    got = _fill_emulated(eag_lib, g1, g2, weighted)
    want = resample_g_to_full_resolution_plain(g1, g2, weighted)
    if kind == "special":
        assert same_bits(got.numpy(), want.numpy())
    else:
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _upsample_case(n, h, w, kind, seed, pad=0):
    """A burst's quarter planes (n, h, w) and greens (n, 2h, 2w); ``pad``
    floats shift both off their 16-byte alignment."""
    sub_store = torch.zeros(n * h * w + pad)
    g_store = torch.zeros(n * 4 * h * w + pad)
    sub = sub_store[pad:].view(n, h, w)
    g = g_store[pad:].view(n, 2 * h, 2 * w)
    sub.copy_(torch.from_numpy(eag_case((n, h, w), kind, seed)))
    g.copy_(torch.from_numpy(eag_case((n, 2 * h, 2 * w), kind, seed + 1)))
    return sub, g


def _upsample_emulated(eag_lib, sub, g, position):
    n, h, w = sub.shape
    out = torch.full_like(g, float("nan"))
    rc = eag_lib.emulate_upsample(_ptr(sub), _ptr(g), _ptr(out), n, h, w, int(position),
                                  K._eag_taps(position).ctypes.data)
    assert rc == 0
    return out


# Quarter planes from 2x2 up, odd, off and on whole tiles (16 x 64 quads), and
# (50, 200): interior blocks that take the 16-byte path beside border blocks.
EAG_UPSAMPLE_SHAPES = [(2, 2), (2, 3), (3, 2), (3, 5), (16, 64), (17, 65), (20, 40),
                       (50, 200), (50, 202), (51, 258)]


@pytest.mark.parametrize("kind", EAG_KINDS)
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("position", K.EAG_POSITIONS)
@pytest.mark.parametrize("shape", EAG_UPSAMPLE_SHAPES)
def test_eag_upsample_source_bit_exact(eag_lib, shape, position, n, kind):
    """The channel upsample's device code equals ``resample_channel_plain``
    bit for bit, for R (TOP_LEFT) and B (BOTTOM_RIGHT), one frame and a
    burst of three, on noise, on three levels, on signed zeros and with NaN
    and infinite samples in both inputs."""
    from pysp_tpu_torch.demosaic.eag import resample_channel_plain

    h, w = shape
    sub, g = _upsample_case(n, h, w, kind, seed=h * 7 + w + n)
    got = _upsample_emulated(eag_lib, sub, g, position)
    want = resample_channel_plain(sub, g, position)
    if kind == "special":
        assert same_bits(got.numpy(), want.numpy())
    else:
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("position", K.EAG_POSITIONS)
def test_eag_upsample_source_unaligned_planes(eag_lib, position):
    """Planes that start off a 16-byte boundary take the path without 16-byte
    accesses in every block and give the same bits as aligned ones."""
    from pysp_tpu_torch.demosaic.eag import resample_channel_plain

    sub, g = _upsample_case(2, 50, 200, "noise", seed=3, pad=1)
    assert sub.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
    got = _upsample_emulated(eag_lib, sub, g, position)
    assert torch.equal(got.view(torch.int32),
                       resample_channel_plain(sub, g, position).view(torch.int32))


def test_eag_upsample_source_refuses_other_positions(eag_lib):
    from pysp_tpu_torch.ops.phase_kernels import BayerPatternPosition

    sub, g = _upsample_case(1, 4, 4, "noise", seed=1)
    out = torch.zeros_like(g)
    taps = K._eag_taps(BayerPatternPosition.TOP_LEFT)
    for position in (BayerPatternPosition.TOP_RIGHT, BayerPatternPosition.BOTTOM_LEFT):
        assert eag_lib.emulate_upsample(_ptr(sub), _ptr(g), _ptr(out), 1, 4, 4, int(position),
                                        taps.ctypes.data) == 1


@pytest.mark.parametrize("position", K.EAG_POSITIONS)
def test_eag_taps_zero_pattern_is_the_kernels(position):
    """The upsample kernel sums each phase's taps over fixed rows and columns
    (``tap_lo`` / ``tap_hi`` in ``csrc/eag_resample.cu``): all three on the
    plane's side of the quad, else the two nearer it. Those are exactly the
    nonzero taps of ``get_rgbg_kernel``, so the kernel skips the zero taps
    that ``_conv_valid`` skips."""
    by, bx = divmod(int(position), 2)

    def span(phase, base):
        return range(3) if phase == base else (range(1, 3) if base == 0 else range(2))

    kernels = K._eag_taps(position)[:36].reshape(4, 3, 3)
    for ty in (0, 1):
        for tx in (0, 1):
            want = np.zeros((3, 3), bool)
            want[np.ix_(list(span(ty, by)), list(span(tx, bx)))] = True
            assert np.array_equal(kernels[2 * ty + tx] != 0, want)
