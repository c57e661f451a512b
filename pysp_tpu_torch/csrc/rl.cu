// One Richardson-Lucy (RL) iteration with a separable symmetric PSF, over
// every channel of a float32 image:
//
//   out = est * blur(img / (blur(est) + 1e-25))
//
// blur = H pass then V pass of the 1-D taps, taps ascending, multiply then
// add, each pass with a symmetric (cv2.BORDER_REFLECT, edge repeated) border.
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::rl_deconv_pallas (body
// _rl_iter_kernel). Plain version beside it:
// pysp_tpu_torch/ops/cuda_kernels.py::rl_plain.
//
// What bounds it on an H100: device memory. Per pixel and iteration it reads
// est and img and writes est (12 B) against 4 passes of k taps (2 flops each),
// about 8 flops per byte at k = 7, below the card's 20 flops per byte of
// float32 ALU rate to memory rate. So each input is read once per iteration
// and the rest of the design keeps the four passes off the shared-memory
// pipe, which would otherwise bound them (k loads for every output of every
// pass):
//
// - The reach r = taps / 2 is a template parameter for r = 1..6 (sigma up to
//   2), so the tap loops unroll and the taps are constants of the
//   instruction stream. A block computes a kTH x kTW tile (64 x 64): it
//   loads est with a 2r halo and img with an r halo into shared memory, and
//   both blurs, the ratio and the product run there; only the tile of
//   est * factor is written.
// - A thread makes four neighbouring outputs of a pass from one window of
//   4 + 2r inputs held in registers: along the row for an H pass, where the
//   window comes in by 16-byte loads, and down the column for a V pass, where
//   the lanes of a warp sit on neighbouring columns. That is (4 + 2r) / 4
//   loads for an output instead of 2r + 1.
// - The cells of each region are dealt to the threads by for_cells, whose
//   2-D position advances by additions, and a thread keeps eight loads of a
//   region in flight before it stores the first (one load a thread left the
//   memory system a third full).
// - The blur of est feeds the ratio from registers, the ratio replaces img in
//   place, and est for the product is the copy in shared memory.
//
// Larger reaches (up to 32) take a generic kernel with the reach as a
// run-time value: a 32x32 tile, one output a thread and pass.
//
// The border. The second blur reads the RATIO ARRAY mirrored at the frame
// border, ratio[-1-k] = ratio[k], which is not the ratio evaluated at the
// reflected coordinates (blur(est) there sums its taps in the other order).
// So the ratio of an out-of-frame cell is copied from the mirrored in-frame
// cell, which lies inside the same block's region. Only blocks whose region
// crosses the frame edge pay for index maps. Every operation is the plain
// loop's, in its order, with FMA contraction off (-fmad=false) and IEEE
// division, so the result is bit-identical to it.
//
// Layout: element (c, y, x) sits at c * plane_stride + (y * W + x) * pix_stride
// in est, img and out, so (H, W), (C, H, W) and (H, W, C) all launch as they
// lie. Takes 3 <= taps <= 65, odd, and H, W >= 2 r (the caller's gate).
#include "tile_loops.cuh"

// The fixed-reach kernels' tile and the block; tools/time_kernels.py builds
// other shapes beside these through the macros.
#ifndef RL_TILE_H
#define RL_TILE_H 64
#endif
#ifndef RL_TILE_W
#define RL_TILE_W 64
#endif
#ifndef RL_THREADS
#define RL_THREADS 384
#endif
// The reaches with a kernel of their own: X(1) .. X(kMaxFixedReach).
#define RL_FIXED_REACHES(X) X(1) X(2) X(3) X(4) X(5) X(6)

namespace {

constexpr int kThreads = RL_THREADS;
constexpr int kMaxTaps = 65;
constexpr int kMaxFixedReach = 6;
constexpr int kLoads = 8;  // loads a thread keeps in flight while a region comes in
constexpr int kTile = 32;                        // the generic kernel's tile
constexpr int kTH = RL_TILE_H, kTW = RL_TILE_W;  // the fixed-reach kernels' tile
static_assert(kTH % 4 == 0 && kTW % 4 == 0, "a thread makes runs of 4 outputs");

struct Taps {
  float w[kMaxTaps];
};

// Symmetric border index; cells beyond the 2r halo that no output needs are
// clamped into the frame so their loads stay in bounds.
__device__ __forceinline__ int mirror(int i, int n) {
  if (i < 0) i = -1 - i;
  if (i >= n) i = 2 * n - 1 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// --- fixed reach ---------------------------------------------------------------

// A block's regions for reach R. Runs of four need widths and heights that
// are multiples of 4, so the mid region (blur, ratio) carries kPad spare
// columns and rows on its far side when 2 R is not one; they hold real values
// that no output reads.
template <int R>
struct Geo {
  static constexpr int kPad = (4 - (2 * R) % 4) % 4;
  static constexpr int kVec = (4 + 2 * R + 3) / 4;  // 16-byte loads of a window
  static constexpr int MH = kTH + 2 * R + kPad, MW = kTW + 2 * R + kPad;  // mid
  static constexpr int EH = MH + 2 * R, EW = MW + 2 * R;                  // est
  static constexpr int ES = MW - 4 + 4 * kVec;  // est row stride: the last window fits
  static constexpr int kFloats = EH * ES + EH * MW + MH * MW;
  static_assert(ES >= EW && ES % 4 == 0 && MW % 4 == 0 && MH % 4 == 0, "");
};

// Four neighbouring outputs of a 1-D pass from one window: acc[j] is the sum
// over t of w[t] * v[j + t], taps ascending, multiply then add.
template <int R>
__device__ __forceinline__ void pass4(const Taps& taps, const float* v, float* acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = taps.w[0] * v[j];
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) a = a + taps.w[t] * v[j + t];
    acc[j] = a;
  }
}

// An H pass of four outputs: the window starts at the 16-byte aligned `src`.
template <int R>
__device__ __forceinline__ void pass4_row(const Taps& taps, const float* src,
                                          float* dst) {
  float v[4 * Geo<R>::kVec];
#pragma unroll
  for (int k = 0; k < Geo<R>::kVec; ++k) {
    const Vec4 t = *(const Vec4*)(src + 4 * k);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[4 * k + i] = t.v[i];
  }
  Vec4 acc;
  pass4<R>(taps, v, acc.v);
  *(Vec4*)dst = acc;
}

// A V pass of four outputs down a column of row stride `stride`.
template <int R>
__device__ __forceinline__ void pass4_column(const Taps& taps, const float* src,
                                             int stride, float* acc) {
  float v[4 + 2 * R];
#pragma unroll
  for (int t = 0; t < 4 + 2 * R; ++t) v[t] = src[t * stride];
  pass4<R>(taps, v, acc);
}

template <int R, bool EDGE>
__device__ __forceinline__ void rl_block(const float* __restrict__ e,
                                         const float* __restrict__ im,
                                         float* __restrict__ o, int H, int W,
                                         int pix_stride, const Taps& taps,
                                         float* smem) {
  using G = Geo<R>;
  float* const s_e = smem;                 // est, EH x ES
  float* const s_b = s_e + G::EH * G::ES;  // H pass of est, then of the ratio
  float* const s_i = s_b + G::EH * G::MW;  // img, then the ratio, MH x MW
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  // The element of `src` at the region cell (r, c) of a region that starts
  // `halo` before the tile, through the symmetric border in an edge block.
  const auto fetch = [&](const float* src, int halo, int r, int c) {
    int gy = y0 - halo + r, gx = x0 - halo + c;
    if (EDGE) {
      gy = mirror(gy, H);
      gx = mirror(gx, W);
    }
    return src[((size_t)gy * W + gx) * pix_stride];
  };
  for_cells_loading<kLoads>(
      G::EH, G::EW, [&](int r, int c) { return fetch(e, 2 * R, r, c); },
      [&](int r, int c, float v) { s_e[r * G::ES + c] = v; });
  for_cells_loading<kLoads>(
      G::MH, G::MW, [&](int r, int c) { return fetch(im, R, r, c); },
      [&](int r, int c, float v) { s_i[r * G::MW + c] = v; });
  __syncthreads();

  // H pass of est: every est row, the mid columns.
  for_cells(G::EH, G::MW / 4, [&](int r, int q) {
    pass4_row<R>(taps, s_e + r * G::ES + 4 * q, s_b + r * G::MW + 4 * q);
  });
  __syncthreads();

  // V pass: blur(est) over the mid region, and the ratio in place of img.
  for_cells(G::MH / 4, G::MW, [&](int q, int c) {
    float blur[4];
    pass4_column<R>(taps, s_b + 4 * q * G::MW + c, G::MW, blur);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* const cell = s_i + (4 * q + j) * G::MW + c;
      *cell = *cell / (blur[j] + 1e-25f);
    }
  });
  __syncthreads();

  // An out-of-frame cell takes the mirrored in-frame cell's ratio; cells more
  // than R outside the frame feed no output and are skipped.
  if (EDGE) {
    for_cells(G::MH, G::MW, [&](int r, int c) {
      const int gy = y0 - R + r, gx = x0 - R + c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) return;
      if (gy < -R || gy >= H + R || gx < -R || gx >= W + R) return;
      const int mr = mirror(gy, H) - (y0 - R), mc = mirror(gx, W) - (x0 - R);
      s_i[r * G::MW + c] = s_i[mr * G::MW + mc];
    });
    __syncthreads();
  }

  // H pass of the ratio: the mid rows that the tile reads, the tile columns.
  for_cells(kTH + 2 * R, kTW / 4, [&](int r, int q) {
    pass4_row<R>(taps, s_i + r * G::MW + 4 * q, s_b + r * kTW + 4 * q);
  });
  __syncthreads();

  // V pass and the product with est.
  for_cells(kTH / 4, kTW, [&](int q, int c) {
    const int x = x0 + c;
    if (x >= W) return;
    float factor[4];
    pass4_column<R>(taps, s_b + 4 * q * kTW + c, kTW, factor);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = y0 + 4 * q + j;
      if (y >= H) break;
      o[((size_t)y * W + x) * pix_stride] =
          s_e[(2 * R + 4 * q + j) * G::ES + 2 * R + c] * factor[j];
    }
  });
}

template <int R>
__global__ void __launch_bounds__(kThreads)
rl_fixed_kernel(const float* __restrict__ est, const float* __restrict__ img,
                float* __restrict__ out, int H, int W, long long plane_stride,
                int pix_stride, Taps taps) {
  extern __shared__ __align__(16) float smem[];
  using G = Geo<R>;
  const size_t base = (size_t)blockIdx.z * (size_t)plane_stride;
  const int ey = blockIdx.y * kTH - 2 * R, ex = blockIdx.x * kTW - 2 * R;
  const bool edge = ey < 0 || ex < 0 || ey + G::EH > H || ex + G::EW > W;
  if (edge) {
    rl_block<R, true>(est + base, img + base, out + base, H, W, pix_stride, taps, smem);
  } else {
    rl_block<R, false>(est + base, img + base, out + base, H, W, pix_stride, taps, smem);
  }
}

// --- any reach up to 32 ----------------------------------------------------------

__host__ __device__ inline int generic_smem_floats(int r) {
  const int n_est = kTile + 4 * r, n_mid = kTile + 2 * r;
  return n_est * n_est + n_est * n_mid + n_mid * n_mid;
}

__global__ void __launch_bounds__(kThreads)
rl_iter_kernel(const float* __restrict__ est, const float* __restrict__ img,
               float* __restrict__ out, int H, int W, long long plane_stride,
               int pix_stride, Taps taps, int r) {
  extern __shared__ __align__(16) float smem[];
  const int k = 2 * r + 1;
  const int n_est = kTile + 4 * r;   // est region: rows/cols [t0 - 2r, t0 + kTile + 2r)
  const int n_mid = kTile + 2 * r;   // blur/ratio region: [t0 - r, t0 + kTile + r)
  float* const s_a = smem;                         // est, then blur(est), then H pass of ratio
  float* const s_b = s_a + n_est * n_est;          // H pass of est, then ratio
  float* const s_img = s_b + n_est * n_mid;        // img over the mid region

  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.z * (size_t)plane_stride;
  const float* const e = est + base;
  const float* const im = img + base;

  for_cells_loading<kLoads>(
      n_est, n_est,
      [&](int row, int col) {
        const int gy = mirror(y0 - 2 * r + row, H), gx = mirror(x0 - 2 * r + col, W);
        return e[((size_t)gy * W + gx) * pix_stride];
      },
      [&](int row, int col, float v) { s_a[row * n_est + col] = v; });
  for_cells_loading<kLoads>(
      n_mid, n_mid,
      [&](int row, int col) {
        const int gy = mirror(y0 - r + row, H), gx = mirror(x0 - r + col, W);
        return im[((size_t)gy * W + gx) * pix_stride];
      },
      [&](int row, int col, float v) { s_img[row * n_mid + col] = v; });
  __syncthreads();

  // H pass of est: rows of the est region, columns of the mid region.
  for_cells(n_est, n_mid, [&](int row, int col) {
    const float* src = s_a + row * n_est + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t];
    s_b[row * n_mid + col] = acc;
  });
  __syncthreads();

  // V pass: blur(est) over the mid region, into s_a (est is read from global
  // memory at the end).
  for_cells(n_mid, n_mid, [&](int row, int col) {
    const float* src = s_b + row * n_mid + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t * n_mid];
    s_a[row * n_mid + col] = acc;
  });
  __syncthreads();

  // Ratio over the mid region, into s_b. An out-of-frame cell takes the
  // mirrored in-frame cell's ratio; cells more than r outside the frame feed
  // no output and are skipped.
  for_cells(n_mid, n_mid, [&](int row, int col) {
    const int gy = y0 - r + row, gx = x0 - r + col;
    if (gy < -r || gy >= H + r || gx < -r || gx >= W + r) return;
    const int ly = mirror(gy, H) - (y0 - r), lx = mirror(gx, W) - (x0 - r);
    const int m = ly * n_mid + lx;
    s_b[row * n_mid + col] = s_img[m] / (s_a[m] + 1e-25f);
  });
  __syncthreads();

  // H pass of the ratio: mid rows, tile columns, into s_a.
  for_cells(n_mid, kTile, [&](int row, int col) {
    const float* src = s_b + row * n_mid + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t];
    s_a[row * kTile + col] = acc;
  });
  __syncthreads();

  // V pass and the product with est.
  for_cells(kTile, kTile, [&](int ty, int tx) {
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) return;
    const float* src = s_a + ty * kTile + tx;
    float factor = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) factor = factor + taps.w[t] * src[t * kTile];
    const size_t o = base + ((size_t)y * W + x) * pix_stride;
    out[o] = est[o] * factor;
  });
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <int R>
int launch_fixed(const float* est, const float* img, float* out, int H, int W,
                 int C, long long plane_stride, int pix_stride, const Taps& t,
                 cudaStream_t stream) {
  static int ready_device = -1;
  constexpr int bytes = Geo<R>::kFloats * (int)sizeof(float);
  cudaError_t err = allow_shared_memory(rl_fixed_kernel<R>, bytes, &ready_device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, C);
  rl_fixed_kernel<R><<<grid, kThreads, bytes, stream>>>(est, img, out, H, W,
                                                        plane_stride, pix_stride, t);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one iteration for C channels on `stream`; returns the cudaError_t
// of the launch (cudaErrorInvalidValue for taps the kernel does not take).
extern "C" int pysp_rl_iter(const float* est, const float* img, float* out,
                            int H, int W, int C, long long plane_stride,
                            int pix_stride, const float* taps, int n_taps,
                            void* stream) {
  if (n_taps < 3 || n_taps > kMaxTaps || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < kMaxTaps; ++i) t.w[i] = i < n_taps ? taps[i] : 0.0f;
  const int r = n_taps / 2;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
#define RL_LAUNCH(R) \
  case R: return launch_fixed<R>(est, img, out, H, W, C, plane_stride, pix_stride, t, s);
    RL_FIXED_REACHES(RL_LAUNCH)
#undef RL_LAUNCH
  }
  static int ready_device = -1;
  const int bytes = generic_smem_floats(r) * (int)sizeof(float);
  cudaError_t err = allow_shared_memory(
      rl_iter_kernel, generic_smem_floats(kMaxTaps / 2) * (int)sizeof(float),
      &ready_device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, C);
  rl_iter_kernel<<<grid, kThreads, bytes, s>>>(est, img, out, H, W, plane_stride,
                                               pix_stride, t, r);
  return (int)cudaGetLastError();
}
#endif
