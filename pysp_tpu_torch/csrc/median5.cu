// 5x5 median of one (H, W) float32 plane with a replicate border, as
// cv2.medianBlur(src, 5).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::median5_pallas (body
// _median5_kernel, network _median5_field). Plain version beside it:
// pysp_tpu_torch/ops/stencil.py::median5.
//
// What bounds it on an H100: the rate of min and max, not device memory. A
// pixel reads 4 bytes and writes 4, and an exact median of 25 costs 105.5
// min/max in a strip of eight (median5_columns.cuh), which issue at half the
// rate of an add on this card: 0.15 ms at 24 MP, 2.6 times the bytes' 0.057
// ms. So the design spends as few min/max and as little else as it can:
//
// - A block of 128 threads computes a kTH x kTW tile (16 x 64), one strip a
//   thread, eight blocks an SM: smaller blocks than 32 x 64 with 256 threads
//   (four an SM) gave 5-15% in every visit of two calls (PERF.md, section
//   6). It loads the plane over the tile plus 2 px into shared memory once,
//   with 16-byte global loads, several in flight a thread (for_cells_loading).
// - A thread takes the medians of a strip of kStrip (8) neighbouring pixels
//   from one 5 x (kStrip + 4) window in registers (16-byte shared loads: the
//   region's origin is laid so that every window starts on a 16-byte
//   boundary) and shares the window's sorted columns and column pairs between
//   the kStrip (median5_strip, the plain version's own network, which the AHD
//   and postprocess kernels run in strips of four); it stores them 16 bytes at
//   a time. Strips of eight take 13% fewer min/max than strips of four and
//   spill 100 bytes at 64 registers; they were the faster in every visit of
//   two calls.
// - The border is a template parameter. A block whose region (the tile plus
//   2 px rows and 4 px columns) lies inside a frame whose rows are 16-byte
//   aligned runs without a clamp or a guard. Any other block loads through
//   clamped addresses, which is the replicate border, and stores the in-frame
//   medians only. Any H, W >= 1 goes: a 1-wide plane's window repeats one
//   column five times.
//
// A median is one of its inputs and the network is the plain version's, so the
// result is the plain version's bit for bit, signed zeros included.
#include "median5_columns.cuh"
#include "tile_loops.cuh"

// The tile, the strip, the block and the blocks an SM that the register cap
// is set for; tools/time_kernels.py builds other values beside these through
// the macros, to compare them on one card in one call.
#ifndef MED5_TILE_H
#define MED5_TILE_H 16
#endif
#ifndef MED5_TILE_W
#define MED5_TILE_W 64
#endif
#ifndef MED5_STRIP
#define MED5_STRIP 8
#endif
#ifndef MED5_THREADS
#define MED5_THREADS 128
#endif
#ifndef MED5_MIN_BLOCKS
#define MED5_MIN_BLOCKS 8
#endif

namespace {

constexpr int kTH = MED5_TILE_H, kTW = MED5_TILE_W;  // output tile: rows, columns
constexpr int kStrip = MED5_STRIP;  // medians a thread takes from one window
constexpr int kThreads = MED5_THREADS;
constexpr int kHalo = 2;
constexpr int kLoads = 4;               // 16-byte loads in flight a thread
constexpr int kRowW = kTW + 2 * kHalo;  // floats a region row
constexpr int kRows = kTH + 2 * kHalo;
static_assert(kStrip % 4 == 0 && kTW % kStrip == 0, "strips of 4 k pixels tile a row");

// The region in shared memory, indexed in tile coordinates (ly, lx) in
// [-2, kTH + 2) x [-2, kTW + 2). A strip's window starts at lx - 2 for lx a
// multiple of 4, which is a multiple of 4 floats from the region's start.
struct Region {
  float* p;
  __device__ __forceinline__ float& at(int ly, int lx) const {
    return p[(ly + kHalo) * kRowW + lx + kHalo];
  }
};

struct Float2 {
  float x, y;
};

template <bool FAST>
__device__ __forceinline__ void median5_block(const float* __restrict__ x,
                                              float* __restrict__ out, float* smem,
                                              int H, int W) {
  const Region R{smem};
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  if (FAST) {
    // Aligned quads over columns [-4, kTW + 4): each lands as two 8-byte
    // halves, of which the outermost two fall outside the region.
    constexpr int kQuads = kTW / 4 + 2;
    for_cells_loading<kLoads>(
        kRows, kQuads,
        [&](int row, int q) {
          return *(const Vec4*)(x + (size_t)(y0 + row - kHalo) * W + (x0 + 4 * q - 4));
        },
        [&](int row, int q, const Vec4& v) {
          float* dst = &R.at(row - kHalo, 4 * q - 4);
          if (q > 0) *(Float2*)dst = Float2{v.v[0], v.v[1]};
          if (q < kQuads - 1) *(Float2*)(dst + 2) = Float2{v.v[2], v.v[3]};
        });
  } else {
    for_cells_loading<4>(
        kRows, kRowW,
        [&](int row, int c) {
          return x[(size_t)clamp_index(y0 + row - kHalo, H) * W +
                   clamp_index(x0 + c - kHalo, W)];
        },
        [&](int row, int c, float v) { R.at(row - kHalo, c - kHalo) = v; });
  }
  __syncthreads();

  for_cells(kTH, kTW / kStrip, [&](int ly, int q) {
    const int lx = kStrip * q;
    const int y = y0 + ly, xx = x0 + lx;
    // a strip with no pixel in the frame has nothing to compute
    if (!FAST && (y >= H || xx >= W)) return;
    float col[kStrip + 4][5];
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const float* row = &R.at(ly + dy - 2, lx - 2);
#pragma unroll
      for (int h = 0; h < kStrip / 4 + 1; ++h) {
        const Vec4 v = *(const Vec4*)(row + 4 * h);
#pragma unroll
        for (int k = 0; k < 4; ++k) col[4 * h + k][dy] = v.v[k];
      }
    }
    float med[kStrip];
    median5_strip<kStrip>(col, med);
    if (FAST) {
#pragma unroll
      for (int h = 0; h < kStrip / 4; ++h) {
        *(Vec4*)(out + (size_t)y * W + xx + 4 * h) =
            Vec4{{med[4 * h], med[4 * h + 1], med[4 * h + 2], med[4 * h + 3]}};
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        if (xx + j < W) out[(size_t)y * W + xx + j] = med[j];
      }
    }
  });
}

// One block computes one tile. `aligned` says that the rows of both planes
// start on 16-byte boundaries (rows_aligned).
__global__ void __launch_bounds__(kThreads, MED5_MIN_BLOCKS)
median5_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
               int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bool inside = y0 >= kHalo && x0 >= 4 && y0 + kTH + kHalo <= H && x0 + kTW + 4 <= W;
  if (inside && aligned) {
    median5_block<true>(x, out, smem, H, W);
  } else {
    median5_block<false>(x, out, smem, H, W);
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches the median on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_median5(const float* x, float* out, int H, int W, void* stream) {
  const void* const planes[2] = {x, out};
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  median5_kernel<<<grid, kThreads, kRows * kRowW * sizeof(float), (cudaStream_t)stream>>>(
      x, out, H, W, (int)rows_aligned(W, planes, 2));
  return (int)cudaGetLastError();
}
#endif
