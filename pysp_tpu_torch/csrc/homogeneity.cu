// One direction's AHD homogeneity count on (H, W) float32 L, a, b planes: for
// every pixel, how many of its 3x3 neighbours lie within the adaptive bounds
// that its two neighbours along the direction set (values 3..9), with a
// symmetric border (cv2.BORDER_REFLECT).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::homogeneity_map_pallas (body
// _homogeneity_kernel). Plain version beside it:
// pysp_tpu_torch/demosaic/homogeneity.py::homogeneity_map_channels.
//
// What bounds it on an H100: bytes. A pixel reads 12 bytes and writes 4, for
// some 70 subtractions, multiplies, adds and compares, so the design moves the
// bytes as fast as the card lets it and keeps everything else off their path:
//
// - A block counts a kTH x kTW tile (32 x 64). It loads the three planes over
//   the tile plus one row above and below and four columns on each side, so
//   that every row of the region starts on a 16-byte boundary (1.2x the
//   tile's bytes from L2; the halo's rows and columns are the neighbouring
//   blocks' and come from L2, not device memory).
// - The loads are 16 bytes wide, three cells of three planes in flight a
//   thread (for_cells_loading), dealt to threads by additions, no division a
//   cell: a block's whole region is in flight at once.
// - A thread counts a run of four pixels of one row from a register window of
//   3 rows x 6 columns a plane, read from shared memory three 16-byte loads a
//   row, and stores the four as one 16-byte store. At 64 registers four blocks
//   share an SM. Runs of two rows (fewer shared loads, 80 registers, three
//   blocks), 64x64 tiles, 128-thread blocks, cp.async copies of the region,
//   persistent blocks that copy the next tile while counting this one, and
//   windows read straight from device memory, were no faster over both
//   directions (PERF.md, section 6), nor were L2 prefetch and streaming-store
//   hints: the loads and stores alone take about as long as the whole kernel,
//   at 1.9-2.4 TB/s where torch's copy of the three planes reaches 2.7-2.9
//   TB/s.
// - The border is a template parameter. A block whose region lies inside a
//   frame whose rows are 16-byte aligned runs without a clamp or a guard; any
//   other block loads the tile plus 1 px through clamped addresses (a
//   symmetric border of reach 1 is a clamp) and stores only the in-frame
//   counts. Any H, W >= 1 goes.
//
// The count is ahd_lab.cuh's, shared with the AHD and decision kernels:
// subtractions, squares, sums, max and compares in the plain version's order,
// built without FMA contraction (-fmad=false), so it is bit-identical to the
// plain version's at every shape.
#include "ahd_lab.cuh"
#include "tile_loops.cuh"

// The tile, the block and the blocks an SM that the register cap is set for; tools/time_kernels.py builds other values
// beside these through the macros, to compare them on one card in one call.
#ifndef HOMO_TILE_H
#define HOMO_TILE_H 32
#endif
#ifndef HOMO_TILE_W
#define HOMO_TILE_W 64
#endif
#ifndef HOMO_THREADS
#define HOMO_THREADS 256
#endif
#ifndef HOMO_MIN_BLOCKS
#define HOMO_MIN_BLOCKS 4
#endif

namespace {

constexpr int kTH = HOMO_TILE_H, kTW = HOMO_TILE_W;  // output tile: rows, columns
constexpr int kThreads = HOMO_THREADS;
constexpr int kLoads = 3;              // cells of three planes in flight a thread
constexpr int kPadX = 4;               // columns loaded on each side (1 needed)
constexpr int kRowW = kTW + 2 * kPadX; // floats a region row
constexpr int kRows = kTH + 2;         // the tile plus one row above and below
constexpr int kPlane = kRows * kRowW;
static_assert(kTW % 4 == 0, "runs of four pixels tile the tile's rows");

// A plane's region in shared memory, indexed in tile coordinates (ly, lx) in
// [-1, kTH] x [-kPadX, kTW + kPadX).
struct Tile {
  float* p;
  __device__ __forceinline__ float& at(int ly, int lx) const {
    return p[(ly + 1) * kRowW + lx + kPadX];
  }
};

// A plane's 3 x 6 window in registers, indexed in run coordinates (y, x) in
// [-1, 1] x [-1, 4]; every index is a constant once the run's loop is
// unrolled.
struct Window {
  float v[3][6];
  __device__ __forceinline__ float at(int y, int x) const { return v[y + 1][x + 1]; }
};

struct Lab {
  float l, a, b;
};

struct Lab4 {
  Vec4 l, a, b;
};

// The window of the run whose top-left pixel is (ly, lx), lx a multiple of 4.
__device__ __forceinline__ void load_window(const Tile& t, int ly, int lx, Window& w) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* row = &t.at(ly + r - 1, lx - 4);
    const Vec4 left = *(const Vec4*)row, mid = *(const Vec4*)(row + 4),
               right = *(const Vec4*)(row + 8);
    w.v[r][0] = left.v[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) w.v[r][1 + k] = mid.v[k];
    w.v[r][5] = right.v[0];
  }
}

template <bool kVertical, bool FAST>
__device__ __forceinline__ void homogeneity_block(
    const float* __restrict__ lum, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ out, float* smem, int H, int W) {
  const Tile L{smem}, A{smem + kPlane}, B{smem + 2 * kPlane};
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  if (FAST) {
    for_cells_loading<kLoads>(
        kRows, kRowW / 4,
        [&](int row, int q) {
          const size_t o = (size_t)(y0 + row - 1) * W + (x0 + 4 * q - kPadX);
          return Lab4{*(const Vec4*)(lum + o), *(const Vec4*)(a + o), *(const Vec4*)(b + o)};
        },
        [&](int row, int q, const Lab4& v) {
          *(Vec4*)&L.at(row - 1, 4 * q - kPadX) = v.l;
          *(Vec4*)&A.at(row - 1, 4 * q - kPadX) = v.a;
          *(Vec4*)&B.at(row - 1, 4 * q - kPadX) = v.b;
        });
  } else {
    for_cells_loading<4>(
        kRows, kTW + 2,
        [&](int row, int c) {
          const size_t o = (size_t)clamp_index(y0 + row - 1, H) * W +
                           clamp_index(x0 + c - 1, W);
          return Lab{lum[o], a[o], b[o]};
        },
        [&](int row, int c, const Lab& v) {
          L.at(row - 1, c - 1) = v.l;
          A.at(row - 1, c - 1) = v.a;
          B.at(row - 1, c - 1) = v.b;
        });
  }
  __syncthreads();

  for_cells(kTH, kTW / 4, [&](int ly, int q) {
    const int lx = 4 * q, y = y0 + ly, x = x0 + lx;
    // a run with no pixel in the frame has nothing to count
    if (!FAST && (y >= H || x >= W)) return;
    Window wl, wa, wb;
    load_window(L, ly, lx, wl);
    load_window(A, ly, lx, wa);
    load_window(B, ly, lx, wb);
    Vec4 count;
#pragma unroll
    for (int j = 0; j < 4; ++j) count.v[j] = homogeneity(wl, wa, wb, 0, j, kVertical);
    if (FAST) {
      *(Vec4*)(out + (size_t)y * W + x) = count;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x + j < W) out[(size_t)y * W + x + j] = count.v[j];
      }
    }
  });
}

// One block counts one tile. `aligned` says that every row of the four planes
// starts on a 16-byte boundary (rows_aligned).
template <bool kVertical>
__global__ void __launch_bounds__(kThreads, HOMO_MIN_BLOCKS)
homogeneity_kernel(const float* __restrict__ lum, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ out, int H, int W,
                   int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bool inside =
      y0 >= 1 && x0 >= kPadX && y0 + kTH + 1 <= H && x0 + kTW + kPadX <= W;
  if (inside && aligned) {
    homogeneity_block<kVertical, true>(lum, a, b, out, smem, H, W);
  } else {
    homogeneity_block<kVertical, false>(lum, a, b, out, smem, H, W);
  }
}

}  // namespace

#undef F32

#ifdef __CUDACC__
// Launches the count on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_homogeneity(const float* lum, const float* a,
                                const float* b, float* out, int H, int W,
                                int vertical, void* stream) {
  static int ready_device[2] = {-1, -1};
  const int bytes = 3 * kPlane * (int)sizeof(float);
  const auto kernel = vertical ? homogeneity_kernel<true> : homogeneity_kernel<false>;
  cudaError_t err = allow_shared_memory(kernel, bytes, &ready_device[vertical != 0]);
  if (err != cudaSuccess) return (int)err;
  const void* const planes[4] = {lum, a, b, out};
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      lum, a, b, out, H, W, (int)rows_aligned(W, planes, 4));
  return (int)cudaGetLastError();
}
#endif
