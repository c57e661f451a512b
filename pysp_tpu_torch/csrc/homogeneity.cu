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
// some 60 subtractions, multiplies, adds and compares. A block loads the
// three planes for a 32x32 tile plus a 1 px halo into shared memory once,
// addresses clamped into the plane (a symmetric border of reach 1 is a clamp),
// and counts through the code shared with the AHD kernel (ahd_lab.cuh). Only
// subtractions, squares, sums, max and compares, in the plain version's order
// and without FMA contraction (-fmad=false), so the count is bit-identical to
// the plain version's.
#include "ahd_lab.cuh"

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kThreads = 256;
constexpr int kIn = kTile + 2;   // the tile with a 1 px halo

// A plane's tile with its halo, indexed in tile coordinates [-1, kTile].
struct Tile {
  const float* p;
  __device__ __forceinline__ float at(int ly, int lx) const {
    return p[(ly + 1) * kIn + lx + 1];
  }
};

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void __launch_bounds__(kThreads)
homogeneity_kernel(const float* __restrict__ lum, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ out, int H,
                   int W, int vertical) {
  extern __shared__ float smem[];
  float* const s_l = smem;
  float* const s_a = s_l + kIn * kIn;
  float* const s_b = s_a + kIn * kIn;

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < kIn * kIn; i += blockDim.x) {
    const int gy = clamp_index(y0 - 1 + i / kIn, H);
    const int gx = clamp_index(x0 - 1 + i % kIn, W);
    const size_t o = (size_t)gy * W + gx;
    s_l[i] = lum[o];
    s_a[i] = a[o];
    s_b[i] = b[o];
  }
  __syncthreads();

  const Tile L{s_l}, A{s_a}, B{s_b};
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    out[(size_t)y * W + x] = homogeneity(L, A, B, ty, tx, vertical != 0);
  }
}

#undef F32

}  // namespace

#ifdef __CUDACC__
// Launches the count on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_homogeneity(const float* lum, const float* a,
                                const float* b, float* out, int H, int W,
                                int vertical, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  homogeneity_kernel<<<grid, kThreads, 3 * kIn * kIn * sizeof(float),
                       (cudaStream_t)stream>>>(lum, a, b, out, H, W, vertical);
  return (int)cudaGetLastError();
}
#endif
