// 5x5 median of one (H, W) float32 plane with a replicate border, as
// cv2.medianBlur(src, 5).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::median5_pallas (body
// _median5_kernel, network _median5_field). Plain version beside it:
// pysp_tpu_torch/ops/stencil.py::median5.
//
// What bounds it on an H100: the median network, 202 min/max per pixel against
// 4 bytes read and 4 written, so the ALUs, not device memory. A block loads a
// 32x32 tile plus a 2 px halo into shared memory once, every address clamped
// into the plane (which is the replicate border), and each thread runs the
// network of median5.cuh on its pixels' 25 values in registers. A median is
// one of its inputs, so the result is bit-identical to the plain version's
// shared-column network. Any H and W of at least 1 go: the clamp serves planes
// smaller than the window and tiles that overhang the plane alike.
#include "median5.cuh"

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kThreads = 256;
constexpr int kIn = kTile + 4;   // the tile with a 2 px halo

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void __launch_bounds__(kThreads)
median5_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
               int W) {
  extern __shared__ float smem[];
  float* const s = smem;  // kIn * kIn

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < kIn * kIn; i += blockDim.x) {
    const int gy = clamp_index(y0 - 2 + i / kIn, H);
    const int gx = clamp_index(x0 - 2 + i % kIn, W);
    s[i] = x[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, xx = x0 + tx;
    if (y >= H || xx >= W) continue;
    float w[32];
#pragma unroll
    for (int k = 0; k < 25; ++k) w[k] = s[(ty + k / 5) * kIn + tx + k % 5];
    out[(size_t)y * W + xx] = median25(w);
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches the median on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_median5(const float* x, float* out, int H, int W,
                            void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  median5_kernel<<<grid, kThreads, kIn * kIn * sizeof(float),
                   (cudaStream_t)stream>>>(x, out, H, W);
  return (int)cudaGetLastError();
}
#endif
