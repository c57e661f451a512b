// One AHD chroma-median postprocess stage on three (H, W) float32 planes:
//
//   r' = med5(r - g) + g
//   b' = med5(b - g) + g
//   g' = (med5(g - r') + med5(g - b') + r' + b') * 0.5
//
// every 5x5 median with a replicate border, as cv2.medianBlur(src, 5).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::postprocess_color_pallas_channels
// (body _postprocess_kernel). Plain version beside it:
// pysp_tpu_torch/demosaic/ahd.py::postprocess_color_channels.
//
// What bounds it on an H100: the four median networks, about 800 min/max per
// pixel against 24 bytes read and 12 written, so the ALUs, not device memory.
// The design keeps every intermediate in shared memory or registers: a block
// reads r, g, b once for a 32x32 tile plus a 4 px halo (replicate-clamped
// addresses at the image edge), computes r' and b' over the tile plus 2 px into
// shared memory, and reads the outer medians' inputs g - r', g - b' at clamped
// coordinates, which is the replicate border the plain version gives them. The
// arithmetic is the plain version's adds and one multiply by 0.5 in the same
// order, so the result is bit-identical to it.
#include "median5.cuh"

namespace {

constexpr int kTile = 32;          // output tile edge
constexpr int kThreads = 256;
constexpr int kIn = kTile + 8;     // r, g, b with a 4 px halo
constexpr int kMid = kTile + 4;    // r', b' with a 2 px halo

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__global__ void __launch_bounds__(kThreads)
postprocess_kernel(const float* __restrict__ r, const float* __restrict__ g,
                   const float* __restrict__ b, float* __restrict__ r_out,
                   float* __restrict__ g_out, float* __restrict__ b_out,
                   int H, int W) {
  __shared__ float s_r[kIn * kIn];
  __shared__ float s_g[kIn * kIn];
  __shared__ float s_b[kIn * kIn];
  __shared__ float s_rp[kMid * kMid];
  __shared__ float s_bp[kMid * kMid];

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < kIn * kIn; i += blockDim.x) {
    const int gy = clamp_index(y0 - 4 + i / kIn, H);
    const int gx = clamp_index(x0 - 4 + i % kIn, W);
    const size_t o = (size_t)gy * W + gx;
    s_r[i] = r[o];
    s_g[i] = g[o];
    s_b[i] = b[o];
  }
  __syncthreads();

  // r' and b' at mid cell (my, mx), which is in-buffer cell (my + 2, mx + 2).
  for (int i = threadIdx.x; i < kMid * kMid; i += blockDim.x) {
    const int my = i / kMid, mx = i % kMid;
    const float gc = s_g[(my + 2) * kIn + mx + 2];
    float w[32];
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int o = (my + k / 5) * kIn + mx + k % 5;
      w[k] = s_r[o] - s_g[o];
    }
    s_rp[i] = median25(w) + gc;
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int o = (my + k / 5) * kIn + mx + k % 5;
      w[k] = s_b[o] - s_g[o];
    }
    s_bp[i] = median25(w) + gc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    // Mid cell of each clamped neighbour: the replicate border of g - r' and
    // g - b'. The clamped neighbour stays within 2 px of (y, x), inside the
    // mid region.
    float w[32];
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int qy = clamp_index(y + k / 5 - 2, H) - y0 + 2;
      const int qx = clamp_index(x + k % 5 - 2, W) - x0 + 2;
      w[k] = s_g[(qy + 2) * kIn + qx + 2] - s_rp[qy * kMid + qx];
    }
    const float med_gr = median25(w);
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int qy = clamp_index(y + k / 5 - 2, H) - y0 + 2;
      const int qx = clamp_index(x + k % 5 - 2, W) - x0 + 2;
      w[k] = s_g[(qy + 2) * kIn + qx + 2] - s_bp[qy * kMid + qx];
    }
    const float med_gb = median25(w);
    const int c = (ty + 2) * kMid + tx + 2;
    const float rp = s_rp[c];
    const float bp = s_bp[c];
    const size_t o = (size_t)y * W + x;
    r_out[o] = rp;
    g_out[o] = (med_gr + med_gb + rp + bp) * 0.5f;
    b_out[o] = bp;
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches one stage on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_postprocess_color(const float* r, const float* g,
                                      const float* b, float* r_out,
                                      float* g_out, float* b_out, int H, int W,
                                      void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  postprocess_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      r, g, b, r_out, g_out, b_out, H, W);
  return (int)cudaGetLastError();
}
#endif
