// The fused AHD direction pick: from the six candidate fields (r, g, b of the
// horizontal and of the vertical interpolation, each (H, W) float32) to the
// (H, W) field of 1.0 where the horizontal candidate wins and 0.0 elsewhere.
// Per direction: WB and cam -> lin-sRGB, CIELAB (HDR: luma as L, tonemapped
// chroma), the homogeneity count over the 3x3 window with a symmetric border,
// the 3x3 box sum of the counts with a reflect-101 border; then
// sum_h < sum_v.
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::ahd_decision_pallas (body
// _ahd_decision_kernel). Plain version beside it:
// pysp_tpu_torch/demosaic/ahd.py::ahd_decision_plain.
//
// What bounds it on an H100: arithmetic. A pixel reads 24 bytes and writes 4,
// and costs two CIELAB conversions (six powf, six cbrtf) and two counts. A
// block computes a 32x32 tile of picks entirely in shared memory: CIELAB of
// one direction over the tile plus 2 px, that direction's counts over the tile
// plus 1 px, then the same buffers again for the other direction, then the
// box sums and the compare. The six fields are read once, straight into the
// CIELAB conversion; nothing but the pick goes back to device memory.
//
// Two borders meet here. CIELAB is pointwise, so its symmetric border is a
// clamped read of the fields. The box sum, though, reads the COUNT with a
// reflect-101 border: the count at row -1 is the count computed at row +1,
// not a count of reflected CIELAB. A count cell outside the frame is
// therefore computed at its mirrored in-frame position, from that position's
// own (clamped) neighbours.
//
// The counts and box sums are small integers and exact; CIELAB goes through
// cbrtf and powf, which round differently from torch's, so a pick can differ
// from the plain version's where the two sums tie (see PERF.md).
#include "ahd_lab.cuh"

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kThreads = 256;
constexpr int kLab = kTile + 4;  // CIELAB with a 2 px halo
constexpr int kCnt = kTile + 2;  // counts with a 1 px halo

// Tiles indexed in tile coordinates: CIELAB over [-2, kTile + 2), counts over
// [-1, kTile + 1).
struct LabTile {
  const float* p;
  __device__ __forceinline__ float at(int ly, int lx) const {
    return p[(ly + 2) * kLab + lx + 2];
  }
};
struct CountTile {
  const float* p;
  __device__ __forceinline__ float at(int ly, int lx) const {
    return p[(ly + 1) * kCnt + lx + 1];
  }
};

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// Reflect-101 of an index one step outside [0, n): -1 -> 1, n -> n - 2.
__device__ __forceinline__ int mirror_index(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

__global__ void __launch_bounds__(kThreads)
decision_kernel(const float* __restrict__ r_h, const float* __restrict__ g_h,
                const float* __restrict__ b_h, const float* __restrict__ r_v,
                const float* __restrict__ g_v, const float* __restrict__ b_v,
                const float* __restrict__ params, float* __restrict__ out,
                int H, int W, int is_hdr) {
  extern __shared__ float smem[];
  __shared__ float prm[P_COUNT];
  float* const s_l = smem;
  float* const s_a = s_l + kLab * kLab;
  float* const s_b = s_a + kLab * kLab;
  float* const s_ch = s_b + kLab * kLab;
  float* const s_cv = s_ch + kCnt * kCnt;

  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < P_COUNT; i += blockDim.x) prm[i] = params[i];
  __syncthreads();

  const LabTile L{s_l}, A{s_a}, B{s_b};
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const float* const fr = dir ? r_v : r_h;
    const float* const fg = dir ? g_v : g_h;
    const float* const fb = dir ? b_v : b_h;
    for (int i = threadIdx.x; i < kLab * kLab; i += blockDim.x) {
      const int gy = clamp_index(y0 - 2 + i / kLab, H);
      const int gx = clamp_index(x0 - 2 + i % kLab, W);
      const size_t o = (size_t)gy * W + gx;
      to_lab(fr[o], fg[o], fb[o], prm, is_hdr, s_l[i], s_a[i], s_b[i]);
    }
    __syncthreads();
    float* const cnt = dir ? s_cv : s_ch;
    for (int i = threadIdx.x; i < kCnt * kCnt; i += blockDim.x) {
      const int gy = y0 - 1 + i / kCnt, gx = x0 - 1 + i % kCnt;
      float c = 0.0f;  // beyond the box sum's reach: never read
      if (gy <= H && gx <= W) {
        c = homogeneity(L, A, B, mirror_index(gy, H) - y0,
                        mirror_index(gx, W) - x0, dir == 1);
      }
      cnt[i] = c;
    }
    __syncthreads();
  }

  const CountTile CH{s_ch}, CV{s_cv};
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    out[(size_t)y * W + x] =
        box_sum3(CH, ty, tx) < box_sum3(CV, ty, tx) ? 1.0f : 0.0f;
  }
}

#undef F32

constexpr int kSmemFloats = 3 * kLab * kLab + 2 * kCnt * kCnt;

}  // namespace

#ifdef __CUDACC__
// Launches the pick on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_ahd_decision(const float* r_h, const float* g_h,
                                 const float* b_h, const float* r_v,
                                 const float* g_v, const float* b_v,
                                 const float* params, float* out, int H, int W,
                                 int is_hdr, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  decision_kernel<<<grid, kThreads, kSmemFloats * sizeof(float),
                    (cudaStream_t)stream>>>(r_h, g_h, b_h, r_v, g_v, b_v,
                                            params, out, H, W, is_hdr);
  return (int)cudaGetLastError();
}
#endif
