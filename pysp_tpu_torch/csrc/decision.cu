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
// What bounds it on an H100: issuing instructions. A pixel reads 24 bytes and
// writes 4, and costs two CIELAB conversions (six powf, six cbrtf, six to
// twelve IEEE divisions) and two counts, about 1200 instructions on this
// card (PERF.md counts them from the SASS), five times its bytes' time at the
// issue rate. So the design spends as few instructions a pick as the exact
// arithmetic allows and keeps the SM full. A block of 512 threads (four an
// SM, 32 registers a thread) computes a 60x60 tile of picks in shared memory:
// CIELAB of one direction over the tile plus 2 px (64x64 cells, eight for
// each thread, two loaded before converting: 1.14 conversions a pick, no
// guard, no idle lane), that direction's counts over the tile plus 1 px, then
// the same for the other direction, which stores the difference of the two
// counts as a byte; then each thread takes four picks down a column from the
// row sums of those differences (sum_h - sum_v < 0 is sum_h < sum_v: small
// integers, exact in any order). a and b are stored side by side, so a count
// reads a neighbour's chroma with one 8-byte load, and counts in ints. The
// parameter block's entries sit in registers and cv2's white point is a
// constant (a division by a constant costs less, and Y's division by 1.0
// goes); srgb_decode and lab_f branch around the side their select drops
// (ahd_lab.cuh, kSkip), so a warp of dark or of bright pixels issues one side.
//
// Two borders meet here. CIELAB is pointwise, so its symmetric border is a
// clamped read of the fields. The box sum, though, reads the COUNT with a
// reflect-101 border: the count at row -1 is the count computed at row +1,
// not a count of reflected CIELAB. A count cell outside the frame is
// therefore computed at its mirrored in-frame position, from that position's
// own (clamped) neighbours. Only blocks whose CIELAB region leaves the frame
// run that code (a template parameter); the others index without a clamp,
// a mirror or a bound.
//
// The counts and box sums are small integers and exact; CIELAB goes through
// cbrtf and powf, which round differently from torch's, so a pick can differ
// from the plain version's where the two sums tie (see PERF.md).
#include "ahd_lab.cuh"
#include "tile_loops.cuh"

namespace {

constexpr int kTH = 60, kTW = 60;   // output tile
constexpr int kThreads = 512;
constexpr int kLH = kTH + 4, kLW = kTW + 4;  // CIELAB with a 2 px halo
constexpr int kCH = kTH + 2, kCW = kTW + 2;  // counts with a 1 px halo
constexpr int kStrip = 4;           // picks a thread takes down a column
constexpr int kInFlight = 2;        // CIELAB cells a thread loads before converting
static_assert(kTH % kStrip == 0, "whole strips");
// Every thread takes the same number of CIELAB cells (no guard) and a cell's
// row and column are a shift and a mask.
static_assert(kLW == 64 && (kLH * kLW) % (kInFlight * kThreads) == 0, "even CIELAB rounds");

constexpr int kSmemBytes = 3 * kLH * kLW * (int)sizeof(float) + kCH * kCW;

struct alignas(8) Chroma {
  float a, b;
};

// cv2's D65 white, colorimetry/transforms.py::_CV2_LAB_WHITE as float32 (a
// test holds the two equal): a constant divisor costs fewer instructions than
// one read from the parameter block, and the division by Y's 1.0 goes.
constexpr float kWhiteX = F32(0.950456), kWhiteY = F32(1.0), kWhiteZ = F32(1.088754);

// The entries of the parameter block that CIELAB reads, in registers, and
// the white point as constants.
struct LabParams {
  float mat[9], wb[3], labm[9];
  __device__ __forceinline__ float operator[](int i) const {
    return i < P_WB ? mat[i] : i < P_H ? wb[i - P_WB] : i < P_LABW ? labm[i - P_LABM]
         : i == P_LABW ? kWhiteX : i == P_LABW + 1 ? kWhiteY : kWhiteZ;
  }
};

// CIELAB in tile coordinates, over [-2, kTH + 2) x [-2, kTW + 2): L, and a
// and b side by side, so that a count reads a cell's chroma with one 8-byte
// load (the two accessors load the same pair; the compiler keeps one).
struct LabTile {
  const float* p;
  __device__ __forceinline__ float at(int ly, int lx) const {
    return p[(ly + 2) * kLW + lx + 2];
  }
};
template <bool kB>
struct ChromaTile {
  const Chroma* p;
  __device__ __forceinline__ float at(int ly, int lx) const {
    const Chroma c = p[(ly + 2) * kLW + lx + 2];
    return kB ? c.b : c.a;
  }
};

// Reflect-101 of an index one step outside [0, n): -1 -> 1, n -> n - 2.
__device__ __forceinline__ int mirror_index(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
}

struct Rgb {
  float r, g, b;
};

// The block's picks. kEdge: its CIELAB region leaves the frame.
template <bool kEdge>
__device__ __forceinline__ void decide(const float* const (&f)[6], const LabParams& prm,
                                       float* __restrict__ out, int H, int W, int is_hdr,
                                       float* smem) {
  Chroma* const s_ab = reinterpret_cast<Chroma*>(smem);
  float* const s_l = smem + 2 * kLH * kLW;
  signed char* const s_d = reinterpret_cast<signed char*>(s_l + kLH * kLW);
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const LabTile L{s_l};
  const ChromaTile<false> A{s_ab};
  const ChromaTile<true> B{s_ab};

#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const float* const fr = f[3 * dir];
    const float* const fg = f[3 * dir + 1];
    const float* const fb = f[3 * dir + 2];
    for (int i = threadIdx.x; i < kLH * kLW; i += kInFlight * blockDim.x) {
      Rgb v[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int j = i + k * blockDim.x;
        const int r = j / kLW, c = j % kLW;
        const int gy = kEdge ? clamp_index(y0 - 2 + r, H) : y0 - 2 + r;
        const int gx = kEdge ? clamp_index(x0 - 2 + c, W) : x0 - 2 + c;
        const int o = gy * W + gx;
        v[k] = Rgb{fr[o], fg[o], fb[o]};
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int j = i + k * blockDim.x;
        Chroma ab;
        to_lab<true>(v[k].r, v[k].g, v[k].b, prm, is_hdr, s_l[j], ab.a, ab.b);
        s_ab[j] = ab;
      }
    }
    __syncthreads();
    auto store = [&](int i, int count) {
      s_d[i] = (signed char)(dir ? s_d[i] - count : count);
    };
    if (kEdge) {
      for_cells(kCH, kCW, [&](int r, int c) {
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        int count = 0;  // beyond the box sum's reach: never read
        if (gy <= H && gx <= W)
          count = homogeneity<int>(L, A, B, mirror_index(gy, H) - y0,
                                   mirror_index(gx, W) - x0, dir == 1);
        store(r * kCW + c, count);
      });
    } else {
      for_cells(kCH, kCW, [&](int r, int c) {
        store(r * kCW + c, homogeneity<int>(L, A, B, r - 1, c - 1, dir == 1));
      });
    }
    __syncthreads();
  }

  // sum_h < sum_v: the box sum of the count differences below 0.
  for_cells(kTH / kStrip, kTW, [&](int s, int tx) {
    const int ty0 = s * kStrip;
    int rs[kStrip + 2];
#pragma unroll
    for (int k = 0; k < kStrip + 2; ++k) {
      const signed char* const row = s_d + (ty0 + k) * kCW + tx;
      rs[k] = (int)row[0] + (int)row[1] + (int)row[2];
    }
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int y = y0 + ty0 + k, x = x0 + tx;
      if (kEdge && (y >= H || x >= W)) continue;
      out[(size_t)y * W + x] = rs[k] + rs[k + 1] + rs[k + 2] < 0 ? 1.0f : 0.0f;
    }
  });
}

__global__ void __launch_bounds__(kThreads)
decision_kernel(const float* __restrict__ r_h, const float* __restrict__ g_h,
                const float* __restrict__ b_h, const float* __restrict__ r_v,
                const float* __restrict__ g_v, const float* __restrict__ b_v,
                const float* __restrict__ params, float* __restrict__ out,
                int H, int W, int is_hdr) {
  extern __shared__ float smem[];
  const float* const f[6] = {r_h, g_h, b_h, r_v, g_v, b_v};
  LabParams prm;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    prm.mat[k] = params[P_MAT + k];
    prm.labm[k] = params[P_LABM + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) prm.wb[k] = params[P_WB + k];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  if (y0 >= 2 && x0 >= 2 && y0 + kTH + 2 <= H && x0 + kTW + 2 <= W)
    decide<false>(f, prm, out, H, W, is_hdr, smem);
  else
    decide<true>(f, prm, out, H, W, is_hdr, smem);
}

#undef F32

}  // namespace

#ifdef __CUDACC__
// Launches the pick on `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_ahd_decision(const float* r_h, const float* g_h,
                                 const float* b_h, const float* r_v,
                                 const float* g_v, const float* b_v,
                                 const float* params, float* out, int H, int W,
                                 int is_hdr, void* stream) {
  if (H < 2 || W < 2 || (long long)H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static int ready_device = -1;
  const cudaError_t err = allow_shared_memory(decision_kernel, kSmemBytes, &ready_device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  decision_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      r_h, g_h, b_h, r_v, g_v, b_v, params, out, H, W, is_hdr);
  return (int)cudaGetLastError();
}
#endif
