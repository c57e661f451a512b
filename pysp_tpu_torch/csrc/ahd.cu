// Whole AHD demosaic of a canonical-RGGB float32 mosaic in one kernel, with
// the optional develop colour tail (clip -> cam->lin-sRGB -> sRGB gamma).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::ahd_mega_pallas (body
// _ahd_mega_kernel, math in pysp_tpu/demosaic/ahd_band.py::ahd_band_quads and
// color_tail_quads). Plain version beside it:
// pysp_tpu_torch/demosaic/ahd.py::ahd_channels followed by
// pysp_tpu_torch/pipeline/develop.py::_color_tail_channels.
//
// What bounds it on an H100: arithmetic, not bytes. A pixel is read once (4 B)
// and written once (12 B), while AHD does two CIELAB conversions (six powf and
// six cbrtf), two homogeneity counts and, per chroma-median stage, four 5x5
// median networks of about 200 min/max each.
//
// Design. One block computes one 32x32 output tile in full-resolution
// coordinates; there is no phase-plane split and no output assembly. It loads
// the WB-scaled mosaic for the tile plus a halo of 4*S + 5 pixels (S =
// postprocess stages), which is the reach of the whole stage chain, and runs
// every stage on shared memory, each stage over a region that shrinks by that
// stage's own reach, separated by __syncthreads():
//
//   mosaic (halo 4S+5) -> directional greens (4S+3) -> R/B upsample + green HF,
//   CIELAB per direction (4S+2) -> homogeneity counts (4S+1) -> box sum, H/V
//   pick (4S) -> S chroma-median stages (4 px each) -> tail -> store.
//
// The two directions' CIELAB fields share one buffer; the picked and staged
// fields reuse the buffers of fields already consumed (shared memory for S = 1:
// 64 KB, three blocks per SM). The output is written in its final layout:
// (H, W, 3) interleaved or three (H, W) planes.
//
// Pixels outside the image are read at clamped addresses that keep the CFA
// phase (a replicate border of each phase plane, as the TPU wrapper's edge
// padding). Outputs within 4S+5 px of the image border therefore differ from
// the plain version; the caller overwrites a 2*(4+2S) px frame with the plain
// version's border strips. Everywhere else every operation is the plain
// version's, in its order, with FMA contraction off (-fmad=false): the
// outputs differ only where cbrtf and powf round differently from torch's
// (see PERF.md) and flip an H/V pick at an exact homogeneity tie.
#include "ahd_lab.cuh"
#include "median5.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

// Output flags.
enum { F_TAIL = 1, F_CLIP = 2, F_GAMMA = 4, F_INTERLEAVED = 8 };

__host__ __device__ constexpr int cells(int e) {
  return (kTile + 2 * e) * (kTile + 2 * e);
}

template <int S>
__host__ __device__ constexpr int smem_floats() {
  // mosaic, two greens, three CIELAB, two counts
  return cells(4 * S + 5) + 2 * cells(4 * S + 3) + 3 * cells(4 * S + 2) +
         2 * cells(4 * S + 1);
}

// A square field over the tile plus a halo of e pixels, indexed in tile
// coordinates (ly, lx) in [-e, kTile + e).
struct Field {
  float* p;
  int e;
  __device__ __forceinline__ float& at(int ly, int lx) const {
    return p[(ly + e) * (kTile + 2 * e) + lx + e];
  }
};

__device__ __forceinline__ Field field(float* p, int e) { return Field{p, e}; }

// Clamp a row (or column) index into [0, n) keeping its parity; n is even.
__device__ __forceinline__ int clamp_phase(int v, int n) {
  if (v < 0) return v & 1;
  if (v >= n) return n - 2 + (v & 1);
  return v;
}

// g - gaussian_blur3(g) at (ly, lx); taps accumulate in row-major order.
__device__ __forceinline__ float green_hf(const Field& g, const float* prm,
                                          int ly, int lx) {
  float acc = g.at(ly - 1, lx - 1) * prm[P_G3];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    acc = acc + g.at(ly + k / 3 - 1, lx + k % 3 - 1) * prm[P_G3 + k];
  }
  return g.at(ly, lx) - acc;
}

// Phase-kernel upsample of the R (off = 0) or B (off = 1) plane to the pixel
// (ly, lx) of phase (py, px): a 3x3 correlation on the quarter-res plane,
// row-major taps. Zero taps add +0 and change no sum.
__device__ __forceinline__ float upsample(const Field& m, const float* k,
                                          int ly, int lx, int py, int px,
                                          int off) {
  const float* kk = k + 9 * (2 * py + px);
  const int by = ly - py - 2 + off, bx = lx - px - 2 + off;
  float acc = m.at(by, bx) * kk[0];
#pragma unroll
  for (int t = 1; t < 9; ++t) {
    acc = acc + m.at(by + 2 * (t / 3), bx + 2 * (t % 3)) * kk[t];
  }
  return acc;
}

// One chroma-median stage: inputs valid over the tile plus e_in pixels;
// r', b' are written over e_in - 2 and g' over e_in - 4.
__device__ void median_stage(const Field& r, const Field& g, const Field& b,
                             int e_in, const Field& r_out, const Field& b_out,
                             const Field& g_out) {
  float w[32];
  const int e1 = e_in - 2, n1 = kTile + 2 * e1;
  for (int i = threadIdx.x; i < n1 * n1; i += blockDim.x) {
    const int ly = i / n1 - e1, lx = i % n1 - e1;
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int y = ly + k / 5 - 2, x = lx + k % 5 - 2;
      w[k] = r.at(y, x) - g.at(y, x);
    }
    r_out.at(ly, lx) = median25(w) + g.at(ly, lx);
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int y = ly + k / 5 - 2, x = lx + k % 5 - 2;
      w[k] = b.at(y, x) - g.at(y, x);
    }
    b_out.at(ly, lx) = median25(w) + g.at(ly, lx);
  }
  __syncthreads();
  const int e2 = e_in - 4, n2 = kTile + 2 * e2;
  for (int i = threadIdx.x; i < n2 * n2; i += blockDim.x) {
    const int ly = i / n2 - e2, lx = i % n2 - e2;
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int y = ly + k / 5 - 2, x = lx + k % 5 - 2;
      w[k] = g.at(y, x) - r_out.at(y, x);
    }
    const float med_gr = median25(w);
#pragma unroll
    for (int k = 0; k < 25; ++k) {
      const int y = ly + k / 5 - 2, x = lx + k % 5 - 2;
      w[k] = g.at(y, x) - b_out.at(y, x);
    }
    const float med_gb = median25(w);
    g_out.at(ly, lx) =
        (med_gr + med_gb + r_out.at(ly, lx) + b_out.at(ly, lx)) * 0.5f;
  }
  __syncthreads();
}

__device__ __forceinline__ float gamma_encode(float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  return x <= F32(0.0031308)
             ? x * F32(12.92)
             : F32(1.055) * powf(fmaxf(x, F32(1e-12)), F32(1.0 / 2.4)) -
                   F32(0.055);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
ahd_kernel(const float* __restrict__ bayer, const float* __restrict__ params,
           float* __restrict__ out, int H, int W, int is_hdr, int flags) {
  constexpr int eM = 4 * S + 5, eG = eM - 2, eL = eM - 3, eC = eM - 4;
  constexpr int eP = 4 * S;
  extern __shared__ float smem[];
  __shared__ float prm[P_COUNT];

  float* const buf_m = smem;
  float* const buf_gh = buf_m + cells(eM);
  float* const buf_gv = buf_gh + cells(eG);
  float* const buf_lab = buf_gv + cells(eG);
  float* const buf_ch = buf_lab + 3 * cells(eL);
  float* const buf_cv = buf_ch + cells(eC);

  const Field M = field(buf_m, eM);
  const Field GH = field(buf_gh, eG), GV = field(buf_gv, eG);
  const Field L0 = field(buf_lab, eL), L1 = field(buf_lab + cells(eL), eL),
              L2 = field(buf_lab + 2 * cells(eL), eL);
  const Field CH = field(buf_ch, eC), CV = field(buf_cv, eC);

  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < P_COUNT; i += blockDim.x) prm[i] = params[i];
  __syncthreads();

  // WB-scaled mosaic; CFA phase from the (even-aligned) global position.
  {
    const int n = kTile + 2 * eM;
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int ly = i / n - eM, lx = i % n - eM;
      const int y = y0 + ly, x = x0 + lx;
      const int py = y & 1, px = x & 1;
      const int c = py == px ? 2 * py : 1;  // R at (0,0), G, B at (1,1)
      const size_t o = (size_t)clamp_phase(y, H) * W + clamp_phase(x, W);
      M.at(ly, lx) = bayer[o] * prm[P_WB + c];
    }
  }
  __syncthreads();

  // Directional green fields: the mosaic at G sites, the 5-tap filter along
  // the row (H) or column (V) at R and B sites.
  {
    const float* h = prm + P_H;
    const int n = kTile + 2 * eG;
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int ly = i / n - eG, lx = i % n - eG;
      const int py = (y0 + ly) & 1, px = (x0 + lx) & 1;
      float gh = M.at(ly, lx), gv = gh;
      if (py == px) {
        gh = M.at(ly, lx - 2) * h[0];
        gv = M.at(ly - 2, lx) * h[0];
#pragma unroll
        for (int k = 1; k < 5; ++k) {
          gh = gh + M.at(ly, lx + k - 2) * h[k];
          gv = gv + M.at(ly + k - 2, lx) * h[k];
        }
      }
      GH.at(ly, lx) = gh;
      GV.at(ly, lx) = gv;
    }
  }
  __syncthreads();

  // Per direction: candidate (r, g, b) -> CIELAB, then homogeneity counts.
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const Field& G = dir ? GV : GH;
    const int nl = kTile + 2 * eL;
    for (int i = threadIdx.x; i < nl * nl; i += blockDim.x) {
      const int ly = i / nl - eL, lx = i % nl - eL;
      const int py = (y0 + ly) & 1, px = (x0 + lx) & 1;
      const float hf = green_hf(G, prm, ly, lx);
      const float r = upsample(M, prm + P_KR, ly, lx, py, px, 0) + hf;
      const float b = upsample(M, prm + P_KB, ly, lx, py, px, 1) + hf;
      to_lab(r, G.at(ly, lx), b, prm, is_hdr, L0.at(ly, lx), L1.at(ly, lx),
             L2.at(ly, lx));
    }
    __syncthreads();
    const Field& C = dir ? CV : CH;
    const int nc = kTile + 2 * eC;
    for (int i = threadIdx.x; i < nc * nc; i += blockDim.x) {
      const int ly = i / nc - eC, lx = i % nc - eC;
      C.at(ly, lx) = homogeneity(L0, L1, L2, ly, lx, dir == 1);
    }
    __syncthreads();
  }

  // H/V pick on the box-summed counts (exact integers); the picked fields
  // reuse the CIELAB buffer.
  const Field R0 = field(buf_lab, eP), G0 = field(buf_lab + cells(eL), eP),
              B0 = field(buf_lab + 2 * cells(eL), eP);
  {
    const int n = kTile + 2 * eP;
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int ly = i / n - eP, lx = i % n - eP;
      const int py = (y0 + ly) & 1, px = (x0 + lx) & 1;
      const float pick = box_sum3(CH, ly, lx) < box_sum3(CV, ly, lx) ? 1.0f : 0.0f;
      const float inv = 1.0f - pick;
      const float hf_h = green_hf(GH, prm, ly, lx);
      const float hf_v = green_hf(GV, prm, ly, lx);
      const float up_r = upsample(M, prm + P_KR, ly, lx, py, px, 0);
      const float up_b = upsample(M, prm + P_KB, ly, lx, py, px, 1);
      R0.at(ly, lx) = (up_r + hf_h) * pick + (up_r + hf_v) * inv;
      G0.at(ly, lx) = GH.at(ly, lx) * pick + GV.at(ly, lx) * inv;
      B0.at(ly, lx) = (up_b + hf_h) * pick + (up_b + hf_v) * inv;
    }
  }
  __syncthreads();

  // Chroma-median stages; each writes into buffers already consumed.
  Field Rf = R0, Gf = G0, Bf = B0;
  if constexpr (S >= 1) {
    const Field R1 = field(buf_gh, eP - 2), B1 = field(buf_gv, eP - 2),
                G1 = field(buf_ch, eP - 4);
    median_stage(R0, G0, B0, eP, R1, B1, G1);
    Rf = R1; Gf = G1; Bf = B1;
  }
  if constexpr (S >= 2) {
    const Field R2 = field(buf_lab, eP - 6),
                B2 = field(buf_lab + cells(eL), eP - 6),
                G2 = field(buf_lab + 2 * cells(eL), eP - 8);
    median_stage(Rf, Gf, Bf, eP - 4, R2, B2, G2);
    Rf = R2; Gf = G2; Bf = B2;
  }

  const float* m = prm + P_MAT;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    float r = Rf.at(ty, tx), g = Gf.at(ty, tx), b = Bf.at(ty, tx);
    if (flags & F_TAIL) {
      if (flags & F_CLIP) {
        r = fminf(fmaxf(r, 0.0f), 1.0f);
        g = fminf(fmaxf(g, 0.0f), 1.0f);
        b = fminf(fmaxf(b, 0.0f), 1.0f);
      }
      const float ir = m[0] * r + m[1] * g + m[2] * b;
      const float ig = m[3] * r + m[4] * g + m[5] * b;
      const float ib = m[6] * r + m[7] * g + m[8] * b;
      r = ir; g = ig; b = ib;
      if (flags & F_GAMMA) {
        r = gamma_encode(r);
        g = gamma_encode(g);
        b = gamma_encode(b);
      }
    }
    const size_t o = (size_t)y * W + x;
    if (flags & F_INTERLEAVED) {
      out[3 * o] = r;
      out[3 * o + 1] = g;
      out[3 * o + 2] = b;
    } else {
      const size_t plane = (size_t)H * W;
      out[o] = r;
      out[plane + o] = g;
      out[2 * plane + o] = b;
    }
  }
}

#undef F32

}  // namespace

#ifdef __CUDACC__
namespace {

template <int S>
int launch_ahd(const float* bayer, const float* params, float* out, int H,
               int W, int is_hdr, int flags, cudaStream_t stream) {
  const int bytes = smem_floats<S>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ahd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  ahd_kernel<S><<<grid, kThreads, bytes, stream>>>(bayer, params, out, H, W,
                                                    is_hdr, flags);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the AHD kernel for `stages` chroma-median stages (0..2) on
// `stream`; returns the cudaError_t of the launch.
extern "C" int pysp_ahd(const float* bayer, const float* params, float* out,
                        int H, int W, int stages, int is_hdr, int flags,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (stages) {
    case 0: return launch_ahd<0>(bayer, params, out, H, W, is_hdr, flags, s);
    case 1: return launch_ahd<1>(bayer, params, out, H, W, is_hdr, flags, s);
    case 2: return launch_ahd<2>(bayer, params, out, H, W, is_hdr, flags, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
