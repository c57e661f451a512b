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
// medians, whose min and max issue at half the rate of an add.
//
// Design. One block of kThreads threads computes one kTH x kTW output tile
// (64 x 64) in full-resolution coordinates; there is no phase-plane split and
// no output assembly. It loads the WB-scaled mosaic for the tile plus a halo
// of 4*S + 5 pixels (S = postprocess stages), which is the reach of the whole
// stage chain, and runs every stage on shared memory, each stage over a
// region that shrinks by that stage's own reach, separated by
// __syncthreads():
//
//   mosaic (halo 4S+5) -> directional greens (4S+3) -> R/B upsample + green HF,
//   CIELAB per direction (4S+2) -> homogeneity counts (4S+1) -> box sum, H/V
//   pick (4S) -> S chroma-median stages (4 px each) -> tail -> store.
//
// - The tile is as large as shared memory allows (184 KB at S = 1 and 225 KB
//   at S = 2 of the 227 KB a block may use): the halo is recomputed by every
//   block, and at 64 x 64 and S = 1 CIELAB runs over 1.4x the tile's pixels
//   where a 32 x 32 tile takes 1.9x.
// - The cells of each region are dealt to the threads in row-major order by
//   for_cells, whose 2-D position advances by additions: no division by the
//   region's width per cell, and full warps whatever that width.
// - A chroma-median stage writes each difference field (r - g, b - g, then
//   g - r', g - b') once, and a thread takes the four medians of a strip of
//   four pixels from one 5x8 window in registers, with the columns' sorts and
//   merges shared between them (median_strip).
// - The two directions' CIELAB fields share one buffer; the picked, staged and
//   difference fields reuse the buffers of fields already consumed. The
//   output is written in its final layout: (H, W, 3) interleaved or three
//   (H, W) planes.
//
// The border. The plain version applies a border rule to each intermediate
// array: symmetric on the four phase planes (the green filter) and on CIELAB
// (the count's window), reflect-101 on the full-res greens (the 3x3 blur), on
// the quarter-res R and B planes (the upsample) and on the counts (the box
// sum), replicate on the medians' inputs. A halo tile that extends each field
// past the frame from the extended previous field gets none of these right,
// so a block whose region crosses the frame edge (tiles that overhang the
// frame included) computes each stage at in-frame cells only, and a read of
// an out-of-frame cell goes through that stage's index map to the in-frame
// cell of the same field, which lies inside the block's region. The maps are
// a template parameter of the block's body (EDGE), so the blocks of the
// interior pay nothing for them. The output is the whole frame, its border
// included, down to frames of 4 x 4.
//
// Every operation is the plain version's, in its order, with FMA contraction
// off (-fmad=false): the outputs differ only where cbrtf and powf round
// differently from torch's (see PERF.md) and flip an H/V pick at an exact
// homogeneity tie.
#include "ahd_lab.cuh"
#include "median5_columns.cuh"
#include "tile_loops.cuh"

// The tile and the block; tools/time_kernels.py builds other shapes beside
// these through the macros, to compare them on one card in one call.
#ifndef AHD_TILE_H
#define AHD_TILE_H 64
#endif
#ifndef AHD_TILE_W
#define AHD_TILE_W 64
#endif
#ifndef AHD_THREADS
#define AHD_THREADS 768
#endif

namespace {

constexpr int kTH = AHD_TILE_H, kTW = AHD_TILE_W;  // output tile: rows, columns
constexpr int kThreads = AHD_THREADS;
constexpr int kLoads = 8;  // loads a thread keeps in flight while the mosaic comes in
static_assert(kTH % 4 == 0 && kTW % 4 == 0, "the medians run in strips of 4 pixels");

// Output flags.
enum { F_TAIL = 1, F_CLIP = 2, F_GAMMA = 4, F_INTERLEAVED = 8 };

// Floats of a field over the tile plus a halo of e pixels, rounded up so that
// the next field starts on a 16-byte boundary.
__host__ __device__ constexpr int cells(int e) {
  return ((kTH + 2 * e) * (kTW + 2 * e) + 3) / 4 * 4;
}

template <int S>
__host__ __device__ constexpr int smem_floats() {
  // mosaic, two greens, three CIELAB, two counts
  return cells(4 * S + 5) + 2 * cells(4 * S + 3) + 3 * cells(4 * S + 2) +
         2 * cells(4 * S + 1);
}

// A field over the tile plus a halo of e pixels, indexed in tile coordinates
// (ly, lx) in [-e, kTH + e) x [-e, kTW + e).
struct Field {
  float* p;
  int e;
  __device__ __forceinline__ float& at(int ly, int lx) const {
    return p[(ly + e) * (kTW + 2 * e) + lx + e];
  }
};

__device__ __forceinline__ Field field(float* p, int e) { return Field{p, e}; }

// Calls f(ly, lx) for every cell of the tile plus a halo of e pixels.
template <class F>
__device__ __forceinline__ void for_region(int e, F f) {
  for_cells(kTH + 2 * e, kTW + 2 * e, [&](int r, int c) { f(r - e, c - e); });
}

// Clamp a row (or column) index into [0, n) keeping its parity; n is even.
__device__ __forceinline__ int clamp_phase(int v, int n) {
  if (v < 0) return v & 1;
  if (v >= n) return n - 2 + (v & 1);
  return v;
}

// The plain version's border rules as index maps into [0, n): an out-of-frame
// index goes to the in-frame index whose value the rule puts there.
enum { B_SYMMETRIC, B_REFLECT101, B_REPLICATE };

template <int RULE>
__device__ __forceinline__ int border(int v, int n) {
  if (RULE == B_SYMMETRIC) return v < 0 ? -1 - v : (v >= n ? 2 * n - 1 - v : v);
  if (RULE == B_REFLECT101) return v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// Reflect-101 on the quarter-res plane whose samples sit at the full-res
// indices off, off + 2, ...: plane index -k goes to +k, which keeps the parity.
__device__ __forceinline__ int border_plane101(int v, int n, int off) {
  const int p = border<B_REFLECT101>((v - off) >> 1, n >> 1);
  return 2 * p + off;
}

// The block's place in the frame.
struct Frame {
  int y0, x0, H, W;
  __device__ __forceinline__ bool holds(int ly, int lx) const {
    return y0 + ly >= 0 && y0 + ly < H && x0 + lx >= 0 && x0 + lx < W;
  }
};

// A field read through a border rule. In a block whose region crosses the
// frame edge (EDGE) the stages are computed at in-frame cells only and a read
// of an out-of-frame cell goes to the in-frame cell of the same field that
// the rule names; elsewhere the view is the field itself.
template <bool EDGE, int RULE>
struct View {
  Field f;
  Frame fr;
  __device__ __forceinline__ float at(int ly, int lx) const {
    if (EDGE) {
      ly = border<RULE>(fr.y0 + ly, fr.H) - fr.y0;
      lx = border<RULE>(fr.x0 + lx, fr.W) - fr.x0;
    }
    return f.at(ly, lx);
  }
};

// g - gaussian_blur3(g) at (ly, lx); taps accumulate in row-major order.
template <class GreenView>
__device__ __forceinline__ float green_hf(const GreenView& g, const float* prm,
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
template <bool EDGE>
__device__ __forceinline__ float upsample(const Field& m, const Frame& fr,
                                          const float* k, int ly, int lx,
                                          int py, int px, int off) {
  const float* kk = k + 9 * (2 * py + px);
  const int by = ly - py - 2 + off, bx = lx - px - 2 + off;
  int ys[3], xs[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    ys[t] = by + 2 * t;
    xs[t] = bx + 2 * t;
    if (EDGE) {
      ys[t] = border_plane101(fr.y0 + ys[t], fr.H, off) - fr.y0;
      xs[t] = border_plane101(fr.x0 + xs[t], fr.W, off) - fr.x0;
    }
  }
  float acc = m.at(ys[0], xs[0]) * kk[0];
#pragma unroll
  for (int t = 1; t < 9; ++t) acc = acc + m.at(ys[t / 3], xs[t % 3]) * kk[t];
  return acc;
}

// The 5x5 medians of the four pixels (ly, lx .. lx + 3) of `d`, whose halo is
// two pixels deeper than the strip's region, so that the strip's 5x8 window
// starts on a 16-byte boundary: ten 16-byte loads bring it into registers,
// 2.5 loads for a median where a window of its own takes 25. In an edge block
// the window comes in cell by cell through the replicate border. The four
// medians share the sorted columns and column pairs of the window
// (median5_columns.cuh): 121 min/max a median instead of 202, which counts
// because min and max issue at half the rate of an add.
template <bool EDGE>
__device__ __forceinline__ void median_strip(const Field& d, const Frame& fr,
                                             int ly, int lx, float* med) {
  float col[8][5];  // the window's columns
  if (EDGE) {
    const View<true, B_REPLICATE> v{d, fr};
#pragma unroll
    for (int k = 0; k < 40; ++k) col[k % 8][k / 8] = v.at(ly + k / 8 - 2, lx + k % 8 - 2);
  } else {
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      const float* row = &d.at(ly + dy - 2, lx - 2);
      const Vec4 a = *(const Vec4*)row, b = *(const Vec4*)(row + 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        col[k][dy] = a.v[k];
        col[4 + k][dy] = b.v[k];
      }
    }
  }
  median5_strip<4>(col, med);
}

// Calls f(ly, lx) for the first pixel of every strip of four of the tile plus
// a halo of e pixels (e is even, so a row is a whole number of strips).
template <class F>
__device__ __forceinline__ void for_strips(int e, F f) {
  for_cells(kTH + 2 * e, (kTW + 2 * e) / 4, [&](int r, int q) { f(r - e, 4 * q - e); });
}

// One chroma-median stage: r, g, b valid over the tile plus e_in pixels; r',
// b' are written over e_in - 2 and g' over e_in - 4. Each difference field is
// written once (d1, d2: scratch with a halo of e_in, then of e_in - 2), so
// that a median reads one value a cell and not two.
template <bool EDGE>
__device__ void median_stage(const Frame& fr, const Field& r, const Field& g,
                             const Field& b, int e_in, float* d1, float* d2,
                             const Field& r_out, const Field& b_out,
                             const Field& g_out) {
  const int e1 = e_in - 2, e2 = e_in - 4;
  const Field rg = field(d1, e_in), bg = field(d2, e_in);
  for_region(e_in, [&](int ly, int lx) {
    if (EDGE && !fr.holds(ly, lx)) return;
    const float gg = g.at(ly, lx);
    rg.at(ly, lx) = r.at(ly, lx) - gg;
    bg.at(ly, lx) = b.at(ly, lx) - gg;
  });
  __syncthreads();
  for_strips(e1, [&](int ly, int lx) {
    float mr[4], mb[4];
    median_strip<EDGE>(rg, fr, ly, lx, mr);
    median_strip<EDGE>(bg, fr, ly, lx, mb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (EDGE && !fr.holds(ly, lx + j)) continue;
      const float gg = g.at(ly, lx + j);
      r_out.at(ly, lx + j) = mr[j] + gg;
      b_out.at(ly, lx + j) = mb[j] + gg;
    }
  });
  __syncthreads();
  const Field gr = field(d1, e1), gb = field(d2, e1);
  for_region(e1, [&](int ly, int lx) {
    if (EDGE && !fr.holds(ly, lx)) return;
    const float gg = g.at(ly, lx);
    gr.at(ly, lx) = gg - r_out.at(ly, lx);
    gb.at(ly, lx) = gg - b_out.at(ly, lx);
  });
  __syncthreads();
  for_strips(e2, [&](int ly, int lx) {
    float mr[4], mb[4];
    median_strip<EDGE>(gr, fr, ly, lx, mr);
    median_strip<EDGE>(gb, fr, ly, lx, mb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (EDGE && !fr.holds(ly, lx + j)) continue;
      g_out.at(ly, lx + j) =
          (mr[j] + mb[j] + r_out.at(ly, lx + j) + b_out.at(ly, lx + j)) * 0.5f;
    }
  });
  __syncthreads();
}

__device__ __forceinline__ float gamma_encode(float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  return x <= F32(0.0031308)
             ? x * F32(12.92)
             : F32(1.055) * powf(fmaxf(x, F32(1e-12)), F32(1.0 / 2.4)) -
                   F32(0.055);
}

template <int S, bool EDGE>
__device__ __forceinline__ void ahd_block(const float* __restrict__ bayer,
                                          const float* prm,
                                          float* __restrict__ out, float* smem,
                                          int H, int W, int is_hdr, int flags) {
  constexpr int eM = 4 * S + 5, eG = eM - 2, eL = eM - 3, eC = eM - 4;
  constexpr int eP = 4 * S;

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

  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const Frame fr{y0, x0, H, W};
  const View<EDGE, B_REFLECT101> GH101{GH, fr}, GV101{GV, fr};

  // WB-scaled mosaic; CFA phase from the (even-aligned) global position. The
  // clamped addresses are the symmetric border of each phase plane within the
  // green filter's reach of two pixels; nothing else reads them.
  for_cells_loading<kLoads>(
      kTH + 2 * eM, kTW + 2 * eM,
      [&](int r, int c) {
        int y = y0 + r - eM, x = x0 + c - eM;
        if (EDGE) {
          y = clamp_phase(y, H);
          x = clamp_phase(x, W);
        }
        return bayer[(size_t)y * W + x];
      },
      [&](int r, int c, float v) {
        const int py = (y0 + r - eM) & 1, px = (x0 + c - eM) & 1;
        const int ch = py == px ? 2 * py : 1;  // R at (0,0), G, B at (1,1)
        M.at(r - eM, c - eM) = v * prm[P_WB + ch];
      });
  __syncthreads();

  // Directional green fields: the mosaic at G sites, the 5-tap filter along
  // the row (H) or column (V) at R and B sites.
  {
    const float* h = prm + P_H;
    for_region(eG, [&](int ly, int lx) {
      if (EDGE && !fr.holds(ly, lx)) return;
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
    });
  }
  __syncthreads();

  // Per direction: candidate (r, g, b) -> CIELAB, then homogeneity counts.
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const Field& G = dir ? GV : GH;
    const View<EDGE, B_REFLECT101>& G101 = dir ? GV101 : GH101;
    for_region(eL, [&](int ly, int lx) {
      if (EDGE && !fr.holds(ly, lx)) return;
      const int py = (y0 + ly) & 1, px = (x0 + lx) & 1;
      const float hf = green_hf(G101, prm, ly, lx);
      const float r = upsample<EDGE>(M, fr, prm + P_KR, ly, lx, py, px, 0) + hf;
      const float b = upsample<EDGE>(M, fr, prm + P_KB, ly, lx, py, px, 1) + hf;
      to_lab(r, G.at(ly, lx), b, prm, is_hdr, L0.at(ly, lx), L1.at(ly, lx),
             L2.at(ly, lx));
    });
    __syncthreads();
    // The count's window reads CIELAB through the symmetric border.
    const View<EDGE, B_SYMMETRIC> S0{L0, fr}, S1{L1, fr}, S2{L2, fr};
    const Field& C = dir ? CV : CH;
    for_region(eC, [&](int ly, int lx) {
      if (EDGE && !fr.holds(ly, lx)) return;
      C.at(ly, lx) = homogeneity(S0, S1, S2, ly, lx, dir == 1);
    });
    __syncthreads();
  }

  // H/V pick on the box-summed counts (exact integers; the box sum reads the
  // counts through reflect-101); the picked fields reuse the CIELAB buffer.
  const View<EDGE, B_REFLECT101> CH101{CH, fr}, CV101{CV, fr};
  const Field R0 = field(buf_lab, eP), G0 = field(buf_lab + cells(eL), eP),
              B0 = field(buf_lab + 2 * cells(eL), eP);
  for_region(eP, [&](int ly, int lx) {
    if (EDGE && !fr.holds(ly, lx)) return;
    const int py = (y0 + ly) & 1, px = (x0 + lx) & 1;
    const float pick =
        box_sum3(CH101, ly, lx) < box_sum3(CV101, ly, lx) ? 1.0f : 0.0f;
    const float inv = 1.0f - pick;
    const float hf_h = green_hf(GH101, prm, ly, lx);
    const float hf_v = green_hf(GV101, prm, ly, lx);
    const float up_r = upsample<EDGE>(M, fr, prm + P_KR, ly, lx, py, px, 0);
    const float up_b = upsample<EDGE>(M, fr, prm + P_KB, ly, lx, py, px, 1);
    R0.at(ly, lx) = (up_r + hf_h) * pick + (up_r + hf_v) * inv;
    G0.at(ly, lx) = GH.at(ly, lx) * pick + GV.at(ly, lx) * inv;
    B0.at(ly, lx) = (up_b + hf_h) * pick + (up_b + hf_v) * inv;
  });
  __syncthreads();

  // Chroma-median stages; each writes into buffers already consumed (the
  // greens' buffers hold the difference fields).
  Field Rf = R0, Gf = G0, Bf = B0;
  if constexpr (S >= 1) {
    const Field R1 = field(buf_m, eP - 2), B1 = field(buf_ch, eP - 2),
                G1 = field(buf_cv, eP - 4);
    median_stage<EDGE>(fr, R0, G0, B0, eP, buf_gh, buf_gv, R1, B1, G1);
    Rf = R1; Gf = G1; Bf = B1;
  }
  if constexpr (S >= 2) {
    const Field R2 = field(buf_lab, eP - 6),
                B2 = field(buf_lab + 2 * cells(eL), eP - 6),
                G2 = field(buf_lab + cells(eL), eP - 8);
    median_stage<EDGE>(fr, Rf, Gf, Bf, eP - 4, buf_gh, buf_gv, R2, B2, G2);
    Rf = R2; Gf = G2; Bf = B2;
  }

  const float* m = prm + P_MAT;
  for_cells(kTH, kTW, [&](int ty, int tx) {
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) return;
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
  });
}

// One block computes one tile. A block whose mosaic region lies inside the
// frame takes the path without index maps.
template <int S>
__global__ void __launch_bounds__(kThreads)
ahd_kernel(const float* __restrict__ bayer, const float* __restrict__ params,
           float* __restrict__ out, int H, int W, int is_hdr, int flags) {
  constexpr int eM = 4 * S + 5;
  extern __shared__ __align__(16) float smem[];
  __shared__ float prm[P_COUNT];
  for (int i = threadIdx.x; i < P_COUNT; i += blockDim.x) prm[i] = params[i];
  __syncthreads();
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bool edge = y0 < eM || x0 < eM || y0 + kTH + eM > H || x0 + kTW + eM > W;
  if (edge) {
    ahd_block<S, true>(bayer, prm, out, smem, H, W, is_hdr, flags);
  } else {
    ahd_block<S, false>(bayer, prm, out, smem, H, W, is_hdr, flags);
  }
}

#undef F32

}  // namespace

#ifdef __CUDACC__
namespace {

template <int S>
int launch_ahd(const float* bayer, const float* params, float* out, int H,
               int W, int is_hdr, int flags, cudaStream_t stream) {
  static int ready_device = -1;
  const int bytes = smem_floats<S>() * (int)sizeof(float);
  cudaError_t err = allow_shared_memory(ahd_kernel<S>, bytes, &ready_device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
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
