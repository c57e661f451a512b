// One AHD chroma-median postprocess stage on three (H, W) float32 planes, or
// on one (H, W, 3) interleaved image:
//
//   r' = med5(r - g) + g
//   b' = med5(b - g) + g
//   g' = (med5(g - r') + med5(g - b') + r' + b') * 0.5
//
// every 5x5 median with a replicate border, as cv2.medianBlur(src, 5).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::postprocess_color_pallas_channels
// (body _postprocess_kernel) and, for the (H, W, 3) image,
// postprocess_color_pallas. Plain versions beside them:
// pysp_tpu_torch/demosaic/ahd.py::postprocess_color_channels and
// postprocess_color.
//
// What bounds it on an H100: the rate of min and max, not device memory.
// A pixel moves 24 bytes (12 read, 12 written) and takes four exact medians of
// 25; min and max run at half the rate of an add on this card, so even the
// cheapest network here (121 min/max a median, median5_columns.cuh) costs
// about four times what the bytes do. The design spends as few min/max and as
// little else as it can:
//
// - A block computes a kTH x kTW tile. It reads r, g, b once for the tile plus
//   4 px and keeps g and the two difference fields r - g, b - g in shared
//   memory, each written once, so a median loads one value a cell.
// - A thread takes the medians of a strip of four neighbouring pixels from one
//   5x8 window in registers (ten 16-byte shared loads; the strips are laid so
//   that every window starts on a 16-byte boundary) and shares the window's
//   sorted columns and column pairs between the four (median5_strip<4>, the
//   routine of the AHD kernel's stages). The halo makes a pixel pay
//   (2 (kTH + 4)(kTW + 4) + 2 kTH kTW) / (kTH kTW) medians: 4.39 at 32 x 64.
// - The first strips (tile plus 2 px) leave r', b' and the second pair's
//   inputs g - r', g - b' in shared memory; the second strips (the tile) write
//   the three outputs from registers, 16 bytes a store.
// - Cells are dealt to threads by for_cells (no division a cell), with several
//   16-byte global loads in flight a thread.
// - The border is a template parameter. A block whose region (tile plus 4 px)
//   lies inside the frame, in a frame whose rows are 16-byte aligned, runs
//   without a clamp or a guard. Any other block (FAST = false) applies the
//   replicate rule to each median's input field: r - g and b - g come from
//   clamped addresses; r', b' are computed at in-frame cells only, and an
//   out-of-frame cell of g - r', g - b' is then copied from the in-frame cell
//   that the clamp names, which lies in the block's own region. Any H, W >= 1
//   goes.
//
// The layout is a template parameter too. The planes' kernel reads and writes
// three planes; the image's kernel (HWC) reads and writes one (H, W, 3) array,
// a pixel's three channels side by side (a pixel stride of 3): a strip of four
// pixels is three 16-byte accesses, split into its three channels in
// registers, so the image needs no channel copies before the stage and no
// stack after it.
//
// The arithmetic is the plain version's subtractions, adds and one multiply by
// 0.5 in the same order, and a median is a selection, so the result is
// bit-identical to the plain version at every shape, in both layouts.
#include "median5_columns.cuh"
#include "tile_loops.cuh"

// The tile, the block and the blocks an SM that the register cap is set for;
// tools/time_kernels.py builds other shapes beside these through the macros,
// to compare them on one card in one call.
#ifndef PP_TILE_H
#define PP_TILE_H 32
#endif
#ifndef PP_TILE_W
#define PP_TILE_W 64
#endif
#ifndef PP_THREADS
#define PP_THREADS 256
#endif
#ifndef PP_MIN_BLOCKS
#define PP_MIN_BLOCKS 3
#endif

namespace {

constexpr int kTH = PP_TILE_H, kTW = PP_TILE_W;  // output tile: rows, columns
constexpr int kThreads = PP_THREADS;
constexpr int kIn = 4, kMid = 2;  // halo of the inputs; of r', b', g - r', g - b'
static_assert(kTH % 4 == 0 && kTW % 4 == 0, "the medians run in strips of 4 pixels");

// Floats of a field over the tile plus a halo of e pixels, rounded up so that
// the next field starts on a 16-byte boundary.
__host__ __device__ constexpr int cells(int e) {
  return ((kTH + 2 * e) * (kTW + 2 * e) + 3) / 4 * 4;
}

// g, r - g, b - g over the tile plus 4 px; r', b', g - r', g - b' over 2 px.
constexpr int kSmemFloats = 3 * cells(kIn) + 4 * cells(kMid);

// A field over the tile plus a halo of e pixels, indexed in tile coordinates
// (ly, lx) in [-e, kTH + e) x [-e, kTW + e).
struct Field {
  float* p;
  int e;
  __device__ __forceinline__ float& at(int ly, int lx) const {
    return p[(ly + e) * (kTW + 2 * e) + lx + e];
  }
};

struct Rgb {
  float r, g, b;
};

struct Rgb4 {
  Vec4 r, g, b;
};

// The pixels o .. o + 3 of the three channels (pixel indices; 16-byte aligned).
// HWC: r is the image and g, b are unused; else three planes.
template <bool HWC>
__device__ __forceinline__ Rgb4 load_rgb4(const float* r, const float* g, const float* b,
                                          size_t o) {
  if (HWC) {
    const Vec4* p = (const Vec4*)(r + 3 * o);
    const Vec4 a = p[0], c = p[1], d = p[2];  // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    return Rgb4{Vec4{{a.v[0], a.v[3], c.v[2], d.v[1]}}, Vec4{{a.v[1], c.v[0], c.v[3], d.v[2]}},
                Vec4{{a.v[2], c.v[1], d.v[0], d.v[3]}}};
  }
  return Rgb4{*(const Vec4*)(r + o), *(const Vec4*)(g + o), *(const Vec4*)(b + o)};
}

template <bool HWC>
__device__ __forceinline__ void store_rgb4(float* r, float* g, float* b, size_t o,
                                           const Vec4& vr, const Vec4& vg, const Vec4& vb) {
  if (HWC) {
    Vec4* p = (Vec4*)(r + 3 * o);
    p[0] = Vec4{{vr.v[0], vg.v[0], vb.v[0], vr.v[1]}};
    p[1] = Vec4{{vg.v[1], vb.v[1], vr.v[2], vg.v[2]}};
    p[2] = Vec4{{vb.v[2], vr.v[3], vg.v[3], vb.v[3]}};
    return;
  }
  *(Vec4*)(r + o) = vr;
  *(Vec4*)(g + o) = vg;
  *(Vec4*)(b + o) = vb;
}

// The 5x5 medians of the four pixels (ly, lx .. lx + 3) of `d`, whose halo is
// two pixels deeper than the strips' region, so that the strip's 5x8 window
// starts on a 16-byte boundary.
__device__ __forceinline__ void median_strip(const Field& d, int ly, int lx, float* med) {
  float col[8][5];
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
  median5_strip<4>(col, med);
}

// Calls f(ly, lx) for the first pixel of every strip of four of the tile plus
// a halo of e pixels (e is even, so a row is a whole number of strips).
template <class F>
__device__ __forceinline__ void for_strips(int e, F f) {
  for_cells(kTH + 2 * e, (kTW + 2 * e) / 4, [&](int r, int q) { f(r - e, 4 * q - e); });
}

// HWC: r, g, b (and the outputs) point at one image's channels 0, 1, 2, a
// pixel stride of 3 apart; else at three planes. No element is written
// through two of the pointers, nor read through one and written through
// another, so they stay __restrict__ in both layouts.
template <bool FAST, bool HWC>
__device__ __forceinline__ void postprocess_block(
    const float* __restrict__ r, const float* __restrict__ g,
    const float* __restrict__ b, float* __restrict__ r_out,
    float* __restrict__ g_out, float* __restrict__ b_out, float* smem, int H,
    int W) {
  constexpr int S = HWC ? 3 : 1;  // pixel stride
  const Field G{smem, kIn}, RG{G.p + cells(kIn), kIn}, BG{RG.p + cells(kIn), kIn};
  const Field RP{BG.p + cells(kIn), kMid}, BP{RP.p + cells(kMid), kMid};
  const Field GR{BP.p + cells(kMid), kMid}, GB{GR.p + cells(kMid), kMid};
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const auto holds = [&](int ly, int lx) {
    return y0 + ly >= 0 && y0 + ly < H && x0 + lx >= 0 && x0 + lx < W;
  };

  // g and the first pair's inputs over the tile plus 4 px. Clamped addresses
  // are the replicate border of r - g and b - g.
  if (FAST) {
    for_cells_loading<2>(
        kTH + 2 * kIn, (kTW + 2 * kIn) / 4,
        [&](int row, int q) {
          const size_t o = (size_t)(y0 + row - kIn) * W + (x0 + 4 * q - kIn);
          return load_rgb4<HWC>(r, g, b, o);
        },
        [&](int row, int q, const Rgb4& v) {
          Vec4 rg, bg;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            rg.v[k] = v.r.v[k] - v.g.v[k];
            bg.v[k] = v.b.v[k] - v.g.v[k];
          }
          const int ly = row - kIn, lx = 4 * q - kIn;
          *(Vec4*)&G.at(ly, lx) = v.g;
          *(Vec4*)&RG.at(ly, lx) = rg;
          *(Vec4*)&BG.at(ly, lx) = bg;
        });
  } else {
    for_cells_loading<4>(
        kTH + 2 * kIn, kTW + 2 * kIn,
        [&](int row, int c) {
          const size_t o = ((size_t)clamp_index(y0 + row - kIn, H) * W +
                            clamp_index(x0 + c - kIn, W)) * S;
          return Rgb{r[o], g[o], b[o]};
        },
        [&](int row, int c, const Rgb& v) {
          G.at(row - kIn, c - kIn) = v.g;
          RG.at(row - kIn, c - kIn) = v.r - v.g;
          BG.at(row - kIn, c - kIn) = v.b - v.g;
        });
  }
  __syncthreads();

  // r', b' and the second pair's inputs over the tile plus 2 px.
  for_strips(kMid, [&](int ly, int lx) {
    // a strip with no pixel in the frame has nothing to compute
    if (!FAST && !(y0 + ly >= 0 && y0 + ly < H && x0 + lx + 3 >= 0 && x0 + lx < W)) return;
    float mr[4], mb[4];
    median_strip(RG, ly, lx, mr);
    median_strip(BG, ly, lx, mb);
    Vec4 rp, bp, gr, gb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gg = G.at(ly, lx + j);
      rp.v[j] = mr[j] + gg;
      bp.v[j] = mb[j] + gg;
      gr.v[j] = gg - rp.v[j];
      gb.v[j] = gg - bp.v[j];
    }
    if (FAST) {
      *(Vec4*)&RP.at(ly, lx) = rp;
      *(Vec4*)&BP.at(ly, lx) = bp;
      *(Vec4*)&GR.at(ly, lx) = gr;
      *(Vec4*)&GB.at(ly, lx) = gb;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!holds(ly, lx + j)) continue;
        RP.at(ly, lx + j) = rp.v[j];
        BP.at(ly, lx + j) = bp.v[j];
        GR.at(ly, lx + j) = gr.v[j];
        GB.at(ly, lx + j) = gb.v[j];
      }
    }
  });
  __syncthreads();

  if (!FAST) {
    // The replicate border of g - r' and g - b': an out-of-frame cell takes
    // the in-frame cell the clamp names (within 2 px, so inside the region).
    for_cells(kTH + 2 * kMid, kTW + 2 * kMid, [&](int row, int c) {
      const int ly = row - kMid, lx = c - kMid;
      if (holds(ly, lx)) return;
      const int cy = clamp_index(y0 + ly, H) - y0, cx = clamp_index(x0 + lx, W) - x0;
      GR.at(ly, lx) = GR.at(cy, cx);
      GB.at(ly, lx) = GB.at(cy, cx);
    });
    __syncthreads();
  }

  // g' over the tile, and the three outputs.
  for_strips(0, [&](int ly, int lx) {
    if (!FAST && !holds(ly, lx)) return;
    float mr[4], mb[4];
    median_strip(GR, ly, lx, mr);
    median_strip(GB, ly, lx, mb);
    Vec4 rp, gp, bp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rp.v[j] = RP.at(ly, lx + j);
      bp.v[j] = BP.at(ly, lx + j);
      gp.v[j] = (mr[j] + mb[j] + rp.v[j] + bp.v[j]) * 0.5f;
    }
    const size_t o = (size_t)(y0 + ly) * W + (x0 + lx);
    if (FAST) {
      store_rgb4<HWC>(r_out, g_out, b_out, o, rp, gp, bp);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!holds(ly, lx + j)) continue;
        r_out[(o + j) * S] = rp.v[j];
        g_out[(o + j) * S] = gp.v[j];
        b_out[(o + j) * S] = bp.v[j];
      }
    }
  });
}

// One block computes one tile. `aligned` says that every row of the planes
// (of the image) starts on a 16-byte boundary (rows_aligned).
template <bool HWC>
__device__ __forceinline__ void postprocess_tile(
    const float* __restrict__ r, const float* __restrict__ g,
    const float* __restrict__ b, float* __restrict__ r_out,
    float* __restrict__ g_out, float* __restrict__ b_out, int H, int W,
    int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bool inside =
      y0 >= kIn && x0 >= kIn && y0 + kTH + kIn <= H && x0 + kTW + kIn <= W;
  if (inside && aligned) {
    postprocess_block<true, HWC>(r, g, b, r_out, g_out, b_out, smem, H, W);
  } else {
    postprocess_block<false, HWC>(r, g, b, r_out, g_out, b_out, smem, H, W);
  }
}

// Three (H, W) planes in, three out.
__global__ void __launch_bounds__(kThreads, PP_MIN_BLOCKS)
postprocess_kernel(const float* __restrict__ r, const float* __restrict__ g,
                   const float* __restrict__ b, float* __restrict__ r_out,
                   float* __restrict__ g_out, float* __restrict__ b_out,
                   int H, int W, int aligned) {
  postprocess_tile<false>(r, g, b, r_out, g_out, b_out, H, W, aligned);
}

// One (H, W, 3) image in, one out.
__global__ void __launch_bounds__(kThreads, PP_MIN_BLOCKS)
postprocess_hwc_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                       int W, int aligned) {
  postprocess_tile<true>(img, img + 1, img + 2, out, out + 1, out + 2, H, W, aligned);
}

}  // namespace

#ifdef __CUDACC__
// Launches one stage on three planes on `stream`; returns the cudaError_t of
// the launch.
extern "C" int pysp_postprocess_color(const float* r, const float* g,
                                      const float* b, float* r_out,
                                      float* g_out, float* b_out, int H, int W,
                                      void* stream) {
  static int ready_device = -1;
  const int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = allow_shared_memory(postprocess_kernel, bytes, &ready_device);
  if (err != cudaSuccess) return (int)err;
  const void* const planes[6] = {r, g, b, r_out, g_out, b_out};
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  postprocess_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      r, g, b, r_out, g_out, b_out, H, W, (int)rows_aligned(W, planes, 6));
  return (int)cudaGetLastError();
}

// Launches one stage on an (H, W, 3) image on `stream`.
extern "C" int pysp_postprocess_color_hwc(const float* img, float* out, int H, int W,
                                          void* stream) {
  static int ready_device = -1;
  const int bytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = allow_shared_memory(postprocess_hwc_kernel, bytes, &ready_device);
  if (err != cudaSuccess) return (int)err;
  const void* const images[2] = {img, out};
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  postprocess_hwc_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      img, out, H, W, (int)rows_aligned(W, images, 2));
  return (int)cudaGetLastError();
}
#endif
