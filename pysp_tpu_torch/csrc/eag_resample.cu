// CA removal's EAG resamples, each in one read of its inputs and one write of
// its output:
//
// - eag_fill_kernel: the full-resolution green of a mosaic from its two green
//   phases g1 (top right of each RGGB quad) and g2 (bottom left). A green
//   site keeps its green; an R or B site takes simple_delta_mix_bilinear of
//   its four cardinal greens (or their mean), read from the quarter-res
//   green planes with a symmetric border (pad_reflect, a clamp at a reach of
//   one). Plain version: demosaic/eag.py::resample_g_to_full_resolution_plain.
// - eag_upsample_kernel: a channel at full resolution from its quarter-res
//   plane `sub` and the full-resolution green `g` (remapped onto the
//   channel's grid by the caller): out = U(sub) + (g - blur3(g)), U the four
//   photosite-phase 3x3 kernels of get_rgbg_kernel(position) over `sub`
//   (reflect-101 at quarter resolution), blur3 the 3x3 Gaussian
//   GAUSSIAN3_SIGMA1 over `g` (reflect-101 at full resolution). Plain
//   version: demosaic/eag.py::resample_channel_plain.
//
// Replaces no TPU kernel: the JAX package runs these passes in XLA
// (pysp_tpu/demosaic/eag.py), and so did the port, as about 240 plain
// PyTorch launches over full-resolution temporaries an mf102 frame (pads,
// flips, a rounded multiply and an add a tap, three stacks an interleave):
// some 33 ms a 102 MP frame where the bytes allow under 1 ms.
//
// What bounds them on an H100: device memory. The fill reads the mosaic's
// rows (4 B a photosite) and writes the green plane (4 B); an upsample reads
// the green (4 B a pixel) and the quarter plane (1 B a pixel) and writes its
// channel (4 B). At 8736x11648 that is 0.81 GB and 0.92 GB, 0.24 and 0.27 ms
// at 3.35 TB/s. Their float32 work (about 10 and 30 operations a pixel) is
// under half of that at 67 TFLOP/s. So each is one launch over every frame of
// a burst that touches each byte once:
//
// - The fill gives each thread one quad: six loads through the read-only
//   cache (the green phases may be strided views of the mosaic, or any
//   strides), and one 8-byte store to each of the quad's two rows. The
//   neighbours' rows are the next warps' rows, so the mosaic comes from
//   device memory about once.
// - An upsample block of 128 threads loads a kTH x kTW (32 x 128) tile of
//   `g` and its quarter tile of `sub`, each with a one-pixel halo, into
//   shared memory with 16-byte loads (several in flight a thread), then each
//   thread computes four 2 x 4 blocks of outputs (a block is one quad row
//   pair of two quads: every photosite phase, so a warp takes one branch-free
//   path) from registers and stores each row as one 16-byte store. On an
//   H100 at 102 MP, back to back, R took 0.358 ms with this tile against
//   0.410 ms with 32 x 64 tiles of 128 threads, 0.49-0.53 with 256 threads
//   and 0.43-0.45 with 64-row tiles; a register cap for six blocks an SM
//   ran slower and one for eight no faster (the same bits in every build).
//   A block whose region lies inside a frame whose rows are 16-byte aligned
//   runs without index arithmetic; any other block loads each cell through
//   the reflect-101 index (then clamped into the plane: halo cells further
//   out than one pixel are never read) and stores only its in-frame pixels.
//
// Bit for bit with the plain versions, NaN and inf included: every tap is a
// separately rounded x * c, and a correlation's taps are summed left to right
// in row-major order from the first nonzero tap, zero taps skipped
// (ops/stencil.py::_conv_valid); the infill's divide is IEEE, and 1 - s,
// (a + b) * 0.5 and avg_y * s_x + avg_x * s_y round where PyTorch's separate
// kernels round (the library is built with -fmad=false). NaN takes the plain
// `where` branches: sum != 0 holds for a NaN sum, as in the plain version.
#include <string.h>

#include "tile_loops.cuh"

namespace {

// --- the green fill ---------------------------------------------------------------

constexpr int kFillQW = 64, kFillQH = 4;  // quads a block: columns, rows
constexpr int kFillThreads = 256;

struct alignas(8) Float2 {
  float x, y;
};

// simple_delta_mix_bilinear (demosaic/eag.py) of one site's four greens.
__device__ __forceinline__ float delta_mix(float top, float bottom, float left, float right) {
  const float delta_y = fabsf(top - bottom);
  const float delta_x = fabsf(left - right);
  const float sum = delta_y + delta_x;
  const float avg_x = (left + right) * 0.5f;
  const float avg_y = (top + bottom) * 0.5f;
  const float strength_y = sum != 0.0f ? delta_y / sum : 0.5f;
  const float strength_x = 1.0f - strength_y;
  return avg_y * strength_x + avg_x * strength_y;
}

// The unweighted infill: (top + bottom + left + right) * 0.25.
__device__ __forceinline__ float mean4(float top, float bottom, float left, float right) {
  return (((top + bottom) + left) + right) * 0.25f;
}

// One block fills kFillQH x kFillQW quads of frame blockIdx.z. g1 and g2 are
// (N, h, w) with the strides `frame`, `row`, `col` (elements); out is (N, 2h,
// 2w), contiguous.
template <bool WEIGHTED>
__global__ void __launch_bounds__(kFillThreads)
eag_fill_kernel(const float* __restrict__ g1, const float* __restrict__ g2,
                float* __restrict__ out, int h, int w, long long frame, long long row,
                long long col) {
  const long long n = blockIdx.z;
  g1 += n * frame;
  g2 += n * frame;
  const int W = 2 * w;
  out += n * 2 * h * (long long)W;
  const int i0 = blockIdx.y * kFillQH, j0 = blockIdx.x * kFillQW;
  for_cells(kFillQH, kFillQW, [&](int di, int dj) {
    const int i = i0 + di, j = j0 + dj;
    if (i >= h || j >= w) return;
    auto at = [&](const float* p, int y, int x) { return __ldg(p + y * row + x * col); };
    const float tr = at(g1, i, j), bl = at(g2, i, j);
    // R site (top left): greens above (g2, row i - 1), below, left (g1,
    // column j - 1), right; B site (bottom right): above (g1), below (g1, row
    // i + 1), left (g2), right (g2, column j + 1)
    const float r_t = at(g2, clamp_index(i - 1, h), j);
    const float r_l = at(g1, i, clamp_index(j - 1, w));
    const float b_b = at(g1, clamp_index(i + 1, h), j);
    const float b_r = at(g2, i, clamp_index(j + 1, w));
    const float r = WEIGHTED ? delta_mix(r_t, bl, r_l, tr) : mean4(r_t, bl, r_l, tr);
    const float b = WEIGHTED ? delta_mix(tr, b_b, bl, b_r) : mean4(tr, b_b, bl, b_r);
    float* o = out + (long long)(2 * i) * W + 2 * j;
    *(Float2*)o = Float2{r, tr};
    *(Float2*)(o + W) = Float2{bl, b};
  });
}

// --- the channel upsample -----------------------------------------------------------

constexpr int kTH = 32, kTW = 128;        // output tile, full resolution
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;             // blocks an SM the register cap is set for
constexpr int kLoads = 4;                 // 16-byte loads in flight a thread
constexpr int kGRows = kTH + 2;           // the green's region: rows [-1, kTH + 1)
constexpr int kGRowW = kTW + 8;           // and columns [-4, kTW + 4), whole quads
constexpr int kSRows = kTH / 2 + 2;       // the quarter plane's: rows [-1, kTH / 2 + 1)
constexpr int kSRowW = kTW / 2 + 8;       // and columns [-4, kTW / 2 + 4)
constexpr int kSmemFloats = kGRows * kGRowW + kSRows * kSRowW;
static_assert(kTH % 2 == 0 && kTW % 8 == 0, "a tile holds whole quads, in whole quads of quads");

// The host constants: the four photosite-phase kernels of get_rgbg_kernel, in
// its order (TL, TR, BL, BR: index 2 * row phase + column phase), then
// GAUSSIAN3_SIGMA1, each 3x3 row-major.
struct Taps {
  float up[4][9];
  float blur[9];
};

// The first and last nonzero row (or column) of a phase's kernel: all three
// where the phase lies on the plane's side (BASE), else the two nearer it
// (get_rgbg_kernel pads the 2-tap kernel with a zero on the far side).
__host__ __device__ constexpr int tap_lo(int phase, int base) {
  return phase == base ? 0 : (base == 0 ? 1 : 0);
}
__host__ __device__ constexpr int tap_hi(int phase, int base) {
  return phase == base ? 2 : (base == 0 ? 2 : 1);
}

// U(sub) at one pixel of photosite phase (TY, TX): s holds the quarter rows
// i - 1 .. i + 1 and columns j - 1 .. j + 2 of the pixel's quad pair, and QD
// is the quad (0 or 1).
template <int BY, int BX, int TY, int TX, int QD>
__device__ __forceinline__ float phase_up(const float (&s)[3][4], const Taps& k) {
  constexpr int r0 = tap_lo(TY, BY), r1 = tap_hi(TY, BY);
  constexpr int c0 = tap_lo(TX, BX), c1 = tap_hi(TX, BX);
  constexpr int phase = 2 * TY + TX;
  float acc = s[r0][QD + c0] * k.up[phase][3 * r0 + c0];
#pragma unroll
  for (int dy = r0; dy <= r1; ++dy) {
#pragma unroll
    for (int dx = c0; dx <= c1; ++dx) {
      if (dy != r0 || dx != c0) acc = acc + s[dy][QD + dx] * k.up[phase][3 * dy + dx];
    }
  }
  return acc;
}

// blur3(g) at the pixel whose window is g rows R .. R + 2, columns P .. P + 2.
template <int R, int P>
__device__ __forceinline__ float blur_at(const float (&gw)[4][6], const Taps& k) {
  float acc = gw[R][P] * k.blur[0];
#pragma unroll
  for (int t = 1; t < 9; ++t) acc = acc + gw[R + t / 3][P + t % 3] * k.blur[t];
  return acc;
}

// One row (row phase TY) of a thread's 2 x 4 block: its four outputs.
template <int BY, int BX, int TY>
__device__ __forceinline__ Vec4 out_row(const float (&gw)[4][6], const float (&s)[3][4],
                                        const Taps& k) {
  return Vec4{{phase_up<BY, BX, TY, 0, 0>(s, k) + (gw[TY + 1][1] - blur_at<TY, 0>(gw, k)),
               phase_up<BY, BX, TY, 1, 0>(s, k) + (gw[TY + 1][2] - blur_at<TY, 1>(gw, k)),
               phase_up<BY, BX, TY, 0, 1>(s, k) + (gw[TY + 1][3] - blur_at<TY, 2>(gw, k)),
               phase_up<BY, BX, TY, 1, 1>(s, k) + (gw[TY + 1][4] - blur_at<TY, 3>(gw, k))}};
}

// Reflect-101 (cv2.BORDER_REFLECT_101) of an index at a reach of one, then
// clamped into [0, n), n >= 2: a cell further out is loaded, never read.
__device__ __forceinline__ int reflect101(int v, int n) {
  v = v < 0 ? -v : v;
  return clamp_index(v >= n ? 2 * n - 2 - v : v, n);
}

template <int BY, int BX, bool FAST>
__device__ __forceinline__ void upsample_block(const float* __restrict__ sub,
                                               const float* __restrict__ g,
                                               float* __restrict__ out, float* smem, int h,
                                               int w, const Taps& k) {
  const int H = 2 * h, W = 2 * w;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int i0 = y0 / 2, j0 = x0 / 2;
  // region cell (r, c) of the green is frame pixel (y0 + r - 1, x0 + c - 4),
  // of the quarter plane quarter pixel (i0 + r - 1, j0 + c - 4)
  float* gs = smem;
  float* ss = smem + kGRows * kGRowW;
  if (FAST) {
    for_cells_loading<kLoads>(
        kGRows, kGRowW / 4,
        [&](int r, int q) { return *(const Vec4*)(g + (size_t)(y0 + r - 1) * W + x0 + 4 * q - 4); },
        [&](int r, int q, const Vec4& v) { *(Vec4*)(gs + r * kGRowW + 4 * q) = v; });
    for_cells_loading<kLoads>(
        kSRows, kSRowW / 4,
        [&](int r, int q) {
          return *(const Vec4*)(sub + (size_t)(i0 + r - 1) * w + j0 + 4 * q - 4);
        },
        [&](int r, int q, const Vec4& v) { *(Vec4*)(ss + r * kSRowW + 4 * q) = v; });
  } else {
    for_cells_loading<kLoads>(
        kGRows, kGRowW,
        [&](int r, int c) {
          return g[(size_t)reflect101(y0 + r - 1, H) * W + reflect101(x0 + c - 4, W)];
        },
        [&](int r, int c, float v) { gs[r * kGRowW + c] = v; });
    for_cells_loading<kLoads>(
        kSRows, kSRowW,
        [&](int r, int c) {
          return sub[(size_t)reflect101(i0 + r - 1, h) * w + reflect101(j0 + c - 4, w)];
        },
        [&](int r, int c, float v) { ss[r * kSRowW + c] = v; });
  }
  __syncthreads();

  // a thread's block: quad row i = i0 + li, full rows y, y + 1, columns
  // x .. x + 3 (quads j, j + 1 with j = x / 2)
  for_cells(kTH / 2, kTW / 4, [&](int li, int q) {
    const int y = y0 + 2 * li, x = x0 + 4 * q;
    if (!FAST && (y >= H || x >= W)) return;
    // the green's rows y - 1 .. y + 2, columns x - 1 .. x + 4 (region columns
    // 4q + 3 .. 4q + 8, in three aligned quads)
    float gw[4][6];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* src = gs + (2 * li + r) * kGRowW + 4 * q;
      const Vec4 a = *(const Vec4*)src, b = *(const Vec4*)(src + 4), c = *(const Vec4*)(src + 8);
      gw[r][0] = a.v[3];
      gw[r][1] = b.v[0];
      gw[r][2] = b.v[1];
      gw[r][3] = b.v[2];
      gw[r][4] = b.v[3];
      gw[r][5] = c.v[0];
    }
    // the quarter plane's rows i - 1 .. i + 1, columns j - 1 .. j + 2 (region
    // columns 2q + 3 .. 2q + 6, in three aligned pairs)
    float s[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* src = ss + (li + r) * kSRowW + 2 * q + 2;
      const Float2 a = *(const Float2*)src, b = *(const Float2*)(src + 2),
                   c = *(const Float2*)(src + 4);
      s[r][0] = a.y;
      s[r][1] = b.x;
      s[r][2] = b.y;
      s[r][3] = c.x;
    }
    const Vec4 top = out_row<BY, BX, 0>(gw, s, k), bottom = out_row<BY, BX, 1>(gw, s, k);
    float* o = out + (size_t)y * W + x;
    if (FAST) {
      *(Vec4*)o = top;
      *(Vec4*)(o + W) = bottom;
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (x + p < W) {
          o[p] = top.v[p];
          o[W + p] = bottom.v[p];
        }
      }
    }
  });
}

// One block computes one kTH x kTW tile of frame blockIdx.z. sub is (N, h, w)
// and g and out (N, 2h, 2w), all contiguous, h and w at least 2; the
// channel's plane sits at (BY, BX) of the quad (0: top / left). `aligned`
// says that the rows of all three start on 16-byte boundaries.
template <int BY, int BX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
eag_upsample_kernel(const float* __restrict__ sub, const float* __restrict__ g,
                    float* __restrict__ out, int h, int w, Taps k, int aligned) {
  extern __shared__ __align__(16) float smem[];
  const size_t n = blockIdx.z, quarter = (size_t)h * w;
  sub += n * quarter;
  g += 4 * n * quarter;
  out += 4 * n * quarter;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bool inside = y0 >= 2 && x0 >= 8 && y0 + kTH + 2 <= 2 * h && x0 + kTW + 8 <= 2 * w;
  if (inside && aligned) {
    upsample_block<BY, BX, true>(sub, g, out, smem, h, w, k);
  } else {
    upsample_block<BY, BX, false>(sub, g, out, smem, h, w, k);
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches the green fill of N frames on `stream`; returns the cudaError_t of
// the launch.
extern "C" int pysp_eag_fill(const float* g1, const float* g2, float* out, int N, int h,
                             int w, long long frame, long long row, long long col,
                             int weighted, void* stream) {
  const dim3 grid((w + kFillQW - 1) / kFillQW, (h + kFillQH - 1) / kFillQH, N);
  if (weighted) {
    eag_fill_kernel<true><<<grid, kFillThreads, 0, (cudaStream_t)stream>>>(
        g1, g2, out, h, w, frame, row, col);
  } else {
    eag_fill_kernel<false><<<grid, kFillThreads, 0, (cudaStream_t)stream>>>(
        g1, g2, out, h, w, frame, row, col);
  }
  return (int)cudaGetLastError();
}

// Launches the upsample of N frames' channel at `position` (0: TOP_LEFT, 3:
// BOTTOM_RIGHT, BayerPatternPosition) on `stream`; `params` is the host's
// Taps, 45 floats. Returns the cudaError_t of the launch.
extern "C" int pysp_eag_upsample(const float* sub, const float* g, float* out, int N, int h,
                                 int w, int position, const float* params, void* stream) {
  Taps k;
  memcpy(&k, params, sizeof(Taps));
  const void* const quarter[1] = {sub};
  const void* const full[2] = {g, out};
  const int aligned = rows_aligned(w, quarter, 1) && rows_aligned(2 * w, full, 2);
  const dim3 grid((2 * w + kTW - 1) / kTW, (2 * h + kTH - 1) / kTH, N);
  const size_t smem = kSmemFloats * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (position == 0) {
    eag_upsample_kernel<0, 0><<<grid, kThreads, smem, s>>>(sub, g, out, h, w, k, aligned);
  } else if (position == 3) {
    eag_upsample_kernel<1, 1><<<grid, kThreads, smem, s>>>(sub, g, out, h, w, k, aligned);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
