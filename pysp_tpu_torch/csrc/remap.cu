// Bilinear or Lanczos4 remap of a float32 image with C channels:
//
//   out[c, y, x] = sum over taps of w * img[c, clamp(by + dy), clamp(bx + dx)]
//
// where (by, bx) = floor(map_y, map_x) and the weights come from the
// fractional phases, as cv2.remap with clamp-to-edge sampling. With bounds,
// the floor displacement from the identity grid is first clipped into
// [dy0, dy1] x [dx0, dx1] (pysp_tpu_torch/ops/resample.py::_delta_fields).
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::remap_bounded_pallas (body
// _remap_kernel, and the zoned and grid wrappers around it). Plain version
// beside it: pysp_tpu_torch/ops/cuda_kernels.py::remap_plain.
//
// The TPU kernel selects taps through displacement-bounded select chains,
// because Mosaic has no gather, and uses polynomial Lanczos weights. Hopper
// gathers natively, so this is the exact function of the JAX package off the
// TPU: a thread reads the maps of its pixel once, computes the weights and the
// clamped tap indices once, and sums the taps of every channel, rows outer,
// taps inner, each sum seeded with zero, multiply then add, with FMA
// contraction off (-fmad=false) and IEEE division. The two kinds are two
// kernels, launched through one entry point.
//
// Bilinear (bilinear_kernel) keeps the plain version's operations in their
// order and is bit-identical to it: for each channel top = i00 (1 - fx) +
// i01 fx, bot the same on the next row, top (1 - fy) + bot fy. It is bound by
// device memory (8 B of maps and 2 x 4 B a channel of image and output for
// about 10 operations a channel), and CA removal gives it stacks of many
// planes that share their maps. What the design does about it:
//
// - Loads in flight. A thread computes one pixel of a 32 x 8 tile, kGroup = 4
//   channels at a time: the 16 taps of four channels are loaded before the
//   first lerp. The first design (four pixels a thread, one channel after
//   another, as Lanczos4) kept four loads in flight and walked a 16-plane
//   stack in 64 dependent steps.
// - Registers. With shared maps and 32-bit offsets the kernel is capped at 40
//   registers a thread, six blocks an SM (43 uncapped, five blocks: 1-2%
//   slower; 32 spills and is 1.6x slower). The other instantiations, which
//   the cap would make spill, are left uncapped.
// - Addresses. The taps' offsets and phases are computed once a pixel with
//   shared maps and once a channel with a map for each (kShared); offsets are
//   32-bit wherever every index fits in 31 bits, which the host picks
//   (bilinear_variant). An (H, W, 3) image needs no path of its own: its
//   three channels are one group whose taps lie side by side.
// - Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_kernels.py,
//   calls back to back, the first design and grid_sample in the same call;
//   PERF.md): 16 planes of 1000x1504 with shared maps 0.0846 ms, 1.39x
//   its 0.0611 ms byte bound (the first design 0.1306, grid_sample 0.1092);
//   4 planes 0.0265 ms (0.0411, 0.0382); the 24 MP (H, W, 3) image 0.3545 ms
//   (0.3715, 0.4518); random maps on it 1.943 ms (3.134, 4.666). A lone
//   call also holds the wrapper's 21-38 us of host work before its launch
//   (grid_sample's: 7-14 us), so at the 4 planes a lone call is no faster
//   than grid_sample's (0.065 against 0.047-0.051 ms).
// - Tried and not kept, each slower or within 3%: a grid axis over groups of
//   four channels, a block a group and the groups of a tile column side by
//   side (0.0909 ms at the 16 planes: the maps read four times), eight
//   channels a group (56 to 142 registers a thread; 0.402 ms on the image),
//   two, tiles of 64 x 4, 128 x 2, 64 x 8 and the first design's 32 x 32 with
//   four pixels a thread, and streaming stores.
//
// The radial kind (bilinear_kernel<Off, RadialCoords<form, inverse>>, through
// pysp_remap_radial) is the bilinear kind with shared maps that computes its
// coordinates itself from a radial CA model (Poly3, Poly5 or PTLens of
// correct/ca/models.py, forward or Newton-inverted): the frame's centre, the
// float32 reciprocal of its corner radius and the model's float32 constants
// take the place of the two maps, so CA removal keeps no coordinate field in
// device memory and reads none back. It replaces no TPU kernel: the JAX
// package builds these maps in XLA. Its output is bit-identical to the maps
// path on the maps that plain PyTorch builds on the card
// (_maps_from_offsets(model.get_*_coordinates(...))), because each of their
// plain operations is one IEEE rounding here, in PyTorch's order:
// __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn, contracted by
// no flag; u**3 as PyTorch's u * u * u; the division by the Python scalar
// r_corner as PyTorch's multiply by the float32 rounding of its reciprocal
// taken in double (the host computes it); scale 1 at r == 0; torch.clamp's
// NaN rule. Its bound:
//
// - Bytes: 8 B a pixel and channel (the plane read once, the output written
//   once), against the maps path's 16 B with one plane: 0.243 ms for one
//   8736 x 11648 plane at 3.35 TB/s.
// - Instructions: the inverse takes eight Newton steps of f, f' and an IEEE
//   division (a reciprocal and its refinement), and both directions a square
//   root and one more division for the scale: 117 float32 operations a
//   pixel at the Poly3 inverse, 34 at the forward, each division and root
//   some ten instructions.
//
// What the design does about it:
//
// - The scale depends only on the offset's square, and the offsets of the
//   pixels mirrored about the centre's row and column are exact negations of
//   each other, so a thread computes one scale and serves the up to four
//   pixels it mirrors to; the kernel's grid covers the top-left quadrant.
//   And a pixel's coordinates serve every plane of a burst's stack.
// - Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_kernels.py,
//   back to back; PERF.md): one 8736 x 11648 plane at the mf102 model,
//   forward 0.568 ms (2.3x the byte bound), inverse 0.821 ms, against
//   8.95 and 33.57 ms for the plain maps and the bilinear kind on them (the
//   bilinear kind alone 0.834 ms, grid_sample on the maps 1.180); config 5's
//   16 planes of 1000 x 1504 0.108-0.109 ms (the maps path 0.225 and 0.538).
//   The first design, a thread a pixel, took 0.668 and 1.869 ms at the
//   plane; the register cap of six blocks an SM (40 registers, 40 bytes
//   spilled) beat five (0.591 / 0.857 ms) and four (0.673 / 0.956).
//
// Lanczos4 (lanczos4_kernel) is bound by its instruction count: 64 taps a
// channel and 16 weights a pixel against the same bytes. What the design does
// about it:
//
// - The weights. The plain version takes, for each of an axis's eight taps at
//   t = frac - m (m = -3..4), sin(pi t) / (pi t) * sin(pi t / 4) / (pi t / 4):
//   16 accurate sinf and 24 divisions an axis. But sin(pi t) = (-1)^m
//   sin(pi frac), and sin(pi t / 4) = sin(pi frac / 4) cos(m pi / 4) -
//   cos(pi frac / 4) sin(m pi / 4), whose eight constant pairs are 0, +-1 and
//   +-sqrt(2)/2. So one sinf and one sincosf an axis give all eight numerators,
//   each divided once by (pi t)(pi t / 4); the special cases (1 where
//   |t| < 1e-7, 0 where |t| >= 4) and the normalisation by the sum taken in
//   ascending tap order stay (next to a whole phase the normalisation takes
//   the rounding of sin(pi frac) out of the one tap that carries the weight).
//   This is not the plain version's operation sequence, so Lanczos4 is held by
//   a tolerance and not bit for bit: the plain version rounds pi t to float
//   before the sine, an absolute error of up to 5e-7 in the argument at |t|
//   near 4, which the identity does not make. Held: within 5e-6 of remap_plain
//   on images in [0, 1] (9.5e-7 measured on the 24 MP lens warp on an
//   NVIDIA H100 80GB HBM3; the weights differ by up to 4.8e-7), and no further
//   from the same remap computed in float64 than remap_plain is, plus 1e-6
//   (6.7e-7 against remap_plain's own 6.6e-7).
// - The taps. For an (H, W, 3) image with shared maps the three channels of a
//   tap lie side by side, so one address serves three loads and three sums
//   run together (remap_pixels<., 3>): a third of the address arithmetic, and
//   a warp's loads of one tap fall into the same three or four cache lines.
//   Every other layout sums one channel at a time.
// - Threads in flight. A block of 256 threads computes a 32 x 32 tile, four
//   pixels a thread, with the registers capped at 64 a thread (four blocks an
//   SM): uncapped, the fully unrolled taps take 128 registers and the kernel
//   a quarter longer.
// - Tried and not kept: staging the bounding box of a block's taps in shared
//   memory (a coalesced load of about 41 x 41 x 3 floats a block, then every
//   tap from there, no bank conflict at a stride of three floats). On the 24
//   MP lens warp it gave the same bytes and the same time as the gather at 64
//   and 85 registers and was 8-19% slower with fewer threads in flight
//   (PERF.md): with the three channels together the gather hits the L1 cache
//   and the kernel is bound by issuing the weights and the sums, not by its
//   loads.
//
// Layout: element (c, y, x) of img and out sits at
// c * img_plane + (y * W + x) * pix_stride, so (H, W), (C, H, W) and
// (H, W, C) launch as they lie; map element (c, y, x) sits at
// c * map_plane + y * W + x, with map_plane 0 for maps shared by the channels.

#include "tile_loops.cuh"

// Lanczos4's tile, block and the blocks an SM that the register cap is set
// for; tools/time_kernels.py builds other shapes beside these through the
// macros, to compare them on one card in one call.
#ifndef REMAP_TILE_Y
#define REMAP_TILE_Y 32
#endif
#ifndef REMAP_THREADS
#define REMAP_THREADS 256
#endif
#ifndef REMAP_MIN_BLOCKS
#define REMAP_MIN_BLOCKS 4
#endif

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = REMAP_TILE_Y;
constexpr int kThreads = REMAP_THREADS;
// The bilinear kind's tile, a thread a pixel; the blocks an SM that the
// register cap of its shared-map 32-bit instantiation is set for; the channels
// a thread loads at once.
constexpr int kBlTileX = 32;
constexpr int kBlTileY = 8;
constexpr int kBlThreads = kBlTileX * kBlTileY;
constexpr int kBlMinBlocks = 6;
constexpr int kGroup = 4;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfSqrt2 = 0.70710678118654752440f;

__device__ __forceinline__ int clip_range(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 8 Lanczos (a = 4) weights of taps -3..4 around floor(coord), from one
// sinf and one sincosf (see the header).
__device__ __forceinline__ void lanczos4_weights(float frac, float* w) {
  const float s1 = sinf(kPi * frac);
  float s4, c4;
  sincosf(kPi * frac * 0.25f, &s4, &c4);
  const float d = kHalfSqrt2 * (s4 - c4), e = kHalfSqrt2 * (s4 + c4);
  // sin(pi t) * sin(pi t / 4) over s1, for t = frac - m, m = -3..4
  const float q[8] = {d, c4, -e, s4, -d, -c4, e, -s4};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t = frac - (float)(k - 3);
    const float pit = kPi * t;
    const bool small = fabsf(t) < 1e-7f;
    const float den = small ? 1.0f : pit * (pit * 0.25f);
    const float v = small ? 1.0f : (s1 * q[k]) / den;
    w[k] = fabsf(t) < 4.0f ? v : 0.0f;
  }
  float total = w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) total = total + w[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = w[k] / total;
}

// Where one output pixel samples: the first tap's row and column before the
// frame clamp, and the fractional phases.
struct Sample {
  int by, bx;
  float fy, fx;
};

__device__ __forceinline__ Sample sample_at(float mx, float my, int y, int x,
                                            int bounded, int dy0, int dy1,
                                            int dx0, int dx1) {
  const float x0 = floorf(mx), y0 = floorf(my);
  Sample s;
  s.fx = mx - x0;
  s.fy = my - y0;
  s.bx = (int)x0;
  s.by = (int)y0;
  if (bounded) {
    s.by = y + clip_range(s.by - y, dy0, dy1);
    s.bx = x + clip_range(s.bx - x, dx0, dx1);
  }
  return s;
}

// The block's pixels for Lanczos4. NC channels are summed together: 3 for an
// (H, W, 3) image with shared maps, whose channels lie side by side at every
// tap (channel n at offset n), else 1.
template <int NC>
__device__ __forceinline__ void lanczos4_pixels(
    const float* __restrict__ img, const float* __restrict__ map_x,
    const float* __restrict__ map_y, float* __restrict__ out, int H, int W,
    int C, long long img_plane, int pix_stride, long long map_plane,
    int bounded, int dy0, int dy1, int dx0, int dx1) {
  for (int i = threadIdx.x; i < kTileX * kTileY; i += blockDim.x) {
    const int y = blockIdx.y * kTileY + i / kTileX;
    const int x = blockIdx.x * kTileX + i % kTileX;
    if (y >= H || x >= W) continue;
    const size_t p = (size_t)y * W + x;
    size_t rows[8], cols[8];  // offsets of the clamped tap rows and columns
    float wy[8], wx[8];
    for (int c = 0; c < C; c += NC) {
      if (c == 0 || map_plane != 0) {
        const size_t m = (size_t)c * (size_t)map_plane + p;
        const Sample s = sample_at(map_x[m], map_y[m], y, x, bounded, dy0,
                                   dy1, dx0, dx1);
        lanczos4_weights(s.fx, wx);
        lanczos4_weights(s.fy, wy);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          rows[k] = (size_t)clamp_index(s.by - 3 + k, H) * W * pix_stride;
          cols[k] = (size_t)clamp_index(s.bx - 3 + k, W) * pix_stride;
        }
      }
      const float* const plane = img + (size_t)c * (size_t)img_plane;
      float v[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) v[n] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* const row = plane + rows[j];
        float acc[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[n] = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
#pragma unroll
          for (int n = 0; n < NC; ++n)
            acc[n] = acc[n] + wx[k] * __ldg(row + cols[k] + n);
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) v[n] = v[n] + wy[j] * acc[n];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
        out[(size_t)(c + n) * (size_t)img_plane + p * pix_stride] = v[n];
    }
  }
}

// One block computes a kTileX x kTileY tile of every channel.
__global__ void __launch_bounds__(kThreads, REMAP_MIN_BLOCKS)
lanczos4_kernel(const float* __restrict__ img, const float* __restrict__ map_x,
                const float* __restrict__ map_y, float* __restrict__ out, int H,
                int W, int C, long long img_plane, int pix_stride,
                long long map_plane, int bounded, int dy0, int dy1, int dx0,
                int dx1) {
  if (C == 3 && img_plane == 1 && pix_stride == 3 && map_plane == 0) {
    lanczos4_pixels<3>(img, map_x, map_y, out, H, W, C, img_plane, pix_stride,
                       map_plane, bounded, dy0, dy1, dx0, dx1);
    return;
  }
  lanczos4_pixels<1>(img, map_x, map_y, out, H, W, C, img_plane, pix_stride,
                     map_plane, bounded, dy0, dy1, dx0, dx1);
}

// Where a bilinear sample reads: the offsets of its four taps in a plane
// (rows y0, y0 + 1 by columns x0, x0 + 1, each clamped into the frame) and its
// phases.
template <class Off>
struct BilinearTaps {
  Off o00, o01, o10, o11;
  float fx, fy;
};

template <class Off>
__device__ __forceinline__ BilinearTaps<Off> bilinear_taps(
    const float* __restrict__ map_x, const float* __restrict__ map_y, Off m,
    int y, int x, int H, int W, int pix_stride, int bounded, int dy0, int dy1,
    int dx0, int dx1) {
  const Sample s = sample_at(map_x[m], map_y[m], y, x, bounded, dy0, dy1, dx0,
                             dx1);
  const Off row0 = (Off)clamp_index(s.by, H) * W * pix_stride;
  const Off row1 = (Off)clamp_index(s.by + 1, H) * W * pix_stride;
  const Off col0 = (Off)clamp_index(s.bx, W) * pix_stride;
  const Off col1 = (Off)clamp_index(s.bx + 1, W) * pix_stride;
  return {row0 + col0, row0 + col1, row1 + col0, row1 + col1, s.fx, s.fy};
}

// One thread an output pixel of a kBlTileX x kBlTileY tile, over every
// channel, kGroup channels at a time: all their taps are loaded before the
// first lerp. (The pixel loop strides by blockDim.x, so that one thread can
// also walk a whole tile, as the tests' CPU schedule runs it.) With shared maps (kShared) the taps' offsets and phases are
// computed once a pixel; with a map for each channel, once a channel. Off is
// int where every index of img, out and the maps fits in 31 bits, else long
// long.
template <bool kShared, class Off>
__global__ void __launch_bounds__(kBlThreads,
                                  kShared && sizeof(Off) == 4 ? kBlMinBlocks : 1)
bilinear_kernel(const float* __restrict__ img, const float* __restrict__ map_x,
                const float* __restrict__ map_y, float* __restrict__ out, int H,
                int W, int C, long long img_plane, int pix_stride,
                long long map_plane, int bounded, int dy0, int dy1, int dx0,
                int dx1) {
  const Off plane = (Off)img_plane;
  for (int i = threadIdx.x; i < kBlTileX * kBlTileY; i += blockDim.x) {
    const int y = blockIdx.y * kBlTileY + i / kBlTileX;
    const int x = blockIdx.x * kBlTileX + i % kBlTileX;
    if (y >= H || x >= W) continue;
    const Off p = (Off)y * W + x;
    BilinearTaps<Off> taps[kShared ? 1 : kGroup];
    if (kShared)
      taps[0] = bilinear_taps<Off>(map_x, map_y, p, y, x, H, W, pix_stride,
                                   bounded, dy0, dy1, dx0, dx1);
    for (int c = 0; c < C; c += kGroup) {
      const int here = C - c;  // channels in this group: kGroup or fewer
      if (!kShared) {
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
          if (n < here)
            taps[n] = bilinear_taps<Off>(
                map_x, map_y, (Off)(c + n) * (Off)map_plane + p, y, x, H, W,
                pix_stride, bounded, dy0, dy1, dx0, dx1);
      }
      float v[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        if (n < here) {
          const BilinearTaps<Off>& t = taps[kShared ? 0 : n];
          const float* const src = img + (Off)(c + n) * plane;
          v[n][0] = __ldg(src + t.o00);
          v[n][1] = __ldg(src + t.o01);
          v[n][2] = __ldg(src + t.o10);
          v[n][3] = __ldg(src + t.o11);
        }
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        if (n < here) {
          const BilinearTaps<Off>& t = taps[kShared ? 0 : n];
          const float top = v[n][0] * (1.0f - t.fx) + v[n][1] * t.fx;
          const float bot = v[n][2] * (1.0f - t.fx) + v[n][3] * t.fx;
          out[(Off)(c + n) * plane + p * pix_stride] =
              top * (1.0f - t.fy) + bot * t.fy;
        }
      }
    }
  }
}

using BilinearFn = void (*)(const float*, const float*, const float*, float*,
                            int, int, int, long long, int, long long, int, int,
                            int, int, int);

// The bilinear kernel that pysp_remap launches: shared maps or one for each
// channel, and 32-bit offsets unless an index needs more (or `wide`); every
// index of img, out and the maps is below C * H * W in either layout.
inline BilinearFn bilinear_variant(int H, int W, int C, long long map_plane,
                                   bool wide) {
  wide = wide || (long long)C * H * W > 0x7fffffffLL;
  if (map_plane == 0) {
    if (wide) return bilinear_kernel<true, long long>;
    return bilinear_kernel<true, int>;
  }
  if (wide) return bilinear_kernel<false, long long>;
  return bilinear_kernel<false, int>;
}

// --- The radial kind: CA removal's coordinates computed in the kernel -------
//
// The forms of a radial model r_d = f(r_u) (correct/ca/models.py), in the
// order of ops/cuda_kernels.py's RADIAL_FORMS. Each reads its constants c[]
// as the model's kernel_form() gives them: the float32 values PyTorch rounds
// the model's Python scalars to against a float32 tensor.
enum RadialForm { kPoly3 = 0, kPoly5 = 1, kPtLens = 2 };
constexpr int kRadialConstants = 6;
constexpr int kNewtonSteps = 8;

// The frame's centre, the float32 reciprocal of its corner radius and the
// model's constants: the kernel's arguments in place of two maps.
struct RadialModel {
  float cy, cx, inv_r_corner;
  float c[kRadialConstants];
};

// f(u) and f'(u), each plain PyTorch operation of the model's expression one
// rounding, in its order (u**3 is PyTorch's u * u * u, u**2 its u * u).
template <int kForm>
__device__ __forceinline__ float radial_f(const float* c, float u) {
  if (kForm == kPoly3)  // k1 u^3 + (1 - k1) u; c = {k1, 1 - k1, 3 k1}
    return __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(u, u), u), c[0]),
                     __fmul_rn(c[1], u));
  if (kForm == kPoly5) {  // u (1 + u^2 (h1 + u^2 h2)); c = {h1, h2, 3 h1, 5 h2}
    const float r2 = __fmul_rn(u, u);
    return __fmul_rn(
        u, __fadd_rn(__fmul_rn(r2, __fadd_rn(__fmul_rn(r2, c[1]), c[0])), 1.0f));
  }
  // u (d + u (c + u (b + u a))); c = {a, b, c, d, 3 b, 2 c}
  return __fmul_rn(
      u, __fadd_rn(__fmul_rn(u, __fadd_rn(__fmul_rn(u, __fadd_rn(
                                               __fmul_rn(u, c[0]), c[1])),
                                           c[2])),
                   c[3]));
}

template <int kForm>
__device__ __forceinline__ float radial_df(const float* c, float u) {
  if (kForm == kPoly3)  // 3 k1 u^2 + (1 - k1)
    return __fadd_rn(__fmul_rn(c[2], __fmul_rn(u, u)), c[1]);
  if (kForm == kPoly5) {  // 1 + u^2 (3 h1 + 5 h2 u^2)
    const float r2 = __fmul_rn(u, u);
    return __fadd_rn(__fmul_rn(r2, __fadd_rn(__fmul_rn(c[3], r2), c[2])), 1.0f);
  }
  // d + u (2 c + u (3 b + (u 4) a))
  return __fadd_rn(
      __fmul_rn(u, __fadd_rn(__fmul_rn(u, __fadd_rn(__fmul_rn(__fmul_rn(u, 4.0f),
                                                              c[0]),
                                                    c[4])),
                             c[5])),
      c[3]);
}

// torch.clamp(v, 0, hi): NaN passes through.
__device__ __forceinline__ float clamp_map(float v, float hi) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), hi);
}

// The scale of the offset (ys, xs) from the centre, as
// model.get_*_coordinates(...) computes it: the offset's radius over the
// corner's (PyTorch divides by a Python scalar as a multiply by the float32
// rounding of the scalar's reciprocal), then f(r) / r, or for the inverse
// u(r) / r with u from kNewtonSteps Newton steps from zero and no early exit;
// 1 at r == 0.
template <int kForm, bool kInverse>
struct RadialCoords {
  static __device__ __forceinline__ float scale(const RadialModel& m, float ys,
                                                float xs) {
    const float r = __fmul_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(ys, ys), __fmul_rn(xs, xs))),
        m.inv_r_corner);
    if (r == 0.0f) return 1.0f;
    float u;
    if (kInverse) {
      u = 0.0f;
#pragma unroll
      for (int k = 0; k < kNewtonSteps; ++k)
        u = __fsub_rn(u, __fdiv_rn(__fsub_rn(radial_f<kForm>(m.c, u), r),
                                   radial_df<kForm>(m.c, u)));
    } else {
      u = radial_f<kForm>(m.c, r);
    }
    return __fdiv_rn(u, r);
  }
};

// One axis of a pixel's sample, as _maps_from_offsets takes it: the offset
// scaled, moved back by the centre and clamped into [0, n - 1].
__device__ __forceinline__ float radial_map(float offset, float scale,
                                            float centre, int n) {
  return clamp_map(__fadd_rn(__fmul_rn(offset, scale), centre), (float)(n - 1));
}

// The bilinear kind with the coordinates from Coords (RadialCoords) in place
// of two maps. The scale depends on the offset's square alone, and the
// offsets of the pixels mirrored about the centre's row and column are the
// exact negations of each other, so one thread computes the scale of a pixel
// of the frame's top-left quadrant (the middle row and column of an odd side
// included) and serves the up to four pixels it mirrors to: each takes its
// own clamped sample, then the taps and lerps of the maps path (the same
// operations in the same order) over every channel of the (C, H, W) stack,
// kGroup channels' taps loaded before the first lerp. The maps path's code is
// left as it was, so that its instantiations compile as before. Bound by its
// instructions at the inverse (8 Newton steps and nine IEEE divisions a
// quadrant pixel), by its 8 B a pixel and channel at the forward (see the
// header).
template <class Off, class Coords>
__global__ void __launch_bounds__(kBlThreads,
                                  sizeof(Off) == 4 ? kBlMinBlocks : 1)
bilinear_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                int W, int C, long long img_plane, RadialModel model) {
  const Off plane = (Off)img_plane;
  for (int i = threadIdx.x; i < kBlTileX * kBlTileY; i += blockDim.x) {
    const int y = blockIdx.y * kBlTileY + i / kBlTileX;
    const int x = blockIdx.x * kBlTileX + i % kBlTileX;
    if (2 * y >= H + 1 || 2 * x >= W + 1) continue;
    const float ys = __fsub_rn((float)y, model.cy);
    const float xs = __fsub_rn((float)x, model.cx);
    const float scale = Coords::scale(model, ys, xs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool flip_y = q & 1, flip_x = q & 2;
      const int yq = flip_y ? H - 1 - y : y, xq = flip_x ? W - 1 - x : x;
      if ((flip_y && yq == y) || (flip_x && xq == x)) continue;
      const Sample s = sample_at(radial_map(flip_x ? -xs : xs, scale, model.cx, W),
                                 radial_map(flip_y ? -ys : ys, scale, model.cy, H),
                                 yq, xq, 0, 0, 0, 0, 0);
      const Off row0 = (Off)clamp_index(s.by, H) * W;
      const Off row1 = (Off)clamp_index(s.by + 1, H) * W;
      const Off col0 = (Off)clamp_index(s.bx, W);
      const Off col1 = (Off)clamp_index(s.bx + 1, W);
      const Off p = (Off)yq * W + xq;
      for (int c = 0; c < C; c += kGroup) {
        const int here = C - c;
        float v[kGroup][4];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          if (n < here) {
            const float* const src = img + (Off)(c + n) * plane;
            v[n][0] = __ldg(src + row0 + col0);
            v[n][1] = __ldg(src + row0 + col1);
            v[n][2] = __ldg(src + row1 + col0);
            v[n][3] = __ldg(src + row1 + col1);
          }
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          if (n < here) {
            const float top = v[n][0] * (1.0f - s.fx) + v[n][1] * s.fx;
            const float bot = v[n][2] * (1.0f - s.fx) + v[n][3] * s.fx;
            out[(Off)(c + n) * plane + p] = top * (1.0f - s.fy) + bot * s.fy;
          }
        }
      }
    }
  }
}

// The grid of a radial launch: the tiles of the top-left quadrant.
inline dim3 radial_grid(int H, int W) {
  const int hq = (H + 1) / 2, wq = (W + 1) / 2;
  return dim3((wq + kBlTileX - 1) / kBlTileX, (hq + kBlTileY - 1) / kBlTileY);
}

using RadialFn = void (*)(const float*, float*, int, int, int, long long,
                          RadialModel);

template <class Off>
inline RadialFn radial_form_variant(int form, bool inverse) {
  switch (form * 2 + (int)inverse) {
    case kPoly3 * 2: return bilinear_kernel<Off, RadialCoords<kPoly3, false>>;
    case kPoly3 * 2 + 1: return bilinear_kernel<Off, RadialCoords<kPoly3, true>>;
    case kPoly5 * 2: return bilinear_kernel<Off, RadialCoords<kPoly5, false>>;
    case kPoly5 * 2 + 1: return bilinear_kernel<Off, RadialCoords<kPoly5, true>>;
    case kPtLens * 2: return bilinear_kernel<Off, RadialCoords<kPtLens, false>>;
    case kPtLens * 2 + 1: return bilinear_kernel<Off, RadialCoords<kPtLens, true>>;
  }
  return nullptr;
}

// The radial kernel that pysp_remap_radial launches (nullptr for a form it
// does not know): 32-bit offsets unless an index needs more (or `wide`).
inline RadialFn radial_variant(int H, int W, int C, int form, bool inverse,
                               bool wide) {
  wide = wide || (long long)C * H * W > 0x7fffffffLL;
  return wide ? radial_form_variant<long long>(form, inverse)
              : radial_form_variant<int>(form, inverse);
}

// params: cy, cx, 1 / r_corner, then kRadialConstants constants.
inline RadialModel radial_model(const float* params) {
  RadialModel m;
  m.cy = params[0];
  m.cx = params[1];
  m.inv_r_corner = params[2];
  for (int k = 0; k < kRadialConstants; ++k) m.c[k] = params[3 + k];
  return m;
}

}  // namespace

#ifdef __CUDACC__
// Launches the remap on `stream` (kind 0 bilinear, 1 Lanczos4; bounds used
// when `bounded` is nonzero); returns the cudaError_t of the launch.
extern "C" int pysp_remap(const float* img, const float* map_x,
                          const float* map_y, float* out, int H, int W, int C,
                          long long img_plane, int pix_stride,
                          long long map_plane, int kind, int bounded, int dy0,
                          int dy1, int dx0, int dx1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 1) {
    const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
    lanczos4_kernel<<<grid, kThreads, 0, s>>>(
        img, map_x, map_y, out, H, W, C, img_plane, pix_stride, map_plane,
        bounded, dy0, dy1, dx0, dx1);
  } else if (kind == 0) {
    const BilinearFn kernel = bilinear_variant(H, W, C, map_plane, false);
    const dim3 grid((W + kBlTileX - 1) / kBlTileX, (H + kBlTileY - 1) / kBlTileY);
    kernel<<<grid, kBlThreads, 0, s>>>(img, map_x, map_y, out, H, W, C,
                                       img_plane, pix_stride, map_plane,
                                       bounded, dy0, dy1, dx0, dx1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches the bilinear remap of an (H, W) plane or a contiguous (C, H, W)
// stack through a radial model's coordinates computed in the kernel (`form`
// one of RadialForm, `inverse` nonzero for the Newton inverse; `params` on
// the host: cy, cx, 1 / r_corner, then the model's six constants); returns
// the cudaError_t of the launch.
extern "C" int pysp_remap_radial(const float* img, float* out, int H, int W,
                                 int C, long long img_plane, int form,
                                 int inverse, const float* params,
                                 void* stream) {
  const RadialFn kernel = radial_variant(H, W, C, form, inverse != 0, false);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<radial_grid(H, W), kBlThreads, 0, (cudaStream_t)stream>>>(img, out, H, W, C,
                                                        img_plane,
                                                        radial_model(params));
  return (int)cudaGetLastError();
}
#endif
