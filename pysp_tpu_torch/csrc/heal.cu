// Hot-pixel heal: every sweep of the masked normalized-convolution fill on the
// four CFA planes of a frame, in one launch.
//
//   v = 1 - m, x = chan * v
//   fill sweeps:   xs = ((up + down) + left) + right of x, vs the same of v,
//                  x = v > 0 ? x : xs / max(vs, 1), v = min(v + vs, 1)
//   seed:          x = v > 0 ? x : mean of the plane
//   smooth sweeps: x = m ? 0.25 * (((up + down) + left) + right of x) : chan
//   out = m ? x : chan
//
// every neighbour taken with a replicate border of its own plane.
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::masked_fill_pallas (body
// _heal_kernel). Plain version beside it:
// pysp_tpu_torch/correct/bad_pixels.py::masked_fill_inpaint
// (ops/cuda_kernels.py::heal_plain).
//
// What bounds it on an H100: device memory. It reads each plane value (4 B)
// and mask byte once and writes each result once (9 B per site); hot-pixel
// masks flag about 1e-4 of the sites, and everywhere else out = chan. So the
// kernel is a copy at full speed with the sweeps only where a site is. A
// block copies a 32x64 tile (out = chan) with 8-byte mask loads and 16-byte
// plane loads and stores, eight sites a thread, and notes which of its 16x16
// sub-tiles hold a masked site (one barrier, at the end). Only those run the
// sweeps, in a shared-memory region that every block reserves (21 KB at
// 4 + 2 sweeps; with at most 40 registers a thread, six blocks an SM copy at
// once). For each 32x32 half of the tile that holds a site, the region is
// the half with a halo of R = fill + smooth sites where two or more of its
// sub-tiles hold one (dense masks), else the one 16x16 sub-tile with its halo
// (hot pixels: 28x28 cells at 4 + 2 sweeps instead of 44x44), clipped to the
// plane. It holds x twice as floats and v twice and the mask as bytes: v is
// 0 or 1 (min(v + vs, 1) of integers), and chan is not kept, since
// x = chan * 1 stays chan at every unmasked site. Sweep s computes the cells
// within R - 1 - s of the square (up to the plane's edge where the halo
// reaches it), which is what the next sweep reads; neighbours are clamped to
// the loaded region, which at the plane's edge is the replicate border. After
// the sweeps the square's masked sites are written over the copy. A block
// whose tile leaves the plane, or whose rows are not 16-byte aligned, copies
// site by site.
//
// Exactness: the plain version's operations in its order (the vertical pair
// first, then left, then right; a true division; * 0.25), built with
// -fmad=false, and the plane means computed once by the caller (torch.mean)
// and shared with the plain version, so the result is bit-identical to it.
//
// Layout: chan and out are float32 (4, H, W), mask is bool (4, H, W) read as
// bytes, means is float32 (4,). Takes fill + smooth <= kMaxSweeps (the
// caller's gate) and planes of any size, smaller than the halo included.
#include "tile_loops.cuh"

namespace {



constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;  // blocks an SM: at most 40 registers a thread
constexpr int kCopyH = 32;   // a block's copy tile: rows
constexpr int kCopyW = 64;   // and columns
constexpr int kSub = 16;     // a sweep sub-tile's edge
constexpr int kPair = 32;    // a 32x32 half of the copy tile: 2x2 sub-tiles
constexpr int kSubX = kCopyW / kSub;   // sub-tiles along a copy tile's row
constexpr int kGroup = 8;    // sites a thread copies at once
constexpr int kMaxSweeps = 8;

__host__ __device__ constexpr int heal_region(int edge, int sweeps) { return edge + 2 * sweeps; }

// Shared memory for a region around a 32x32 half, which also holds one
// around a 16x16 sub-tile: x twice as floats; v twice and the mask as bytes
// (v is 0 or 1: min(v + vs, 1) of integers).
__host__ __device__ constexpr int heal_smem_bytes(int sweeps) {
  return heal_region(kPair, sweeps) * heal_region(kPair, sweeps) *
         (2 * (int)sizeof(float) + 3);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Eight sites of a row: their mask bytes and plane values.
struct Group {
  unsigned long long m;
  Vec4 a, b;
};

// ((up + down) + left) + right, neighbours clamped to the region: a float for
// x, an int for v's bytes (a sum of 0s and 1s, which the plain version's float
// sum gives exactly).
template <class T>
__device__ __forceinline__ auto nb_sum(const T* a, int ly, int lx, int nh, int nw) {
  const int up = ly > 0 ? ly - 1 : 0, dn = ly < nh - 1 ? ly + 1 : nh - 1;
  const int lf = lx > 0 ? lx - 1 : 0, rt = lx < nw - 1 ? lx + 1 : nw - 1;
  return ((a[up * nw + lx] + a[dn * nw + lx]) + a[ly * nw + lf]) + a[ly * nw + rt];
}

// The OR of every thread's bits, returned to every thread (one barrier).
__device__ __forceinline__ unsigned block_or(unsigned bits) {
  __shared__ unsigned warp_bits[kThreads / 32];
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_bits[threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned all = 0;
  for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) all |= warp_bits[w];
  return all;
}

// out = chan over the block's copy tile at (y0, x0); returns the bits of its
// sub-tiles that hold a masked site (sub-tile (sy, sx) is bit sy * kSubX + sx).
// kVector: the tile lies inside the plane and its rows are 16-byte aligned.
template <bool kVector>
__device__ __forceinline__ unsigned copy_tile(const float* __restrict__ chan,
                                              const unsigned char* __restrict__ mask,
                                              float* __restrict__ out, size_t base,
                                              int y0, int x0, int H, int W) {
  unsigned bits = 0;
  if (kVector) {
    for_cells_loading<2>(
        kCopyH, kCopyW / kGroup,
        [&](int r, int c) {
          const size_t g = base + (size_t)(y0 + r) * W + x0 + c * kGroup;
          Group v;
          v.m = *reinterpret_cast<const unsigned long long*>(mask + g);
          v.a = *reinterpret_cast<const Vec4*>(chan + g);
          v.b = *reinterpret_cast<const Vec4*>(chan + g + 4);
          return v;
        },
        [&](int r, int c, const Group& v) {
          const size_t g = base + (size_t)(y0 + r) * W + x0 + c * kGroup;
          *reinterpret_cast<Vec4*>(out + g) = v.a;
          *reinterpret_cast<Vec4*>(out + g + 4) = v.b;
          if (v.m) bits |= 1u << ((r / kSub) * kSubX + c * kGroup / kSub);
        });
  } else {
    for_cells(imin(kCopyH, H - y0), imin(kCopyW, W - x0), [&](int r, int c) {
      const size_t g = base + (size_t)(y0 + r) * W + x0 + c;
      out[g] = chan[g];
      if (mask[g]) bits |= 1u << ((r / kSub) * kSubX + c / kSub);
    });
  }
  return block_or(bits);
}

// Every sweep of the kEdge x kEdge square at (ty0, tx0) in shared memory;
// writes its masked sites.
template <int kEdge>
__device__ void heal_square(const float* __restrict__ chan,
                             const unsigned char* __restrict__ mask, float seed,
                             float* __restrict__ out, size_t base, int ty0, int tx0, int H,
                             int W, int fill, int smooth, float* smem) {
  const int sweeps = fill + smooth;
  // The loaded region, clipped to the plane: rows [ly0, ly1), cols [lx0, lx1).
  const int ly0 = imax(ty0 - sweeps, 0), lx0 = imax(tx0 - sweeps, 0);
  const int ly1 = imin(ty0 + kEdge + sweeps, H), lx1 = imin(tx0 + kEdge + sweeps, W);
  const int nh = ly1 - ly0, nw = lx1 - lx0;
  const int cap = heal_region(kEdge, sweeps) * heal_region(kEdge, sweeps);
  float* xa = smem;
  float* xb = xa + cap;
  unsigned char* va = reinterpret_cast<unsigned char*>(xb + cap);
  unsigned char* vb = va + cap;
  unsigned char* const s_m = vb + cap;

  for_cells(nh, nw, [&](int r, int c) {
    const size_t g = base + (size_t)(ly0 + r) * W + lx0 + c;
    const float ch = chan[g];
    const unsigned char m = mask[g];
    const int i = r * nw + c;
    xa[i] = ch * (1.0f - (m ? 1.0f : 0.0f));
    va[i] = m ? 0 : 1;
    s_m[i] = m;
  });
  __syncthreads();

  // f(ly, lx, i) over the cells within k of the square, in region coordinates.
  auto within = [&](int k, auto f) {
    const int r0 = imax(ty0 - k, ly0) - ly0, c0 = imax(tx0 - k, lx0) - lx0;
    const int r1 = imin(ty0 + kEdge + k, ly1) - ly0, c1 = imin(tx0 + kEdge + k, lx1) - lx0;
    for_cells(r1 - r0, c1 - c0, [&](int r, int c) {
      const int ly = r0 + r, lx = c0 + c;
      f(ly, lx, ly * nw + lx);
    });
  };

  for (int s = 0; s < fill; ++s) {
    within(sweeps - 1 - s, [&](int ly, int lx, int i) {
      const float xs = nb_sum(xa, ly, lx, nh, nw);
      const int vs = nb_sum(va, ly, lx, nh, nw);
      const float filled = xs / fmaxf((float)vs, 1.0f);
      xb[i] = va[i] ? xa[i] : filled;
      vb[i] = va[i] | (vs > 0);
    });
    __syncthreads();
    float* t = xa; xa = xb; xb = t;
    unsigned char* u = va; va = vb; vb = u;
  }

  within(smooth, [&](int, int, int i) {
    if (!va[i]) xa[i] = seed;
  });
  __syncthreads();

  for (int s = 0; s < smooth; ++s) {
    within(smooth - 1 - s, [&](int ly, int lx, int i) {
      xb[i] = s_m[i] ? nb_sum(xa, ly, lx, nh, nw) * 0.25f : xa[i];
    });
    __syncthreads();
    float* t = xa; xa = xb; xb = t;
  }

  within(0, [&](int ly, int lx, int i) {
    if (s_m[i]) out[base + (size_t)(ly0 + ly) * W + lx0 + lx] = xa[i];
  });
  __syncthreads();  // the next square reuses the region
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
heal_kernel(const float* __restrict__ chan, const unsigned char* __restrict__ mask,
            const float* __restrict__ means, float* __restrict__ out, int H, int W,
            int fill, int smooth, int rows_aligned) {
  extern __shared__ float smem[];
  const int y0 = blockIdx.y * kCopyH, x0 = blockIdx.x * kCopyW;
  const size_t base = (size_t)blockIdx.z * (size_t)H * (size_t)W;
  const unsigned dirty = rows_aligned && y0 + kCopyH <= H && x0 + kCopyW <= W
                       ? copy_tile<true>(chan, mask, out, base, y0, x0, H, W)
                       : copy_tile<false>(chan, mask, out, base, y0, x0, H, W);
  // Each 32x32 half with a site: one sweep region around the half where two or
  // more of its sub-tiles hold a site (dense masks), else around that one
  // sub-tile (hot pixels: a 28x28 region at 4 + 2 sweeps instead of 44x44).
  const float seed = means[blockIdx.z];
  for (int hx = 0; hx < kCopyW / kPair; ++hx) {
    const unsigned half = dirty & ((0x3u << (2 * hx)) | (0x3u << (kSubX + 2 * hx)));
    if (__popc(half) >= 2) {
      heal_square<kPair>(chan, mask, seed, out, base, y0, x0 + hx * kPair, H, W, fill,
                         smooth, smem);
    } else if (half) {
      const int s = __ffs(half) - 1;
      heal_square<kSub>(chan, mask, seed, out, base, y0 + (s / kSubX) * kSub,
                        x0 + (s % kSubX) * kSub, H, W, fill, smooth, smem);
    }
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches the heal of the four planes on `stream`; returns the cudaError_t of
// the launch (cudaErrorInvalidValue for sweep counts the kernel does not take).
extern "C" int pysp_heal(const float* chan, const unsigned char* mask, const float* means,
                         float* out, int H, int W, int fill, int smooth, void* stream) {
  if (fill < 0 || smooth < 0 || fill + smooth > kMaxSweeps || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  static int ready_device = -1;
  cudaError_t err = allow_shared_memory(heal_kernel, heal_smem_bytes(kMaxSweeps),
                                        &ready_device);
  if (err != cudaSuccess) return (int)err;
  // 16-byte rows: W a multiple of 8 (so is every plane's offset) and aligned
  // pointers; the tiles of such planes that lie inside take vector accesses.
  const int rows_aligned = W % kGroup == 0 && (size_t)chan % 16 == 0 &&
                           (size_t)out % 16 == 0 && (size_t)mask % 8 == 0;
  const dim3 grid((W + kCopyW - 1) / kCopyW, (H + kCopyH - 1) / kCopyH, 4);
  heal_kernel<<<grid, kThreads, heal_smem_bytes(fill + smooth), (cudaStream_t)stream>>>(
      chan, mask, means, out, H, W, fill, smooth, rows_aligned);
  return (int)cudaGetLastError();
}
#endif
