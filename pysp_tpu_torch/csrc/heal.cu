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
// and mask byte once and writes each result once (9 B per site) against
// about 10 operations per site and sweep. A block whose 32x32 tile holds no
// masked site copies the tile and stops, since every output there is chan;
// at hot-pixel densities (about 1e-4 of the sites) that is nearly every
// block. The others keep every sweep in shared memory: a block loads a 32x32
// tile of one plane with a halo of
// R = fill + smooth cells (clipped to the plane), runs all sweeps there and
// writes only its tile. Each sweep covers the whole loaded region with its
// neighbour indices clamped to that region. Where the region ends at the
// plane's edge the clamp is the replicate border; where it ends inside the
// plane the clamped values are wrong, but a sweep moves them in by one cell,
// so after R sweeps the tile, R cells in, is exact. This replaces the TPU
// kernel's one stacked VMEM band with its roll / where fixes, row modulo,
// alignment padding and double-buffered DMA, which exist only for Mosaic.
//
// Exactness: the plain version's operations in its order (the vertical pair
// first, then left, then right; a true division; * 0.25), built with
// -fmad=false, and the plane means computed once by the caller (torch.mean)
// and shared with the plain version, so the result is bit-identical to it.
//
// Layout: chan and out are float32 (4, H, W), mask is bool (4, H, W) read as
// bytes, means is float32 (4,). Takes fill + smooth <= kMaxSweeps (the
// caller's gate) and planes of any size, smaller than the halo included.
namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxSweeps = 8;

__host__ __device__ inline int heal_smem_floats(int sweeps) {
  const int n = kTile + 2 * sweeps;
  return 6 * n * n;   // chan, mask, x twice, v twice
}

__device__ __forceinline__ float nb_sum(const float* a, int ly, int lx, int nh, int nw) {
  const int up = ly > 0 ? ly - 1 : 0, dn = ly < nh - 1 ? ly + 1 : nh - 1;
  const int lf = lx > 0 ? lx - 1 : 0, rt = lx < nw - 1 ? lx + 1 : nw - 1;
  return ((a[up * nw + lx] + a[dn * nw + lx]) + a[ly * nw + lf]) + a[ly * nw + rt];
}

__global__ void __launch_bounds__(kThreads)
heal_kernel(const float* __restrict__ chan, const unsigned char* __restrict__ mask,
            const float* __restrict__ means, float* __restrict__ out, int H, int W,
            int fill, int smooth) {
  extern __shared__ float smem[];
  const int sweeps = fill + smooth;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  // The loaded region, clipped to the plane: rows [ly0, ly1), cols [lx0, lx1).
  const int ly0 = y0 - sweeps > 0 ? y0 - sweeps : 0;
  const int lx0 = x0 - sweeps > 0 ? x0 - sweeps : 0;
  const int ly1 = y0 + kTile + sweeps < H ? y0 + kTile + sweeps : H;
  const int lx1 = x0 + kTile + sweeps < W ? x0 + kTile + sweeps : W;
  const int nh = ly1 - ly0, nw = lx1 - lx0, n = nh * nw;
  const size_t base = (size_t)blockIdx.z * (size_t)H * (size_t)W;

  // A tile with no masked site keeps its input: every output is chan there.
  // Hot-pixel masks flag about 1e-4 of the sites, so most blocks stop here.
  int any = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int y = y0 + i / kTile, x = x0 + i % kTile;
    if (y < H && x < W && mask[base + (size_t)y * W + x]) any = 1;
  }
  if (!__syncthreads_or(any)) {
    for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
      const int y = y0 + i / kTile, x = x0 + i % kTile;
      if (y < H && x < W) out[base + (size_t)y * W + x] = chan[base + (size_t)y * W + x];
    }
    return;
  }

  float* const s_chan = smem;
  float* const s_m = s_chan + n;
  float* xa = s_m + n;
  float* xb = xa + n;
  float* va = xb + n;
  float* vb = va + n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t g = base + (size_t)(ly0 + i / nw) * W + (lx0 + i % nw);
    const float c = chan[g];
    const float m = mask[g] ? 1.0f : 0.0f;
    const float v = 1.0f - m;
    s_chan[i] = c;
    s_m[i] = m;
    xa[i] = c * v;
    va[i] = v;
  }
  __syncthreads();

  for (int s = 0; s < fill; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ly = i / nw, lx = i % nw;
      const float xs = nb_sum(xa, ly, lx, nh, nw);
      const float vs = nb_sum(va, ly, lx, nh, nw);
      const float filled = xs / fmaxf(vs, 1.0f);
      const float v = va[i];
      xb[i] = v > 0.0f ? xa[i] : filled;
      vb[i] = fminf(v + vs, 1.0f);
    }
    __syncthreads();
    float* t = xa; xa = xb; xb = t;
    t = va; va = vb; vb = t;
  }

  const float seed = means[blockIdx.z];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (!(va[i] > 0.0f)) xa[i] = seed;
  __syncthreads();

  for (int s = 0; s < smooth; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ly = i / nw, lx = i % nw;
      xb[i] = s_m[i] > 0.0f ? nb_sum(xa, ly, lx, nh, nw) * 0.25f : s_chan[i];
    }
    __syncthreads();
    float* t = xa; xa = xb; xb = t;
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int y = y0 + i / kTile, x = x0 + i % kTile;
    if (y >= H || x >= W) continue;
    const int l = (y - ly0) * nw + (x - lx0);
    out[base + (size_t)y * W + x] = s_m[l] > 0.0f ? xa[l] : s_chan[l];
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
  const int bytes = heal_smem_floats(fill + smooth) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      heal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, 4);
  heal_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      chan, mask, means, out, H, W, fill, smooth);
  return (int)cudaGetLastError();
}
#endif
