// One Richardson-Lucy (RL) iteration with a separable symmetric PSF, over
// every channel of a float32 image:
//
//   out = est * blur(img / (blur(est) + 1e-25))
//
// blur = H pass then V pass of the 1-D taps, taps ascending, multiply then
// add, each pass with a symmetric (cv2.BORDER_REFLECT, edge repeated) border.
//
// Replaces: pysp_tpu/ops/pallas_kernels.py::rl_deconv_pallas (body
// _rl_iter_kernel). Plain version beside it:
// pysp_tpu_torch/ops/cuda_kernels.py::rl_plain.
//
// What bounds it on an H100: device memory. Per pixel and iteration it reads
// est and img and writes est (12 B) against 4 passes of k taps (2 flops each),
// about 8 flops per byte at k = 7, below the card's 20 flops per byte of
// float32 ALU rate to memory rate. The design reads each input once per
// iteration: a block loads its 32x32 tile of est with a 2r halo and of img
// with an r halo into shared memory (r = taps / 2), and both blurs, the ratio
// and the product run there; only the tile of est * factor is written.
//
// The border. The second blur reads the RATIO ARRAY mirrored at the frame
// border, ratio[-1-k] = ratio[k], which is not the ratio evaluated at the
// reflected coordinates (blur(est) there sums its taps in the other order).
// So the kernel computes blur(est) on the in-frame cells of the region only,
// and takes the ratio of an out-of-frame cell from the mirrored in-frame
// cell, which lies inside the same region. Every operation is the plain
// loop's, in its order, with FMA contraction off (-fmad=false) and IEEE
// division, so the result is bit-identical to it.
//
// Layout: element (c, y, x) sits at c * plane_stride + (y * W + x) * pix_stride
// in est, img and out, so (H, W), (C, H, W) and (H, W, C) all launch as they
// lie. Takes 3 <= taps <= 65, odd, and H, W >= 2 r (the caller's gate).
namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 65;

struct Taps {
  float w[kMaxTaps];
};

// Symmetric border index; cells beyond the 2r halo that no output needs are
// clamped into the frame so their loads stay in bounds.
__device__ __forceinline__ int mirror(int i, int n) {
  if (i < 0) i = -1 - i;
  if (i >= n) i = 2 * n - 1 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__host__ __device__ inline int smem_floats(int r) {
  const int n_est = kTile + 4 * r, n_mid = kTile + 2 * r;
  return n_est * n_est + n_est * n_mid + n_mid * n_mid;
}

__global__ void __launch_bounds__(kThreads)
rl_iter_kernel(const float* __restrict__ est, const float* __restrict__ img,
               float* __restrict__ out, int H, int W, long long plane_stride,
               int pix_stride, Taps taps, int r) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const int n_est = kTile + 4 * r;   // est region: rows/cols [t0 - 2r, t0 + kTile + 2r)
  const int n_mid = kTile + 2 * r;   // blur/ratio region: [t0 - r, t0 + kTile + r)
  float* const s_a = smem;                         // est, then blur(est), then H pass of ratio
  float* const s_b = s_a + n_est * n_est;          // H pass of est, then ratio
  float* const s_img = s_b + n_est * n_mid;        // img over the mid region

  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.z * (size_t)plane_stride;
  const float* const e = est + base;
  const float* const im = img + base;

  for (int i = threadIdx.x; i < n_est * n_est; i += blockDim.x) {
    const int gy = mirror(y0 - 2 * r + i / n_est, H);
    const int gx = mirror(x0 - 2 * r + i % n_est, W);
    s_a[i] = e[((size_t)gy * W + gx) * pix_stride];
  }
  for (int i = threadIdx.x; i < n_mid * n_mid; i += blockDim.x) {
    const int gy = mirror(y0 - r + i / n_mid, H);
    const int gx = mirror(x0 - r + i % n_mid, W);
    s_img[i] = im[((size_t)gy * W + gx) * pix_stride];
  }
  __syncthreads();

  // H pass of est: rows of the est region, columns of the mid region.
  for (int i = threadIdx.x; i < n_est * n_mid; i += blockDim.x) {
    const int row = i / n_mid, col = i % n_mid;
    const float* src = s_a + row * n_est + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t];
    s_b[i] = acc;
  }
  __syncthreads();

  // V pass: blur(est) over the mid region, into s_a (est is read from global
  // memory at the end).
  for (int i = threadIdx.x; i < n_mid * n_mid; i += blockDim.x) {
    const int row = i / n_mid, col = i % n_mid;
    const float* src = s_b + row * n_mid + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t * n_mid];
    s_a[i] = acc;
  }
  __syncthreads();

  // Ratio over the mid region, into s_b. An out-of-frame cell takes the
  // mirrored in-frame cell's ratio; cells more than r outside the frame feed
  // no output and are skipped.
  for (int i = threadIdx.x; i < n_mid * n_mid; i += blockDim.x) {
    const int gy = y0 - r + i / n_mid, gx = x0 - r + i % n_mid;
    if (gy < -r || gy >= H + r || gx < -r || gx >= W + r) continue;
    const int ly = mirror(gy, H) - (y0 - r), lx = mirror(gx, W) - (x0 - r);
    const int m = ly * n_mid + lx;
    s_b[i] = s_img[m] / (s_a[m] + 1e-25f);
  }
  __syncthreads();

  // H pass of the ratio: mid rows, tile columns, into s_a.
  for (int i = threadIdx.x; i < n_mid * kTile; i += blockDim.x) {
    const int row = i / kTile, col = i % kTile;
    const float* src = s_b + row * n_mid + col;
    float acc = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) acc = acc + taps.w[t] * src[t];
    s_a[i] = acc;
  }
  __syncthreads();

  // V pass and the product with est.
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const float* src = s_a + ty * kTile + tx;
    float factor = taps.w[0] * src[0];
    for (int t = 1; t < k; ++t) factor = factor + taps.w[t] * src[t * kTile];
    const size_t o = base + ((size_t)y * W + x) * pix_stride;
    out[o] = est[o] * factor;
  }
}

}  // namespace

#ifdef __CUDACC__
// Launches one iteration for C channels on `stream`; returns the cudaError_t
// of the launch (cudaErrorInvalidValue for taps the kernel does not take).
extern "C" int pysp_rl_iter(const float* est, const float* img, float* out,
                            int H, int W, int C, long long plane_stride,
                            int pix_stride, const float* taps, int n_taps,
                            void* stream) {
  if (n_taps < 3 || n_taps > kMaxTaps || n_taps % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < kMaxTaps; ++i) t.w[i] = i < n_taps ? taps[i] : 0.0f;
  const int r = n_taps / 2;
  const int bytes = smem_floats(r) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rl_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, C);
  rl_iter_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      est, img, out, H, W, plane_stride, pix_stride, t, r);
  return (int)cudaGetLastError();
}
#endif
