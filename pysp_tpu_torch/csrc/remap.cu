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
// TPU: one thread per output pixel reads the maps once, computes the weights
// and the clamped tap indices once, and gathers the taps of every channel
// through the read-only cache. Lanczos4 weights are the exact ones of
// resample.py: t = frac - (k - 3), sinf(pi t) / (pi t) * sinf(pi t / 4) /
// (pi t / 4) with pi t rounded to float first, 1 where |t| < 1e-7, 0 where
// |t| >= 4, normalised by their sum taken in ascending tap order; the taps
// accumulate rows outer, taps inner, each sum seeded with zero. Every
// operation is the plain version's, in its order, with FMA contraction off
// (-fmad=false) and IEEE division.
//
// What bounds it on an H100: device memory for bilinear (8 B of maps and 2 x 4
// B per channel of image and output per pixel against about 10 operations per
// channel); for Lanczos4, 32 sinf per pixel (one set of weights per map)
// against the same bytes, near the line between the two.
//
// Layout: element (c, y, x) of img and out sits at
// c * img_plane + (y * W + x) * pix_stride, so (H, W), (C, H, W) and
// (H, W, C) launch as they lie; map element (c, y, x) sits at
// c * map_plane + y * W + x, with map_plane 0 for maps shared by the channels.
namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__device__ __forceinline__ int clip_range(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 8 Lanczos (a = 4) weights of taps -3..4 around floor(coord).
__device__ __forceinline__ void lanczos4_weights(float frac, float* w) {
  for (int k = 0; k < 8; ++k) {
    const float t = frac - (float)(k - 3);
    const float pit = kPi * t;
    const bool small = fabsf(t) < 1e-7f;
    const float safe = small ? 1.0f : pit;
    const float sinc = small ? 1.0f : sinf(safe) / safe;
    const float safe4 = small ? 1.0f : pit / 4.0f;
    const float sinc4 = small ? 1.0f : sinf(safe4) / safe4;
    w[k] = fabsf(t) < 4.0f ? sinc * sinc4 : 0.0f;
  }
  float total = w[0];
  for (int k = 1; k < 8; ++k) total = total + w[k];
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

template <bool kLanczos>
__global__ void __launch_bounds__(kThreads)
remap_kernel(const float* __restrict__ img, const float* __restrict__ map_x,
             const float* __restrict__ map_y, float* __restrict__ out, int H,
             int W, int C, long long img_plane, int pix_stride,
             long long map_plane, int bounded, int dy0, int dy1, int dx0,
             int dx1) {
  for (int i = threadIdx.x; i < kTileX * kTileY; i += blockDim.x) {
    const int y = blockIdx.y * kTileY + i / kTileX;
    const int x = blockIdx.x * kTileX + i % kTileX;
    if (y >= H || x >= W) continue;
    const size_t p = (size_t)y * W + x;
    int rows[8], cols[8];
    float wy[8], wx[8];
    for (int c = 0; c < C; ++c) {
      if (c == 0 || map_plane != 0) {
        const size_t m = (size_t)c * (size_t)map_plane + p;
        const Sample s = sample_at(map_x[m], map_y[m], y, x, bounded, dy0,
                                   dy1, dx0, dx1);
        if (kLanczos) {
          lanczos4_weights(s.fx, wx);
          lanczos4_weights(s.fy, wy);
          for (int k = 0; k < 8; ++k) {
            rows[k] = clamp_index(s.by + k - 3, H);
            cols[k] = clamp_index(s.bx + k - 3, W);
          }
        } else {
          wx[0] = s.fx;
          wy[0] = s.fy;
          rows[0] = clamp_index(s.by, H);
          rows[1] = clamp_index(s.by + 1, H);
          cols[0] = clamp_index(s.bx, W);
          cols[1] = clamp_index(s.bx + 1, W);
        }
      }
      const float* const plane = img + (size_t)c * (size_t)img_plane;
      float v;
      if (kLanczos) {
        v = 0.0f;
        for (int j = 0; j < 8; ++j) {
          const float* const row = plane + (size_t)rows[j] * W * pix_stride;
          float acc = 0.0f;
          for (int k = 0; k < 8; ++k)
            acc = acc + wx[k] * __ldg(row + (size_t)cols[k] * pix_stride);
          v = v + wy[j] * acc;
        }
      } else {
        const float* const r0 = plane + (size_t)rows[0] * W * pix_stride;
        const float* const r1 = plane + (size_t)rows[1] * W * pix_stride;
        const float i00 = __ldg(r0 + (size_t)cols[0] * pix_stride);
        const float i01 = __ldg(r0 + (size_t)cols[1] * pix_stride);
        const float i10 = __ldg(r1 + (size_t)cols[0] * pix_stride);
        const float i11 = __ldg(r1 + (size_t)cols[1] * pix_stride);
        const float fx = wx[0], fy = wy[0];
        const float top = i00 * (1.0f - fx) + i01 * fx;
        const float bot = i10 * (1.0f - fx) + i11 * fx;
        v = top * (1.0f - fy) + bot * fy;
      }
      out[(size_t)c * (size_t)img_plane + p * pix_stride] = v;
    }
  }
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
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 1)
    remap_kernel<true><<<grid, kThreads, 0, s>>>(
        img, map_x, map_y, out, H, W, C, img_plane, pix_stride, map_plane,
        bounded, dy0, dy1, dx0, dx1);
  else if (kind == 0)
    remap_kernel<false><<<grid, kThreads, 0, s>>>(
        img, map_x, map_y, out, H, W, C, img_plane, pix_stride, map_plane,
        bounded, dy0, dy1, dx0, dx1);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
#endif
