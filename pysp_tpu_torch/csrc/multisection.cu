// Hot-pixel detector: one pass of the per-plane count multisection of
// correct/bad_pixels.py::_bisect_quantile over (P, H, W) float32 delta planes,
// and with `narrow` the narrowing of the bracket after it, in one launch.
//
//   mid_b = lo + (hi - lo) * fr_b,  fr_b = (b + 1) / (B + 1),  b < B
//   cnt_b = #{x of the plane : x <= mid_b}
//   ok_b  = float(cnt_b) - 1 >= target
//   hi'   = min over b of (ok_b ? mid_b : hi),  lo' = max over b of (ok_b ? lo : mid_b)
//
// Replaces no TPU kernel: the JAX package counts with an XLA broadcast
// compare, and so did the port, as a (P, B, H, W) boolean tensor widened to
// int64 before its sum (3.4 GB moved a pass at 24 MP). Plain version beside
// it: correct/bad_pixels.py::multisection_plain (ops/cuda_kernels.py).
//
// What bounds it on an H100: device memory. A pass reads each sample once
// (4 B) and keeps B counters; a 24 MP frame's four 2000x3000 planes are 96 MB,
// 0.029 ms at 3.35 TB/s. A block walks a grid-strided share of one plane with
// 16-byte loads, two in flight a thread (four spill at the 64-register cap of
// four blocks an SM, and ran 12% slower). The mids rise with b (rounding is
// monotone and hi - lo >= 0) or are all NaN, so a sample at or below mid_0
// counts for every branch and one not at or below mid_{B-1} for none: two
// compares decide most samples, and only those inside the bracket take all B.
// Each thread keeps one counter per branch for its plane; a warp sums them
// with one redux each, the block through shared memory, and one atomicAdd per
// (plane, branch) adds the block's count into an int32 buffer (exact below
// 2^31 samples a plane).
//
// The narrowing: with `narrow`, the last block to finish (a ticket taken
// after __threadfence) reads every plane's counts and writes the new bracket
// in place, so the passes of a frame are back-to-back launches with lo and hi
// on the card and no host synchronisation. Without it (the shards of a row-
// sharded frame, whose counts the caller sums first) the kernel only counts.
//
// Exactness: the comparisons are `<=` as in the plain version (a NaN sample
// counts nowhere), and the mids and the count's float32 rounding are the
// plain version's operations in its order, each rounded (__fsub_rn,
// __fmul_rn, __fadd_rn, __int2float_rn; fr by __fdiv_rn, as div_const
// divides). fminf / fmaxf stand for torch.amin / amax, which differ only
// where a NaN meets a number: here the mids are all NaN or none, and with NaN
// mids no count reaches a rank, so every candidate for hi is hi and every one
// for lo a NaN. So the bracket is the plain version's bit for bit.
//
// Layout: delta holds P planes of n contiguous samples, plane p at
// delta + p * plane_stride (a row slice of a (P, H, W) tensor is read in
// place); bracket is float32 (2, P), lo then hi, with lo <= hi or NaN (amin
// and amax give that, and each narrowing keeps it); counts is int32 (P, B),
// zeroed by the caller, and ticket one int32, zeroed, for each launch.
#include "tile_loops.cuh"

// The blocks an SM that the register cap and the grid are set for, and the
// 16-byte loads in flight a thread; tools/time_kernels.py builds other values
// beside these through the macros, to compare them on one card in one call.
#ifndef MS_MIN_BLOCKS
#define MS_MIN_BLOCKS 4
#endif
#ifndef MS_LOADS
#define MS_LOADS 2
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = MS_MIN_BLOCKS;
constexpr int kMaxBranches = 16;
constexpr int kLoads = MS_LOADS;

__device__ __forceinline__ float mid_at(float lo, float span, int b, int branches) {
  const float fr = __fdiv_rn((float)(b + 1), (float)(branches + 1));
  return __fadd_rn(lo, __fmul_rn(span, fr));
}

// Counts x for every branch: counts_b = below + c[b]. The mids rise with b,
// so x <= mid[0] holds for every b and !(x <= top) for none.
__device__ __forceinline__ void count_one(float x, const float (&mid)[kMaxBranches], float top,
                                          int& below, int (&c)[kMaxBranches]) {
  if (x <= mid[0]) {
    ++below;
    return;
  }
  if (!(x <= top)) return;
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) c[b] += x <= mid[b];
}

// The block's share of the n samples at x: a scalar head up to the first
// 16-byte boundary and the scalar tail (block 0), the 16-byte body grid-strided.
__device__ __forceinline__ void count_plane(const float* __restrict__ x, int n,
                                            const float (&mid)[kMaxBranches], float top,
                                            int& below, int (&c)[kMaxBranches]) {
  const int to_boundary = (int)((16 - ((size_t)x & 15)) & 15) / 4;
  const int head = to_boundary < n ? to_boundary : n;
  const int n4 = (n - head) / 4;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < head; i += blockDim.x)
      count_one(x[i], mid, top, below, c);
    for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
      count_one(x[i], mid, top, below, c);
  }
  const Vec4* __restrict__ body = reinterpret_cast<const Vec4*>(x + head);
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += kLoads * step) {
    Vec4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (i + k * step < n4) v[k] = body[i + k * step];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (i + k * step < n4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) count_one(v[k].v[j], mid, top, below, c);
      }
    }
  }
}

// The new bracket of plane q from its counts (the last block, one thread).
__device__ __forceinline__ void narrow_plane(float* __restrict__ bracket,
                                             const int* __restrict__ counts, int P, int q,
                                             int branches, float target) {
  const float lo = bracket[q], hi = bracket[P + q];
  const float span = __fsub_rn(hi, lo);
  float new_lo = lo, new_hi = hi;
  for (int b = 0; b < branches; ++b) {
    const float mid = mid_at(lo, span, b, branches);
    const int cnt = __ldcg(counts + q * branches + b);
    const bool ok = __fsub_rn(__int2float_rn(cnt), 1.0f) >= target;
    const float h = ok ? mid : hi, l = ok ? lo : mid;
    new_hi = b == 0 ? h : fminf(new_hi, h);
    new_lo = b == 0 ? l : fmaxf(new_lo, l);
  }
  bracket[q] = new_lo;
  bracket[P + q] = new_hi;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
multisection_kernel(const float* __restrict__ delta, int P, int n, long long plane_stride,
                    float* __restrict__ bracket, int* __restrict__ counts,
                    int* __restrict__ ticket, int branches, float target, int narrow) {
  __shared__ int s_part[kThreads / 32][kMaxBranches];
  __shared__ int s_last;
  const int p = blockIdx.y;
  const float lo = bracket[p], hi = bracket[P + p];
  const float span = __fsub_rn(hi, lo);
  const float top = mid_at(lo, span, branches - 1, branches);
  float mid[kMaxBranches];
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) mid[b] = mid_at(lo, span, b, branches);  // b >= B: never added

  int below = 0, c[kMaxBranches];
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) c[b] = 0;
  count_plane(delta + (long long)p * plane_stride, n, mid, top, below, c);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kMaxBranches; ++b) {
    const int sum = __reduce_add_sync(0xffffffffu, below + c[b]);
    if (lane == 0) s_part[warp][b] = sum;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < branches; b += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) sum += s_part[w][b];
    atomicAdd(counts + p * branches + b, sum);
  }
  if (!narrow) return;

  // The last block to finish narrows every plane's bracket.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = threadIdx.x; q < P; q += blockDim.x)
    narrow_plane(bracket, counts, P, q, branches, target);
}

}  // namespace

#ifdef __CUDACC__
// Launches one pass on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int pysp_multisection(const float* delta, int P, int n, long long plane_stride,
                                 float* bracket, int* counts, int* ticket, int branches,
                                 float target, int narrow, void* stream) {
  if (P < 1 || P > 65535 || n < 1 || branches < 1 || branches > kMaxBranches)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // A full card of blocks over the planes, fewer where a plane is small.
  const long long per_block = (long long)kThreads * kLoads * 4;
  long long blocks = (n + per_block - 1) / per_block;
  const long long fill = (long long)sms * kMinBlocks / P;
  blocks = blocks < fill ? blocks : fill;
  const dim3 grid((unsigned)(blocks > 0 ? blocks : 1), (unsigned)P);
  multisection_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      delta, P, n, plane_stride, bracket, counts, ticket, branches, target, narrow);
  return (int)cudaGetLastError();
}
#endif
