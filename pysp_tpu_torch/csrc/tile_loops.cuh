// How a block's threads share the cells of a tile region, the 16-byte vector
// of four floats, the clamp of an index into a plane (the replicate border),
// and the launchers' row alignment test and shared memory limit, for ahd.cu,
// rl.cu, postprocess.cu, heal.cu, decision.cu, median5.cu, homogeneity.cu and
// remap.cu (which takes only the clamp).
#pragma once

namespace {

// Four floats that load and store as one 16-byte access.
struct alignas(16) Vec4 {
  float v[4];
};

// Clamps an index into [0, n): the replicate border, and the symmetric border
// of a reach of one.
__device__ __forceinline__ int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// Calls f(row, col) for every cell of rows [0, rows) x cols [0, cols). The
// cells are dealt to the block's threads in row-major order (thread t takes
// cells t, t + blockDim.x, ...), so a warp's lanes stay on neighbouring
// addresses whatever the region's width, and the 2-D position advances by
// additions: one division per call, none per cell.
template <class F>
__device__ __forceinline__ void for_cells(int rows, int cols, F f) {
  const int step = blockDim.x;
  const int dr = step / cols, dc = step % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// for_cells for a region that is read from device memory: a thread first
// issues N loads, value = load(row, col), and only then hands the values on,
// store(row, col, value), so that N loads are in flight for each thread and
// not one (the memory system needs tens of KB in flight on every SM). The
// value is whatever load returns: a float, a Vec4, a struct of several.
template <int N, class L, class S>
__device__ __forceinline__ void for_cells_loading(int rows, int cols, L load, S store) {
  const int step = blockDim.x;
  const int dr = step / cols, dc = step % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    decltype(load(0, 0)) v[N];
    int rr[N], cc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      rr[k] = r;
      cc[k] = c;
      if (r < rows) v[k] = load(r, c);
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (rr[k] < rows) store(rr[k], cc[k], v[k]);
    }
  }
}

// Whether rows of W floats behind these plane pointers start on 16-byte
// boundaries, so that a tile's rows load and store as Vec4.
inline bool rows_aligned(int W, const void* const* planes, int n) {
  unsigned long long bits = (unsigned long long)W % 4;
  for (int k = 0; k < n; ++k) bits |= (unsigned long long)planes[k] % 16;
  return bits == 0;
}

#ifdef __CUDACC__
// Raises the kernel's dynamic shared memory limit where it passes the
// default 48 KB, once for each device (*ready_device starts at -1).
template <class Kernel>
cudaError_t allow_shared_memory(Kernel kernel, int bytes, int* ready_device) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == *ready_device) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *ready_device = device;
  return err;
}
#endif

}  // namespace
