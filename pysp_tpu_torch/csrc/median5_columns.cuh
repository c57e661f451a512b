// The shared-column form of the 5x5 median for a strip of neighbouring windows:
// device code shared by ahd.cu (the chroma-median stages inside the AHD kernel)
// and postprocess.cu (one such stage on planes), which call median5_strip<4> on
// a 5x8 window they hold in registers, and median5.cu (the median of a plane),
// which calls median5_strip<8> on a 5x12 window.
//
// The networks of pysp_tpu_torch/ops/stencil.py::median5_from_padded, which the
// plain version runs on whole planes: every column of five is sorted once
// (sort5, 9 compare-exchanges) and serves the five windows that hold it; two
// neighbouring sorted columns merge into a sorted ten (merge5x5, Batcher's
// odd-even merge, 13 compare-exchanges) that serves three windows; two tens
// merge, pruned to the ranks 7..12 of the twenty that can still be the median
// of 25 (merge10x10_mid), and the fifth column enters by the selection
// identity rank_k(A u B) = max_i min(A[i], B[k - i]) (median_of_20_and_5). For
// a strip of four windows that is 484 min/max, 121 a median, and for a strip
// of eight 844, 105.5 a median, where a pruned Batcher network for one window
// of 25 takes 202. That count is what bounds the callers on an H100: min and
// max run at half the rate of an add there. A median is a selection, so the
// result is bit-identical to every other correct network's.
#pragma once

#define MED5_CMP(i, j)                 \
  {                                    \
    const float a_ = w[i], b_ = w[j];  \
    w[i] = fminf(a_, b_);              \
    w[j] = fmaxf(a_, b_);              \
  }
#define MED5_MIN(i, j) w[i] = fminf(w[i], w[j])
#define MED5_MAX(i, j) w[j] = fmaxf(w[i], w[j])

// Sorts w[0..4] ascending in place.
__device__ __forceinline__ void sort5(float* w) {
  MED5_CMP(0, 1);
  MED5_CMP(3, 4);
  MED5_CMP(2, 4);
  MED5_CMP(2, 3);
  MED5_CMP(0, 3);
  MED5_CMP(0, 2);
  MED5_CMP(1, 4);
  MED5_CMP(1, 3);
  MED5_CMP(1, 2);
}

// out[0..9]: the sorted merge of the sorted fives a and b.
__device__ __forceinline__ void merge5x5(const float* a, const float* b, float* out) {
  float w[10];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    w[k] = a[k];
    w[5 + k] = b[k];
  }
  MED5_CMP(0, 5);
  MED5_CMP(4, 9);
  MED5_CMP(4, 5);
  MED5_CMP(2, 7);
  MED5_CMP(2, 4);
  MED5_CMP(7, 5);
  MED5_CMP(1, 6);
  MED5_CMP(3, 8);
  MED5_CMP(3, 6);
  MED5_CMP(1, 2);
  MED5_CMP(3, 4);
  MED5_CMP(6, 7);
  MED5_CMP(8, 5);
  out[0] = w[0];
  out[1] = w[1];
  out[2] = w[2];
  out[3] = w[3];
  out[4] = w[4];
  out[5] = w[6];
  out[6] = w[7];
  out[7] = w[8];
  out[8] = w[5];
  out[9] = w[9];
}

// q[0..5]: the ranks 7..12 of the merge of the sorted tens a and b.
__device__ __forceinline__ void merge10x10_mid(const float* a, const float* b, float* q) {
  float w[20];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    w[k] = a[k];
    w[10 + k] = b[k];
  }
  MED5_MAX(0, 10);
  MED5_MIN(8, 18);
  MED5_CMP(8, 10);
  MED5_CMP(4, 14);
  MED5_MAX(4, 8);
  MED5_MIN(14, 10);
  MED5_MAX(2, 12);
  MED5_MIN(6, 16);
  MED5_CMP(6, 12);
  MED5_MAX(6, 8);
  MED5_CMP(12, 14);
  MED5_MAX(1, 11);
  MED5_MIN(9, 19);
  MED5_CMP(9, 11);
  MED5_CMP(5, 15);
  MED5_MAX(5, 9);
  MED5_MIN(15, 11);
  MED5_MAX(3, 13);
  MED5_MIN(7, 17);
  MED5_CMP(7, 13);
  MED5_CMP(7, 9);
  MED5_MIN(13, 15);
  MED5_CMP(7, 8);
  MED5_CMP(9, 12);
  MED5_CMP(13, 14);
  q[0] = w[7];
  q[1] = w[8];
  q[2] = w[9];
  q[3] = w[12];
  q[4] = w[13];
  q[5] = w[14];
}

// The median of 25 from q, the ranks 7..12 of twenty of the values, and the
// sorted five others.
__device__ __forceinline__ float median_of_20_and_5(const float* q, const float* side) {
  float t = q[0];
#pragma unroll
  for (int k = 0; k < 5; ++k) t = fmaxf(t, fminf(q[1 + k], side[4 - k]));
  return t;
}

// med[j], j = 0..N-1: the median of the 5x5 window whose columns are
// col[j .. j + 4] of the 5x(N + 4) window col[column][row]. The N windows
// share the N + 4 sorted columns and the N + 2 sorted column pairs. Sorts the
// columns in place.
template <int N>
__device__ __forceinline__ void median5_strip(float (*col)[5], float* med) {
  float pair[N + 2][10];
#pragma unroll
  for (int c = 0; c < N + 4; ++c) sort5(col[c]);
#pragma unroll
  for (int c = 0; c < N + 2; ++c) merge5x5(col[c], col[c + 1], pair[c]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float q[6];
    merge10x10_mid(pair[j], pair[j + 2], q);
    med[j] = median_of_20_and_5(q, col[j + 4]);
  }
}

#undef MED5_CMP
#undef MED5_MIN
#undef MED5_MAX
