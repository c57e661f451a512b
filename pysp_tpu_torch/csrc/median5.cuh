// 5x5 median of one window, device code for median5.cu (ahd.cu and
// postprocess.cu take strips of four windows, median5_columns.cuh).
//
// Replaces the median networks inside the TPU kernels' shared
// pysp_tpu/ops/pallas_kernels.py::_median5_field. The body of median25 is the
// pruned Batcher odd-even mergesort network that
// pysp_tpu/ops/stencil.py::_median_network(25) builds (:157-241), one line per
// operation: 89 compare-exchanges plus 12 lone minima and 12 lone maxima, 202
// min/max in all. tests/test_torch_stencil.py parses this file and checks it
// against that network. A median is a selection, so
// the result is bit-identical to every other correct median network, including
// the shared-column form that ops/stencil.py::median5 uses.
#pragma once

#define MED5_CMP(i, j)                 \
  {                                    \
    const float a_ = w[i], b_ = w[j];  \
    w[i] = fminf(a_, b_);              \
    w[j] = fmaxf(a_, b_);              \
  }
#define MED5_MIN(i, j) w[i] = fminf(w[i], w[j])
#define MED5_MAX(i, j) w[j] = fmaxf(w[i], w[j])

// Median (rank 12 of 25) of w[0..24]. w is scratch: the network reorders it.
__device__ __forceinline__ float median25(float* w) {
  MED5_CMP(0, 1);
  MED5_CMP(2, 3);
  MED5_CMP(0, 2);
  MED5_CMP(1, 3);
  MED5_CMP(1, 2);
  MED5_CMP(4, 5);
  MED5_CMP(6, 7);
  MED5_CMP(4, 6);
  MED5_CMP(5, 7);
  MED5_CMP(5, 6);
  MED5_CMP(0, 4);
  MED5_CMP(2, 6);
  MED5_CMP(2, 4);
  MED5_CMP(1, 5);
  MED5_CMP(3, 7);
  MED5_CMP(3, 5);
  MED5_CMP(1, 2);
  MED5_CMP(3, 4);
  MED5_CMP(5, 6);
  MED5_CMP(8, 9);
  MED5_CMP(10, 11);
  MED5_CMP(8, 10);
  MED5_CMP(9, 11);
  MED5_CMP(9, 10);
  MED5_CMP(12, 13);
  MED5_CMP(14, 15);
  MED5_CMP(12, 14);
  MED5_CMP(13, 15);
  MED5_CMP(13, 14);
  MED5_CMP(8, 12);
  MED5_CMP(10, 14);
  MED5_CMP(10, 12);
  MED5_CMP(9, 13);
  MED5_CMP(11, 15);
  MED5_CMP(11, 13);
  MED5_CMP(9, 10);
  MED5_CMP(11, 12);
  MED5_CMP(13, 14);
  MED5_CMP(0, 8);
  MED5_CMP(4, 12);
  MED5_CMP(4, 8);
  MED5_CMP(2, 10);
  MED5_CMP(6, 14);
  MED5_CMP(6, 10);
  MED5_CMP(2, 4);
  MED5_CMP(6, 8);
  MED5_CMP(10, 12);
  MED5_CMP(1, 9);
  MED5_CMP(5, 13);
  MED5_CMP(5, 9);
  MED5_CMP(3, 11);
  MED5_MIN(7, 15);
  MED5_CMP(7, 11);
  MED5_CMP(3, 5);
  MED5_CMP(7, 9);
  MED5_CMP(11, 13);
  MED5_CMP(1, 2);
  MED5_CMP(3, 4);
  MED5_CMP(5, 6);
  MED5_CMP(7, 8);
  MED5_CMP(9, 10);
  MED5_CMP(11, 12);
  MED5_MIN(13, 14);
  MED5_CMP(16, 17);
  MED5_CMP(18, 19);
  MED5_CMP(16, 18);
  MED5_CMP(17, 19);
  MED5_CMP(17, 18);
  MED5_CMP(20, 21);
  MED5_CMP(22, 23);
  MED5_CMP(20, 22);
  MED5_CMP(21, 23);
  MED5_CMP(21, 22);
  MED5_CMP(16, 20);
  MED5_CMP(18, 22);
  MED5_CMP(18, 20);
  MED5_CMP(17, 21);
  MED5_CMP(19, 23);
  MED5_CMP(19, 21);
  MED5_CMP(17, 18);
  MED5_CMP(19, 20);
  MED5_CMP(21, 22);
  MED5_CMP(16, 24);
  MED5_CMP(20, 24);
  MED5_CMP(18, 20);
  MED5_CMP(22, 24);
  MED5_CMP(19, 21);
  MED5_CMP(17, 18);
  MED5_CMP(19, 20);
  MED5_CMP(21, 22);
  MED5_CMP(23, 24);
  MED5_MAX(0, 16);
  MED5_MIN(8, 24);
  MED5_MAX(8, 16);
  MED5_MAX(4, 20);
  MED5_MIN(12, 20);
  MED5_MIN(12, 16);
  MED5_MAX(2, 18);
  MED5_MIN(10, 18);
  MED5_MIN(6, 22);
  MED5_MAX(6, 10);
  MED5_MAX(10, 12);
  MED5_MAX(1, 17);
  MED5_MAX(9, 17);
  MED5_MAX(5, 21);
  MED5_MIN(13, 21);
  MED5_MIN(13, 17);
  MED5_MAX(3, 19);
  MED5_MIN(11, 19);
  MED5_MIN(7, 23);
  MED5_MAX(7, 11);
  MED5_MIN(11, 13);
  MED5_MAX(11, 12);
  return w[12];
}

#undef MED5_CMP
#undef MED5_MIN
#undef MED5_MAX
