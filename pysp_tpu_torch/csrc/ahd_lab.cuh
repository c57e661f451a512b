// AHD's colour and homogeneity device code, shared by ahd.cu, homogeneity.cu
// and decision.cu: the parameter block's layout, candidate (r, g, b) ->
// CIELAB, one direction's homogeneity count and the 3x3 box sum.
//
// Replaces the math shared by the TPU kernels' bodies in
// pysp_tpu/ops/pallas_kernels.py (_homogeneity_kernel, _ahd_decision_kernel,
// _ahd_mega_kernel). Every operation is the plain version's, in its order
// (pysp_tpu_torch/demosaic/ahd.py::_build_homogeneity_map and
// pysp_tpu_torch/demosaic/homogeneity.py::homogeneity_map_channels); only
// cbrtf and powf round differently from torch's.
//
// The count and the box sum read their fields through any types with
// `float at(int y, int x) const`, so each kernel keeps its own tile layout.
#pragma once

namespace {

// Float constants go through double exactly as Python's float -> float32 does.
#define F32(x) ((float)(x))

// Layout of the parameter block built by ops/cuda_kernels.py::_ahd_params.
enum {
  P_MAT = 0,    // cam -> lin-sRGB, 3x3 row-major
  P_WB = 9,     // reciprocal WB gains r, g, b
  P_H = 12,     // blended 5-tap green filter
  P_G3 = 17,    // 3x3 Gaussian, sigma 1
  P_KR = 26,    // phase kernels of the R plane: TL, TR, BL, BR, 3x3 each
  P_KB = 62,    // phase kernels of the B plane
  P_LABM = 98,  // cv2 RGB -> XYZ matrix, 3x3 row-major
  P_LABW = 107, // cv2 D65 white
  P_COUNT = 110
};

// kSkip: a real branch around the side that the select drops, so that a warp
// whose lanes all take one side issues no transcendental of the other. The
// value is the select's, bit for bit.
template <bool kSkip = false>
__device__ __forceinline__ float srgb_decode(float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  if (kSkip) {
    if (x <= F32(0.04045)) return x / F32(12.92);
    return powf(fmaxf((x + F32(0.055)) / F32(1.055), F32(1e-12)), F32(2.4));
  }
  const float base = fmaxf((x + F32(0.055)) / F32(1.055), F32(1e-12));
  const float p = powf(base, F32(2.4));
  return x <= F32(0.04045) ? x / F32(12.92) : p;
}

template <bool kSkip = false>
__device__ __forceinline__ float lab_f(float t) {
  if (kSkip) {
    if (t > F32(0.008856)) return cbrtf(fmaxf(t, F32(1e-12)));
    return F32(7.787) * t + F32(16.0 / 116.0);
  }
  return t > F32(0.008856) ? cbrtf(fmaxf(t, F32(1e-12)))
                           : F32(7.787) * t + F32(16.0 / 116.0);
}

// Candidate (r, g, b) -> CIELAB for the homogeneity test: WB a second time,
// cam -> lin-sRGB, then cv2's float RGB -> Lab (HDR: luma as L, tonemapped
// chroma). prm[i] is entry i of the parameter block: a pointer to it, or any
// type with a const operator[] (decision.cu keeps the entries in registers).
template <bool kSkip = false, class Params>
__device__ __forceinline__ void to_lab(float r, float g, float b, const Params& prm,
                                       int is_hdr, float& L, float& A, float& B) {
  const float rr = r * prm[P_WB], gg = g * prm[P_WB + 1], bb = b * prm[P_WB + 2];
  float ir = prm[P_MAT] * rr + prm[P_MAT + 1] * gg + prm[P_MAT + 2] * bb;
  float ig = prm[P_MAT + 3] * rr + prm[P_MAT + 4] * gg + prm[P_MAT + 5] * bb;
  float ib = prm[P_MAT + 6] * rr + prm[P_MAT + 7] * gg + prm[P_MAT + 8] * bb;
  float luma = 0.0f;
  if (is_hdr) {
    luma = F32(0.2126) * ir + F32(0.7152) * ig + F32(0.0722) * ib;
    ir = ir / (1.0f + ir);
    ig = ig / (1.0f + ig);
    ib = ib / (1.0f + ib);
  }
  const float dr = srgb_decode<kSkip>(ir), dg = srgb_decode<kSkip>(ig),
              db = srgb_decode<kSkip>(ib);
  const float tx = (prm[P_LABM] * dr + prm[P_LABM + 1] * dg + prm[P_LABM + 2] * db) /
                   prm[P_LABW];
  const float ty = (prm[P_LABM + 3] * dr + prm[P_LABM + 4] * dg + prm[P_LABM + 5] * db) /
                   prm[P_LABW + 1];
  const float tz = (prm[P_LABM + 6] * dr + prm[P_LABM + 7] * dg + prm[P_LABM + 8] * db) /
                   prm[P_LABW + 2];
  const float fx = lab_f<kSkip>(tx), fy = lab_f<kSkip>(ty), fz = lab_f<kSkip>(tz);
  L = ty > F32(0.008856) ? F32(116.0) * fy - F32(16.0) : F32(903.3) * ty;
  if (is_hdr) L = luma;
  A = F32(500.0) * (fx - fy);
  B = F32(200.0) * (fy - fz);
}

// Homogeneity count of one direction at (y, x): the centre and the two
// neighbours that set the adaptive bounds always pass (count starts at 3);
// one-sided luminance test, two-sided chroma test. A float count by default;
// decision.cu counts in ints (the same small integers).
template <class Count = float, class FieldL, class FieldA, class FieldB>
__device__ __forceinline__ Count homogeneity(const FieldL& L, const FieldA& A,
                                             const FieldB& B, int ly, int lx,
                                             bool vertical) {
  const float cl = L.at(ly, lx), ca = A.at(ly, lx), cb = B.at(ly, lx);
  const int y1 = vertical ? ly - 1 : ly, x1 = vertical ? lx : lx - 1;
  const int y2 = vertical ? ly + 1 : ly, x2 = vertical ? lx : lx + 1;
  const float eps_l =
      fmaxf(fabsf(cl - L.at(y1, x1)), fabsf(cl - L.at(y2, x2)));
  const float a1 = ca - A.at(y1, x1), b1 = cb - B.at(y1, x1);
  const float a2 = ca - A.at(y2, x2), b2 = cb - B.at(y2, x2);
  const float eps_c2 = fmaxf(a1 * a1 + b1 * b1, a2 * a2 + b2 * b2);
  Count count = 3;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dy = k / 3 - 1, dx = k % 3 - 1;
    if (dy == 0 && dx == 0) continue;
    if (vertical ? dx == 0 : dy == 0) continue;
    const float da = A.at(ly + dy, lx + dx) - ca;
    const float db = B.at(ly + dy, lx + dx) - cb;
    const bool ok = (L.at(ly + dy, lx + dx) - cl <= eps_l) &&
                    (da * da + db * db <= eps_c2);
    count = count + (ok ? Count(1) : Count(0));
  }
  return count;
}

template <class Field>
__device__ __forceinline__ float box_sum3(const Field& c, int ly, int lx) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc += c.at(ly + k / 3 - 1, lx + k % 3 - 1);
  return acc;
}

}  // namespace
