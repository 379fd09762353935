// Check-node update and message storage of the lifted 5G LDPC decoders,
// shared by the flooding kernel (ldpc_lifted_bp.cu) and the layered
// kernel (ldpc_layered_bp.cu).
//
// It computes, for one lane of one base row, what `_lifted_cn_phase` in
// sionna_tpu_torch/phy/fec/ldpc/decoding.py computes, operation by
// operation and in the same order: tanhf/log1pf/logf without fast math
// are the functions torch's CUDA tanh/log1p/log call, the ratio form's
// division is IEEE (no __fdividef), and no expression has the a * b + c
// shape that nvcc would contract into an FMA, so the kernels agree bit
// for bit with the plain version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sionna_ldpc {

constexpr int kMaxDegree = 32;  // largest base row / column degree

// Boxplus magnitude 2 atanh(x): log1p(x) - log1p(-x), or the Pallas
// kernel's "ratio" form log((1 + x) / (1 - x)).
constexpr int kLog1p = 0;
constexpr int kRatio = 1;

__device__ __forceinline__ float clampf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

__device__ __forceinline__ float signf(float x) {
  return x < 0.f ? -1.f : 1.f;
}

// Message state in device memory: f32, or bf16 rounded to nearest even
// on every store and widened to f32 on every load (torch's
// .to(torch.bfloat16) rounds the same way). All arithmetic is f32.
__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Reads the row's messages through v2c(k) and the edges' activity masks
// (0 or 1) through mask(k), for 1 <= d <= kMaxDegree, and hands
// c2v_k = sign_tot * sign_k * min(ext_k, clip) * mask(k) to out(k, c2v_k),
// where ext_k is the extrinsic magnitude: mode 0 boxplus (tanh rule with
// prefix and suffix products, clamped at 1 - 1e-7, magnitude in the form
// kForm), mode 1 (offset) min-sum. Every v2c(k) is read before the first
// out(k, .). The accessors let each kernel read and write its own layout
// in place, so the function adds no local arrays beyond its own three.
template <int kForm, class V2c, class Mask, class Out>
__device__ __forceinline__ void cn_update(V2c v2c, Mask mask, Out out,
                                          int d, float clip, float offset,
                                          int mode) {
  float val[kMaxDegree];  // tanh(|m|/2) (boxplus) or |m| (min-sum)
  float sgn[kMaxDegree];
  float sign_tot = 1.f;
  for (int k = 0; k < d; ++k) {
    const float m = v2c(k);
    float v = mode == 0 ? tanhf(fabsf(m) / 2.f) : fabsf(m);
    float s = signf(m);
    if (!(mask(k) > 0.f)) {
      v = mode == 0 ? 1.f : 1e30f;
      s = 1.f;
    }
    val[k] = v;
    sgn[k] = s;
    sign_tot = k == 0 ? s : sign_tot * s;
  }
  if (mode == 0) {
    const float hi = (float)(1.0 - 1e-7);
    // backward products bwd[k] = t[k] * ... * t[d-1], accumulated from
    // the end as ((t[d-1] * t[d-2]) * t[d-3]) ...
    float bwd[kMaxDegree];
    bwd[d - 1] = val[d - 1];
    for (int k = d - 2; k >= 0; --k) bwd[k] = bwd[k + 1] * val[k];
    float fwd = 1.f;  // fwd[k-1] = t[0] * ... * t[k-1]
    for (int k = 0; k < d; ++k) {
      float ext;
      if (d == 1) {
        ext = hi;
      } else if (k == 0) {
        ext = fminf(bwd[1], hi);
      } else if (k == d - 1) {
        ext = fminf(fwd, hi);
      } else {
        ext = fminf(fwd * bwd[k + 1], hi);
      }
      fwd = k == 0 ? val[0] : fwd * val[k];
      float mag;
      if constexpr (kForm == kRatio) {
        mag = logf((1.f + ext) / (1.f - ext));
      } else {
        mag = log1pf(ext) - log1pf(-ext);
      }
      out(k, sign_tot * sgn[k] * fminf(mag, clip) * mask(k));
    }
  } else {
    float min1 = val[0];
    for (int k = 1; k < d; ++k) min1 = fminf(min1, val[k]);
    float min2 = 1e30f;
    int n_min = 0;
    for (int k = 0; k < d; ++k) {
      min2 = fminf(min2, val[k] > min1 ? val[k] : 1e30f);
      n_min += val[k] == min1;
    }
    for (int k = 0; k < d; ++k) {
      float ext = (val[k] == min1 && n_min == 1) ? min2 : min1;
      if (offset > 0.f) ext = fmaxf(ext - offset, 0.f);
      out(k, sign_tot * sgn[k] * fminf(ext, clip) * mask(k));
    }
  }
}

}  // namespace sionna_ldpc
