// Check-node forward and reverse of the lifted 5G LDPC decoders' backward
// kernels (ldpc_lifted_bp_grad.cu: K5b; ldpc_layered_bp_grad.cu: K5Lb;
// their tape kernels K5f and K5Lf run K1's and K3's own code).
//
// cn_forward computes one check-node unit (one lane of one base row) as
// the forward kernels K1 and K3 do, from ldpc_cn.cuh's cn_extrinsic and in
// the same order of operations, so the backward kernels recompute the
// c2v that the decode computed, bit for bit.
//
// cn_adjoint is the reverse of that unit: the gradient with respect to the
// unit's v2c inputs from the gradient of its c2v outputs, what
// `_row_adjoint` in sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py computes.
// It takes the JAX package's derivatives where the check node is not
// smooth (those of XLA's autodiff of `_lifted_cn_phase`): jnp.minimum
// passes 1/2 of the gradient to each side of a tie, so min-sum's min1 and
// min2 chains split ties as the chains do; jnp.abs passes +1 at 0; the
// sign, the activity selects and the tie counts pass nothing. The boxplus
// reverse of the prefix/suffix products is the closed form
//   d/dt[j] = bwd[j+1] A[j] + fwd[j-1] C[j],
//   A[j+1] = A[j] t[j] + gP[j] fwd[j-1],  C[j-1] = C[j] t[j] + gP[j] bwd[j+1]
// of the reverse sweep over the two product chains (gP[k]: the gradient of
// edge k's extrinsic product); it sums in another order than the plain
// version, so the two agree to rounding, not bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ldpc_cn.cuh"

namespace sionna_ldpc {

// Calls f(std::integral_constant<int, D>()) for the runtime row degree d
// of SIONNA_CN_DEGREES (ldpc_cn.cuh); nothing for another degree (the host
// refuses a code with one).
template <class F>
__device__ __forceinline__ void with_degree(int d, F&& f) {
  switch (d) {
#define SIONNA_CN_GRAD_CASE(D)         \
  case D:                              \
    f(std::integral_constant<int, D>()); \
    break;
    SIONNA_CN_DEGREES(SIONNA_CN_GRAD_CASE)
#undef SIONNA_CN_GRAD_CASE
    default:
      break;
  }
}

// JAX's derivatives as factors: d minimum(x, y) / dx; d clip(x, -c, c) /
// dx (clip = minimum(c, maximum(-c, x))); d maximum(x, 0) / dx; d abs(x)
// / dx; and the tie share of x in minimum(x, y) = z.
__device__ __forceinline__ float d_min(float x, float y) {
  return x < y ? 1.f : (x == y ? 0.5f : 0.f);
}
__device__ __forceinline__ float d_clip(float x, float c) {
  const float a = fabsf(x);
  return a < c ? 1.f : (a == c ? 0.5f : 0.f);
}
__device__ __forceinline__ float d_max0(float x) {
  return x > 0.f ? 1.f : (x == 0.f ? 0.5f : 0.f);
}
__device__ __forceinline__ float d_abs(float x) { return x >= 0.f ? 1.f : -1.f; }
__device__ __forceinline__ float tie_share(float x, float z, float y) {
  return x == z ? (y == z ? 0.5f : 1.f) : 0.f;
}

// The c2v messages out[k] of a check-node unit of degree D from its v2c
// inputs m[k]; bit k of `act` marks edge k's lane active. mode 0: boxplus
// (log1p form), 1: (offset) min-sum. K1's cn_unit, through the same
// cn_edge_in, cn_extrinsic and cn_edge_out of ldpc_cn.cuh.
template <int D>
__device__ __forceinline__ void cn_forward(const float (&m)[D], unsigned act,
                                           float clip, float offset, int mode,
                                           float (&out)[D]) {
  float val[D];  // tanh(|m|/2) (boxplus) or |m| (min-sum)
  unsigned neg = 0;
  float sign_tot = 1.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    cn_edge_in<D>(k, m[k], (act >> k) & 1u, mode, val, neg, sign_tot);
  }
  cn_extrinsic<D, kLog1p>(val, mode, offset, [&](int k, float mag) {
    out[k] = cn_edge_out(k, mag, neg, act, sign_tot, clip);
  });
}

// The reverse of cn_forward: on entry g[k] is dL/d out[k], on return
// dL/d m[k].
template <int D>
__device__ __forceinline__ void cn_adjoint(const float (&m)[D], float (&g)[D],
                                           unsigned act, float clip,
                                           float offset, int mode) {
  unsigned neg = 0;
  float sign_tot = 1.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float s = (act >> k) & 1u ? signf(m[k]) : 1.f;
    if (s < 0.f) neg |= 1u << k;
    sign_tot = k == 0 ? s : sign_tot * s;
  }
  // dL/d(edge k's magnitude before the clip at `clip`)
#pragma unroll
  for (int k = 0; k < D; ++k) {
    g[k] = (act >> k) & 1u
               ? g[k] * sign_tot * ((neg >> k) & 1u ? -1.f : 1.f)
               : 0.f;
  }
  if (mode == 0) {
    if constexpr (D == 1) {  // the extrinsic is the constant 1 - 1e-7
      g[0] = 0.f;
    } else {
      const float hi = (float)(1.0 - 1e-7);
      float t[D], fwd[D], bwd[D], gp[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        t[k] = (act >> k) & 1u ? tanhf(fabsf(m[k]) / 2.f) : 1.f;
      }
      fwd[0] = t[0];
#pragma unroll
      for (int k = 1; k < D; ++k) fwd[k] = fwd[k - 1] * t[k];
      bwd[D - 1] = t[D - 1];
#pragma unroll
      for (int k = D - 2; k >= 0; --k) bwd[k] = bwd[k + 1] * t[k];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float prod = k == 0       ? bwd[1]
                           : k == D - 1 ? fwd[D - 2]
                                        : fwd[k > 0 ? k - 1 : 0] *
                                              bwd[k + 1 < D ? k + 1 : k];
        const float ext = fminf(prod, hi);
        const float mag = log1pf(ext) - log1pf(-ext);
        const float gmag = g[k] * d_min(mag, clip);
        gp[k] = (gmag / (1.f + ext) + gmag / (1.f - ext)) * d_min(prod, hi);
      }
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        g[j] = (j + 1 < D ? bwd[j + 1 < D ? j + 1 : j] : 1.f) * a;
        a = a * t[j] + gp[j] * (j > 0 ? fwd[j > 0 ? j - 1 : 0] : 1.f);
      }
      float c = 0.f;
#pragma unroll
      for (int j = D - 1; j >= 0; --j) {
        g[j] = g[j] + (j > 0 ? fwd[j > 0 ? j - 1 : 0] : 1.f) * c;
        c = c * t[j] + gp[j] * (j + 1 < D ? bwd[j + 1 < D ? j + 1 : j] : 1.f);
      }
      // t = tanh(|m| / 2): dt/dm = (1 + t)(1 - t) / 2 * d|m|/dm
#pragma unroll
      for (int k = 0; k < D; ++k) {
        g[k] = (act >> k) & 1u
                   ? g[k] * (1.f + t[k]) * (1.f - t[k]) * 0.5f * d_abs(m[k])
                   : 0.f;
      }
    }
  } else {
    float a[D], mins1[D], mins2[D];
#pragma unroll
    for (int k = 0; k < D; ++k) a[k] = (act >> k) & 1u ? fabsf(m[k]) : 1e30f;
    mins1[0] = a[0];
#pragma unroll
    for (int k = 1; k < D; ++k) mins1[k] = fminf(mins1[k - 1], a[k]);
    const float min1 = mins1[D - 1];
    float prev = 1e30f;
    int n_min = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      mins2[k] = fminf(prev, a[k] > min1 ? a[k] : 1e30f);
      prev = mins2[k];
      n_min += a[k] == min1;
    }
    const float min2 = mins2[D - 1];
    float g1 = 0.f, g2 = 0.f;  // dL/d min1, dL/d min2
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const bool unique = a[k] == min1 && n_min == 1;
      float ext = unique ? min2 : min1;
      float ge = g[k];
      if (offset > 0.f) {
        ge = ge * d_max0(ext - offset);
        ext = fmaxf(ext - offset, 0.f);
      }
      ge = ge * d_min(ext, clip);
      if (unique) {
        g2 = g2 + ge;
      } else {
        g1 = g1 + ge;
      }
      g[k] = 0.f;
    }
    // min2 = minimum(... minimum(1e30, w[0]) ..., w[D-1]), w[k] = a[k] if
    // a[k] > min1 else 1e30; then min1's chain, both reversed
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
      const float p = k > 0 ? mins2[k > 0 ? k - 1 : 0] : 1e30f;
      const float w = a[k] > min1 ? a[k] : 1e30f;
      if (a[k] > min1) g[k] = g2 * tie_share(w, mins2[k], p);
      g2 = g2 * tie_share(p, mins2[k], w);
    }
#pragma unroll
    for (int k = D - 1; k >= 1; --k) {
      g[k] = g[k] + g1 * tie_share(a[k], mins1[k], mins1[k - 1]);
      g1 = g1 * tie_share(mins1[k - 1], mins1[k], a[k]);
    }
    g[0] = g[0] + g1;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      g[k] = (act >> k) & 1u ? g[k] * d_abs(m[k]) : 0.f;
    }
  }
}

}  // namespace sionna_ldpc

// The message of a CUDA error code, for the host's wrapper; each kernel
// library is one translation unit and exports it once.
extern "C" const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
