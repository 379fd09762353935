// Check-node update and message storage of the lifted 5G LDPC decoders,
// shared by the flooding kernel (ldpc_lifted_bp.cu) and the layered
// kernel (ldpc_layered_bp.cu), their gradients' kernels, and the launch
// of a decoder kernel per codeword (launch_per_codeword).
//
// It computes, for one lane of one base row, what `_lifted_cn_phase` in
// sionna_tpu_torch/phy/fec/ldpc/decoding.py computes, operation by
// operation and in the same order: tanhf/log1pf/logf without fast math
// are the functions torch's CUDA tanh/log1p/log call, the ratio form's
// division is IEEE (no __fdividef), and no expression has the a * b + c
// shape that nvcc would contract into an FMA, so the kernels agree bit
// for bit with the plain version.
//
// The row degree is a template parameter: one case per degree keeps
// every per-edge value at a compile-time index, in a register (a single
// copy unrolled over the largest degree and guarded by the runtime one
// put them in a stack frame and ran 1.8x slower in the flooding kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sionna_ldpc {

// The row degrees a kernel has a check-node case for: those of the 5G
// base graphs' rows (3-10 and 19), and 1-2; CN_ROW_DEGREES on the host
// (sionna_tpu_torch/phy/fec/ldpc/decoding.py), which gives nvcc their
// bit mask.
#define SIONNA_CN_DEGREES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(19)
#ifndef SIONNA_CN_ROW_DEGREE_MASK
#error "build with the defines of the kernel (sionna_tpu_torch/_build.py)"
#endif
#define SIONNA_CN_BIT(D) | (1u << D)
static_assert((0u SIONNA_CN_DEGREES(SIONNA_CN_BIT)) ==
                  static_cast<unsigned>(SIONNA_CN_ROW_DEGREE_MASK),
              "the check-node cases differ from CN_ROW_DEGREES");
#undef SIONNA_CN_BIT

// What cn_extrinsic hands on for a boxplus row: the magnitude
// 2 atanh(x) as log1p(x) - log1p(-x), or as the Pallas kernel's "ratio"
// form log((1 + x) / (1 - x)); or (kProduct) the clamped extrinsic
// product x itself, for a caller that takes the magnitude later.
constexpr int kLog1p = 0;
constexpr int kRatio = 1;
constexpr int kProduct = 2;

__device__ __forceinline__ float clampf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

__device__ __forceinline__ float signf(float x) {
  return x < 0.f ? -1.f : 1.f;
}

// Message state: f32, or bf16 rounded to nearest even on every store and
// widened to f32 on every load (torch's .to(torch.bfloat16) rounds the
// same way). All arithmetic is f32.
__device__ __forceinline__ float load_msg(const float* p) { return *p; }
__device__ __forceinline__ float load_msg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_msg(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_msg(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The two ends of a check-node unit as K1 (ldpc_lifted_bp.cu) and the
// gradient kernels (ldpc_cn_grad.cuh) compute it. cn_edge_in takes edge
// k's v2c message m (`on` on an active lane): val[k] becomes
// the check node's input, tanh(|m|/2) (mode 0, boxplus) or |m| (min-sum),
// or on an inactive lane the neutral 1 or 1e30; bit k of neg marks a
// negative m and sign_tot takes the product of the signs. cn_edge_out
// gives edge k's c2v message from its extrinsic magnitude mag: signed by
// the other edges' signs, clipped at clip, 0 on an inactive lane.
template <int D>
__device__ __forceinline__ void cn_edge_in(int k, float m, bool on, int mode,
                                           float (&val)[D], unsigned& neg,
                                           float& sign_tot) {
  float v = mode == 0 ? tanhf(fabsf(m) / 2.f) : fabsf(m);
  float s = signf(m);
  if (!on) {
    v = mode == 0 ? 1.f : 1e30f;
    s = 1.f;
  }
  val[k] = v;
  if (s < 0.f) neg |= 1u << k;
  sign_tot = k == 0 ? s : sign_tot * s;
}

__device__ __forceinline__ float cn_edge_out(int k, float mag, unsigned neg,
                                             unsigned act, float sign_tot,
                                             float clip) {
  const float sgn = (neg >> k) & 1u ? -1.f : 1.f;
  return sign_tot * sgn * fminf(mag, clip) * ((act >> k) & 1u ? 1.f : 0.f);
}

// The boxplus magnitude of the clamped extrinsic product x.
template <int kForm>
__device__ __forceinline__ float boxplus_mag(float x) {
  if constexpr (kForm == kRatio) {
    return logf((1.f + x) / (1.f - x));
  } else {
    return log1pf(x) - log1pf(-x);
  }
}

// The extrinsic magnitude of each of a row's D edges from their inputs
// val[k] (tanh(|m|/2) of its v2c m for boxplus, |m| for min-sum; on an
// inactive lane the neutral 1 or 1e30), handed to emit(k, x) in edge
// order: mode 0 the boxplus magnitude (kForm) of the prefix and suffix
// products clamped at 1 - 1e-7, or with kProduct the clamped product;
// mode 1 the (offset) min-sum magnitude. Signs and clipping are the caller's.
template <int D, int kForm, class Emit>
__device__ __forceinline__ void cn_extrinsic(const float (&val)[D], int mode,
                                             float offset, Emit emit) {
  if (mode == 0) {
    const float hi = (float)(1.0 - 1e-7);
    // backward products bwd[k] = t[k] * ... * t[D-1], accumulated from
    // the end as ((t[D-1] * t[D-2]) * t[D-3]) ...
    float bwd[D];
    bwd[D - 1] = val[D - 1];
#pragma unroll
    for (int k = D - 2; k >= 0; --k) bwd[k] = bwd[k + 1] * val[k];
    float fwd = 1.f;  // t[0] * ... * t[k-1]
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float ext = hi;
      if constexpr (D > 1) {
        if (k == 0) {
          ext = fminf(bwd[1], hi);
        } else if (k == D - 1) {
          ext = fminf(fwd, hi);
        } else {
          ext = fminf(fwd * bwd[k + 1 < D ? k + 1 : k], hi);
        }
      }
      fwd = k == 0 ? val[0] : fwd * val[k];
      if constexpr (kForm == kProduct) {
        emit(k, ext);
      } else {
        emit(k, boxplus_mag<kForm>(ext));
      }
    }
  } else {
    float min1 = val[0];
#pragma unroll
    for (int k = 1; k < D; ++k) min1 = fminf(min1, val[k]);
    float min2 = 1e30f;
    int n_min = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      min2 = fminf(min2, val[k] > min1 ? val[k] : 1e30f);
      n_min += val[k] == min1;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float ext = (val[k] == min1 && n_min == 1) ? min2 : min1;
      if (offset > 0.f) ext = fmaxf(ext - offset, 0.f);
      emit(k, ext);
    }
  }
}

// Launches `kernel(args...)` on `stream` with `threads` threads a block and
// one block per codeword of the batch, or (multi) a cluster of `cluster`
// blocks per codeword, after opting in to `smem` bytes of dynamic shared
// memory; returns the CUDA error code. The decoders' launches (K1, K3 and
// their tape variants K5f, K5Lf) go through it.
template <class... Params, class... Args>
cudaError_t launch_per_codeword(void (*kernel)(Params...), bool multi,
                                int batch, int cluster, int threads,
                                size_t smem, cudaStream_t stream,
                                Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = multi ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace sionna_ldpc
