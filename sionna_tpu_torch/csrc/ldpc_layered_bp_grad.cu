// The gradient of the lifted 5G LDPC decoder, layered (serial-C) schedule:
// K5Lf, the decode with its tape, and K5Lb, its reverse.
//
// Replaces, on the training path, the layered branch of the Pallas kernel
// `_lifted_pallas_decode` in sionna_tpu/phy/fec/ldpc/decoding.py (which has
// no VJP) together with what the JAX package differentiates instead: XLA's
// autodiff of `LDPC5GLiftedBP.decode_layered`. The plain versions are
// `layered_tape_forward` and `layered_reverse` in
// sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py.
//
// For each row r and lane i, with c2v_old the row's messages before it:
//   v2c  = post[c][(i + s) mod Z] - c2v_old
//   c2v  = check-node update of the row's v2c (clipped inside)
//   post[c][(i + s) mod Z] += c2v - c2v_old
// - K5Lf runs the rows in order, as K3 (ldpc_layered_bp.cu) does, with the
//   check node of ldpc_cn_grad.cuh's cn_forward (K3's arithmetic, from
//   ldpc_cn.cuh) and the same two lines around it, so its marginals are
//   bit-identical to K3's. The posterior lives in the output; the tape
//   holds each iteration's starting posterior ([T, C, B, Z]) and c2v
//   ([T, E, B, Z]): tape_c[t + 1] is where iteration t writes its new c2v.
// - K5Lb walks the iterations backwards. In iteration t it replays the
//   row sweep from the tape into a posterior slab, keeping every edge's
//   v2c; then walks the rows backwards: with gP = dL/dpost (in the output)
//   and gC = dL/dc2v (a slab), per edge gN = gC + gP[(i + s) mod Z] is
//   dL/dc2v_new, cn_adjoint gives gV = dL/dv2c, and
//   gP[(i + s) mod Z] += gV, gC = -gP_before - gV.
//   After iteration 0, dL/dllr is gP (the posterior starts at the LLRs).
//
// What bounds it on an H100: device memory and the chain of rows. This
// first design keeps the state in device memory, one block per codeword
// with a thread per lane, the rows in sequence with a block barrier after
// each (K3 runs rows that share no column together). The bytes the
// function needs are the LLRs, the tape and the marginals (or their
// gradients): one write of the tape by K5Lf and one read by K5Lb, T x (E +
// C) x B x Z x 4 bytes (12.9 GB at n = 12288 x 2048 layered-10).

#include <cuda_runtime.h>

#include "ldpc_cn_grad.cuh"

namespace {

using sionna_ldpc::bad_args;
using sionna_ldpc::cn_adjoint;
using sionna_ldpc::cn_forward;
using sionna_ldpc::lane_on;
using sionna_ldpc::load_plan;
using sionna_ldpc::Plan;
using sionna_ldpc::with_degree;

// threads per block: one per lane, the largest 5G lifting size
constexpr int kMaxLanes = 384;

// The posterior lane of edge e that CN lane l of its row meets.
__device__ __forceinline__ int vn_index(const Plan& p, int e, int l, int z) {
  int j = l + p.shift[e];
  if (j >= z) j -= z;
  return p.col[e] * z + j;
}

// One row step of the sweep at lane l: v2c from post and the old c2v at
// c_old[e * estride + l], the check node, the posterior update; the new
// c2v to c_new (unless null) and the v2c to v2c_keep[e * z + l] (unless
// null).
template <int D>
__device__ __forceinline__ void row_step(const Plan& p, int p0, int l, int z,
                                         float* post, const float* c_old,
                                         float* c_new, size_t estride,
                                         float* v2c_keep, float clip,
                                         float offset, int mode) {
  float m[D], old[D], out[D];
  unsigned act = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int e = p0 + k;
    old[k] = c_old[e * estride + l];
    m[k] = post[vn_index(p, e, l, z)] - old[k];
    if (v2c_keep) v2c_keep[e * z + l] = m[k];
    if (lane_on(p.range[e], z, l)) act |= 1u << k;
  }
  cn_forward<D>(m, act, clip, offset, mode, out);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int e = p0 + k;
    const int i = vn_index(p, e, l, z);
    post[i] = post[i] + (out[k] - old[k]);
    if (c_new) c_new[e * estride + l] = out[k];
  }
}

// One iteration's sweep over the rows, in order.
__device__ __forceinline__ void sweep(const Plan& p, int n_rows, int z,
                                      float* post, const float* c_old,
                                      float* c_new, size_t estride,
                                      float* v2c_keep, float clip,
                                      float offset, int mode) {
  for (int r = 0; r < n_rows; ++r) {
    const int p0 = p.row_ptr[r];
    for (int l = threadIdx.x; l < z; l += blockDim.x) {
      with_degree(p.row_ptr[r + 1] - p0, [&](auto dc) {
        row_step<decltype(dc)::value>(p, p0, l, z, post, c_old, c_new,
                                      estride, v2c_keep, clip, offset, mode);
      });
    }
    __syncthreads();
  }
}

// K5Lf. llr, out: [B, C * z]; tape_m: [T, C, B, z]; tape_c: [T, E, B, z].
__global__ void __launch_bounds__(kMaxLanes)
layered_tape_kernel(const float* __restrict__ llr,
                    const int* __restrict__ plan, float* __restrict__ out,
                    float* __restrict__ tape_m, float* __restrict__ tape_c,
                    int batch, int n_rows, int n_cols, int n_edges, int z,
                    int plan_len, int num_iter, float clip, float offset,
                    int mode) {
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  float* post = out + b * n_cols * z;
  for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
    post[u] = llr_b[u];
  }
  if (num_iter == 0) return;
  const Plan p = load_plan(plan, plan_len);  // a barrier after the copy
  const size_t estride = static_cast<size_t>(batch) * z;
  float* tm_b = tape_m + b * z;
  float* tc_b = tape_c + b * z;
  for (int it = 0; it < num_iter; ++it) {
    float* c_old = tc_b + it * estride * n_edges;
    float* c_new = it + 1 < num_iter ? c_old + estride * n_edges : nullptr;
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      const int c = u / z;
      tm_b[(it * n_cols + c) * estride + (u - c * z)] = post[u];
    }
    if (it == 0) {
      for (int u = threadIdx.x; u < n_edges * z; u += blockDim.x) {
        const int e = u / z;
        c_old[e * estride + (u - e * z)] = 0.f;
      }
    }
    __syncthreads();
    sweep(p, n_rows, z, post, c_old, c_new, estride, nullptr, clip, offset,
          mode);
  }
}

// K5Lb. g_marg, g_llr: [B, C * z] (padded: 0 beyond the code's VNs); post:
// [B, C, z], v2c, gc: [B, E, z] scratch slabs.
__global__ void __launch_bounds__(kMaxLanes)
layered_reverse_kernel(const float* __restrict__ llr,
                       const int* __restrict__ plan,
                       const float* __restrict__ g_marg,
                       const float* __restrict__ tape_m,
                       const float* __restrict__ tape_c,
                       float* __restrict__ g_llr, float* __restrict__ post,
                       float* __restrict__ v2c, float* __restrict__ gc,
                       int batch, int n_rows, int n_cols, int n_edges, int z,
                       int plan_len, int num_iter, float clip, float offset,
                       int mode) {
  const size_t b = blockIdx.x;
  float* gp = g_llr + b * n_cols * z;  // dL/dpost
  const float* gm_b = g_marg + b * n_cols * z;
  for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) gp[u] = gm_b[u];
  if (num_iter == 0) return;
  float* gc_b = gc + b * n_edges * z;  // dL/dc2v
  for (int u = threadIdx.x; u < n_edges * z; u += blockDim.x) gc_b[u] = 0.f;
  const Plan p = load_plan(plan, plan_len);
  const size_t estride = static_cast<size_t>(batch) * z;
  float* post_b = post + b * n_cols * z;
  float* v2c_b = v2c + b * n_edges * z;
  for (int it = num_iter - 1; it >= 0; --it) {
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      const int c = u / z;
      post_b[u] = tape_m[(it * n_cols + c) * estride + b * z + (u - c * z)];
    }
    const float* c_old = tape_c + it * estride * n_edges + b * z;
    __syncthreads();
    sweep(p, n_rows, z, post_b, c_old, nullptr, estride, v2c_b, clip, offset,
          mode);
    for (int r = n_rows - 1; r >= 0; --r) {
      const int p0 = p.row_ptr[r];
      for (int l = threadIdx.x; l < z; l += blockDim.x) {
        with_degree(p.row_ptr[r + 1] - p0, [&](auto dc) {
          constexpr int D = decltype(dc)::value;
          float m[D], g[D], gpb[D];
          unsigned act = 0;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const int e = p0 + k;
            gpb[k] = gp[vn_index(p, e, l, z)];
            g[k] = gc_b[e * z + l] + gpb[k];
            m[k] = v2c_b[e * z + l];
            if (lane_on(p.range[e], z, l)) act |= 1u << k;
          }
          cn_adjoint<D>(m, g, act, clip, offset, mode);
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const int e = p0 + k;
            gp[vn_index(p, e, l, z)] = gpb[k] + g[k];
            gc_b[e * z + l] = -gpb[k] - g[k];
          }
        });
      }
      __syncthreads();
    }
  }
}

int lane_threads(int z) {
  return z < kMaxLanes ? (z + 31) / 32 * 32 : kMaxLanes;
}

}  // namespace

extern "C" {

// K5Lf. llr, out: [batch, n_cols * z] f32 (CUDA); plan: the int32 plan of
// `grad_plan` (plan_len ints, on the card); tape_m: [num_iter, n_cols,
// batch, z]; tape_c: [num_iter, n_edges, batch, z]. mode 0 boxplus, 1
// (offset) min-sum. Launches on `stream`; returns the CUDA error code.
int sionna_ldpc_layered_tape(const float* llr, const int* plan, float* out,
                             float* tape_m, float* tape_c, int batch,
                             int n_rows, int n_cols, int n_edges, int z,
                             int plan_len, int num_iter, float clip,
                             float offset, int mode, void* stream) {
  if (bad_args(batch, n_rows, n_cols, n_edges, z, plan_len, num_iter, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  layered_tape_kernel<<<batch, lane_threads(z), plan_len * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
      llr, plan, out, tape_m, tape_c, batch, n_rows, n_cols, n_edges, z,
      plan_len, num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

// K5Lb. g_marg, g_llr: [batch, n_cols * z]; the tapes as K5Lf wrote them;
// post: [batch, n_cols, z], v2c, gc: [batch, n_edges, z] scratch.
int sionna_ldpc_layered_reverse(const float* llr, const int* plan,
                                const float* g_marg, const float* tape_m,
                                const float* tape_c, float* g_llr,
                                float* post, float* v2c, float* gc,
                                int batch, int n_rows, int n_cols,
                                int n_edges, int z, int plan_len,
                                int num_iter, float clip, float offset,
                                int mode, void* stream) {
  if (bad_args(batch, n_rows, n_cols, n_edges, z, plan_len, num_iter, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  layered_reverse_kernel<<<batch, lane_threads(z), plan_len * sizeof(int),
                           static_cast<cudaStream_t>(stream)>>>(
      llr, plan, g_marg, tape_m, tape_c, g_llr, post, v2c, gc, batch, n_rows,
      n_cols, n_edges, z, plan_len, num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
