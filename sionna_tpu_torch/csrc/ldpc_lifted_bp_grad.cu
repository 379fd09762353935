// The gradient of the lifted 5G LDPC decoder, flooding schedule: K5f, the
// decode with its tape, and K5b, its reverse.
//
// Replaces, on the training path, the flooding branch of the Pallas kernel
// `_lifted_pallas_decode` in sionna_tpu/phy/fec/ldpc/decoding.py (which has
// no VJP) together with what the JAX package differentiates instead: XLA's
// autodiff of `LDPC5GLiftedBP.decode` (its `fori_loop` of `_lifted_cn_phase`
// and the VN phase). The plain versions are `flooding_tape_forward` and
// `flooding_reverse` in sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py.
//
// - K5f decodes as K1 (ldpc_lifted_bp.cu) does, check node from
//   ldpc_cn_grad.cuh's cn_forward (K1's arithmetic, from ldpc_cn.cuh) and
//   the VN sum llr + c2v[e0] + c2v[e1] + ... in column order, so its
//   marginals are bit-identical to K1's, and writes the tape: tape[t] is
//   the CN-aligned v2c that iteration t reads ([T, E, B, Z] f32; the carry
//   of JAX's loop).
// - K5b walks the iterations backwards. In iteration t it recomputes the
//   c2v from tape[t] (the same code as K5f, so the same values) and the VN
//   sums; takes the VN phase's reverse (the clips of the marginal, only in
//   the last iteration, and of each v2c, JAX's 1/2 at the bound; the rolls
//   inverted by the CN-aligned indexing), which leaves dL/dc2v in the c2v
//   scratch; then the CN phase's (cn_adjoint), into the dL/dv2c scratch;
//   last, the initial clip of the LLRs. dL/dllr accumulates per VN lane.
//
// What bounds it on an H100: device memory. This first design keeps the
// message state of each codeword in device memory (two [E, Z] scratch
// slabs per codeword) besides the tape, one block per codeword and its
// threads over the (row, lane) and (column, lane) units: K5f reads the tape
// once and writes it once per iteration, and moves the c2v slab three
// times; K5b reads the tape twice per iteration and moves the slabs about
// six times. The bytes the function needs are the LLRs, the tape and the
// marginals (or their gradients): one write of the tape by K5f and one
// read by K5b, 1.28 GB at the n = 2048 x 2000 link at BP-20, 9.91 GB at
// n = 12288 x 2048. Keeping the slabs on chip (as K1 keeps its state) is
// the next step.

#include <cuda_runtime.h>

#include "ldpc_cn_grad.cuh"

namespace {

using sionna_ldpc::bad_args;
using sionna_ldpc::clampf;
using sionna_ldpc::cn_adjoint;
using sionna_ldpc::cn_forward;
using sionna_ldpc::d_clip;
using sionna_ldpc::lane_on;
using sionna_ldpc::load_plan;
using sionna_ldpc::Plan;
using sionna_ldpc::with_degree;

#ifndef SIONNA_K5_THREADS
#error "build with the defines of LIFTED_BP_GRAD_KERNEL (lifted_grad.py)"
#endif
constexpr int kThreads = SIONNA_K5_THREADS;

// The CN-aligned lane of edge e that VN lane j of its column meets.
__device__ __forceinline__ int cn_lane(const Plan& p, int e, int j, int z) {
  int l = j - p.shift[e];
  return l < 0 ? l + z : l;
}

// CN phase of iteration t: c2v[e * z + l] (the codeword's slab) from the
// v2c at v2c[e * estride + l].
__device__ __forceinline__ void cn_phase(const Plan& p, const float* v2c,
                                         size_t estride, float* c2v,
                                         int n_rows, int z, float clip,
                                         float offset, int mode) {
  for (int u = threadIdx.x; u < n_rows * z; u += blockDim.x) {
    const int r = u / z;
    const int l = u - r * z;
    const int p0 = p.row_ptr[r];
    with_degree(p.row_ptr[r + 1] - p0, [&](auto dc) {
      constexpr int D = decltype(dc)::value;
      float m[D], out[D];
      unsigned act = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        m[k] = v2c[(p0 + k) * estride + l];
        if (lane_on(p.range[p0 + k], z, l)) act |= 1u << k;
      }
      cn_forward<D>(m, act, clip, offset, mode, out);
#pragma unroll
      for (int k = 0; k < D; ++k) c2v[(p0 + k) * z + l] = out[k];
    });
  }
}

// K5f. llr, out: [B, C * z]; tape: [T, E, B, z]; c2v: [B, E, z] scratch.
__global__ void __launch_bounds__(kThreads)
flooding_tape_kernel(const float* __restrict__ llr,
                     const int* __restrict__ plan, float* __restrict__ out,
                     float* __restrict__ tape, float* __restrict__ c2v,
                     int batch, int n_rows, int n_cols, int n_edges, int z,
                     int plan_len, int num_iter, float clip, float offset,
                     int mode) {
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;
  if (num_iter == 0) {
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      out_b[u] = llr_b[u];
    }
    return;
  }
  const Plan p = load_plan(plan, plan_len);
  const size_t estride = static_cast<size_t>(batch) * z;  // edge to edge
  const size_t tstride = estride * n_edges;               // iteration
  float* c2v_b = c2v + b * n_edges * z;
  float* tape_b = tape + b * z;
  // iteration 0 reads v2c = clip(llr) in CN alignment
  for (int u = threadIdx.x; u < n_edges * z; u += blockDim.x) {
    const int e = u / z;
    const int l = u - e * z;
    int j = l + p.shift[e];
    if (j >= z) j -= z;
    tape_b[e * estride + l] = clampf(llr_b[p.col[e] * z + j], clip);
  }
  __syncthreads();
  for (int it = 0; it < num_iter; ++it) {
    const float* v2c = tape_b + it * tstride;
    cn_phase(p, v2c, estride, c2v_b, n_rows, z, clip, offset, mode);
    __syncthreads();
    // VN phase: marginal = clip(llr + c2v[e0] + c2v[e1] + ...) in the last
    // iteration; else each edge's next v2c = clip(sum - its c2v)
    const bool last = it == num_iter - 1;
    float* next = tape_b + (it + 1) * tstride;
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      const int c = u / z;
      const int j = u - c * z;
      const int q0 = p.col_ptr[c];
      const int q1 = p.col_ptr[c + 1];
      float tot = llr_b[u];
      for (int q = q0; q < q1; ++q) {
        const int e = p.col_edge[q];
        tot = tot + c2v_b[e * z + cn_lane(p, e, j, z)];
      }
      if (last) {
        out_b[u] = clampf(tot, clip);
        continue;
      }
      for (int q = q0; q < q1; ++q) {
        const int e = p.col_edge[q];
        const int l = cn_lane(p, e, j, z);
        next[e * estride + l] = clampf(tot - c2v_b[e * z + l], clip);
      }
    }
    __syncthreads();
  }
}

// K5b. g_marg, g_llr: [B, C * z] (padded: 0 beyond the code's VNs);
// c2v, gv: [B, E, z] scratch slabs (c2v, then dL/dc2v; dL/dv2c).
__global__ void __launch_bounds__(kThreads)
flooding_reverse_kernel(const float* __restrict__ llr,
                        const int* __restrict__ plan,
                        const float* __restrict__ g_marg,
                        const float* __restrict__ tape,
                        float* __restrict__ g_llr, float* __restrict__ c2v,
                        float* __restrict__ gv, int batch, int n_rows,
                        int n_cols, int n_edges, int z, int plan_len,
                        int num_iter, float clip, float offset, int mode) {
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  const float* gm_b = g_marg + b * n_cols * z;
  float* gl_b = g_llr + b * n_cols * z;
  if (num_iter == 0) {
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      gl_b[u] = gm_b[u];
    }
    return;
  }
  const Plan p = load_plan(plan, plan_len);
  const size_t estride = static_cast<size_t>(batch) * z;
  const size_t tstride = estride * n_edges;
  float* c2v_b = c2v + b * n_edges * z;
  float* gv_b = gv + b * n_edges * z;
  const float* tape_b = tape + b * z;
  // every loop over the (column, lane) units maps unit u to the same
  // thread, so each dL/dllr lane has one writer throughout
  for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) gl_b[u] = 0.f;
  for (int it = num_iter - 1; it >= 0; --it) {
    const float* v2c = tape_b + it * tstride;
    cn_phase(p, v2c, estride, c2v_b, n_rows, z, clip, offset, mode);
    __syncthreads();
    // VN reverse: h_e = dL/dv2c_e * clip'(sum - c2v_e); dL/dsum =
    // dL/dmarg * clip'(sum) (last iteration) + sum of h_e; dL/dc2v_e =
    // dL/dsum - h_e, written over c2v_e
    const bool last = it == num_iter - 1;
    for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
      const int c = u / z;
      const int j = u - c * z;
      const int q0 = p.col_ptr[c];
      const int q1 = p.col_ptr[c + 1];
      float tot = llr_b[u];
      for (int q = q0; q < q1; ++q) {
        const int e = p.col_edge[q];
        tot = tot + c2v_b[e * z + cn_lane(p, e, j, z)];
      }
      float gt = 0.f;
      if (last) {
        gt = gm_b[u] * d_clip(tot, clip);
      } else {
        for (int q = q0; q < q1; ++q) {
          const int i = p.col_edge[q] * z + cn_lane(p, p.col_edge[q], j, z);
          gt = gt + gv_b[i] * d_clip(tot - c2v_b[i], clip);
        }
      }
      for (int q = q0; q < q1; ++q) {
        const int i = p.col_edge[q] * z + cn_lane(p, p.col_edge[q], j, z);
        const float h = last ? 0.f : gv_b[i] * d_clip(tot - c2v_b[i], clip);
        c2v_b[i] = gt - h;
      }
      gl_b[u] += gt;
    }
    __syncthreads();
    // CN reverse: dL/dv2c of each (row, lane) unit into gv
    for (int u = threadIdx.x; u < n_rows * z; u += blockDim.x) {
      const int r = u / z;
      const int l = u - r * z;
      const int p0 = p.row_ptr[r];
      with_degree(p.row_ptr[r + 1] - p0, [&](auto dc) {
        constexpr int D = decltype(dc)::value;
        float m[D], g[D];
        unsigned act = 0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          m[k] = v2c[(p0 + k) * estride + l];
          g[k] = c2v_b[(p0 + k) * z + l];
          if (lane_on(p.range[p0 + k], z, l)) act |= 1u << k;
        }
        cn_adjoint<D>(m, g, act, clip, offset, mode);
#pragma unroll
        for (int k = 0; k < D; ++k) gv_b[(p0 + k) * z + l] = g[k];
      });
    }
    __syncthreads();
  }
  // iteration 0's v2c = clip(llr): dL/dllr += clip'(llr) * sum of dL/dv2c
  for (int u = threadIdx.x; u < n_cols * z; u += blockDim.x) {
    const int c = u / z;
    const int j = u - c * z;
    const int q0 = p.col_ptr[c];
    const int q1 = p.col_ptr[c + 1];
    if (q0 == q1) continue;
    float acc = 0.f;
    for (int q = q0; q < q1; ++q) {
      const int e = p.col_edge[q];
      acc = acc + gv_b[e * z + cn_lane(p, e, j, z)];
    }
    gl_b[u] += d_clip(llr_b[u], clip) * acc;
  }
}

}  // namespace

extern "C" {

// K5f. llr, out: [batch, n_cols * z] f32 (CUDA); plan: the int32 plan of
// `grad_plan` (plan_len ints, on the card); tape: [num_iter, n_edges,
// batch, z]; c2v: [batch, n_edges, z] scratch (unused when num_iter is 0).
// mode 0 boxplus, 1 (offset) min-sum. Launches on `stream` and returns the
// CUDA error code (0 on success).
int sionna_ldpc_flooding_tape(const float* llr, const int* plan, float* out,
                              float* tape, float* c2v, int batch, int n_rows,
                              int n_cols, int n_edges, int z, int plan_len,
                              int num_iter, float clip, float offset,
                              int mode, void* stream) {
  if (bad_args(batch, n_rows, n_cols, n_edges, z, plan_len, num_iter, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flooding_tape_kernel<<<batch, kThreads, plan_len * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
      llr, plan, out, tape, c2v, batch, n_rows, n_cols, n_edges, z, plan_len,
      num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

// K5b. g_marg, g_llr: [batch, n_cols * z]; tape as K5f wrote it; c2v, gv:
// [batch, n_edges, z] scratch each. Other arguments as K5f's.
int sionna_ldpc_flooding_reverse(const float* llr, const int* plan,
                                 const float* g_marg, const float* tape,
                                 float* g_llr, float* c2v, float* gv,
                                 int batch, int n_rows, int n_cols,
                                 int n_edges, int z, int plan_len,
                                 int num_iter, float clip, float offset,
                                 int mode, void* stream) {
  if (bad_args(batch, n_rows, n_cols, n_edges, z, plan_len, num_iter, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flooding_reverse_kernel<<<batch, kThreads, plan_len * sizeof(int),
                            static_cast<cudaStream_t>(stream)>>>(
      llr, plan, g_marg, tape, g_llr, c2v, gv, batch, n_rows, n_cols, n_edges,
      z, plan_len, num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
