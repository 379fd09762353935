// 5G LDPC belief propagation in the lifted domain, layered (serial-C)
// schedule.
//
// Replaces the layered branch (`layered=True`) of the Pallas kernel
// `_lifted_pallas_decode` in sionna_tpu/phy/fec/ldpc/decoding.py. It
// computes what that branch and the plain version
// (LDPC5GLiftedBP.decode_layered) compute: the posterior starts at the
// channel LLRs and the per-edge check messages c2v at zero; the base rows
// are processed in order, and for each row r and lane i
//   v2c    = marg[c][(i + s) mod Z] - c2v_old
//   c2v    = check-node update of the row's v2c (clipped inside)
//   marg[c][(i + s) mod Z] += c2v - c2v_old
// for every edge (r, c, s) of the row. Only c2v is clipped: clipping the
// posterior would break the marg/c2v bookkeeping. With the kernel's
// `storage_dtype` knob the c2v state is stored in bf16: c2v_old is the
// stored (rounded) value in both lines above, c2v the unrounded new one,
// and the store rounds it, as the Pallas kernel does.
//
// Design: one thread block per codeword, one thread per lane i < Z. The
// posterior lives in shared memory for the whole launch (n_cols * Z
// floats: 52 KB at the n = 12288 code, BG1 with Z = 288) and is written
// to the output once at the end; c2v[b][e][i] lives in device memory, in
// a scratch buffer the caller allocates, and each thread touches only its
// own lane of it. Within a row every column appears once (one edge per
// base-matrix entry), so the lanes' posterior updates form a bijection
// and do not race; row r + 1 reads posterior lanes that other threads
// wrote in row r, hence one block barrier after every row.
//
// What bounds it on an H100: the serial chain of rows. Each row costs a
// barrier and a dependent read-modify-write of the posterior; c2v traffic
// is two passes over [batch, E_b, Z] values per iteration (0.99 GB per
// iteration at n = 12288 and batch 2048 in f32, half that in bf16).
//
// Numerics follow the plain version operation by operation (check-node
// math and bf16 rounding shared with the flooding kernel in ldpc_cn.cuh;
// no expression with the a * b + c shape), so the two agree bit for bit.

#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace {

using sionna_ldpc::kMaxDegree;
using sionna_ldpc::load_msg;
using sionna_ldpc::store_msg;

// S: c2v storage type (float or __nv_bfloat16).
template <class S>
__global__ void layered_bp_kernel(
    const float* __restrict__ llr, const float* __restrict__ mask,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    const int* __restrict__ row_ptr, const int* __restrict__ row_edges,
    float* __restrict__ out, S* __restrict__ c2v, int n_rows, int n_cols,
    int n_edges, int z, int num_iter, float clip, float offset, int mode) {
  extern __shared__ float marg[];  // [n_cols * z] posterior
  const int i = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;
  S* c2v_b = c2v + b * n_edges * z;
  const bool lane_ok = i < z;

  for (int j = i; j < n_cols * z; j += blockDim.x) marg[j] = llr_b[j];
  if (lane_ok) {
    for (int e = 0; e < n_edges; ++e) store_msg(c2v_b + e * z + i, 0.f);
  }
  __syncthreads();

  for (int it = 0; it < num_iter; ++it) {
    for (int r = 0; r < n_rows; ++r) {
      const int e0 = row_ptr[r];
      const int d = row_ptr[r + 1] - e0;
      if (lane_ok && d > 0) {
        const int* eids = row_edges + e0;
        float old[kMaxDegree];  // stored c2v of the previous iteration
        int pos[kMaxDegree];    // posterior lane of each edge
        for (int k = 0; k < d; ++k) {
          const int e = eids[k];
          int l = i + edge_shift[e];
          if (l >= z) l -= z;
          pos[k] = edge_col[e] * z + l;
          old[k] = load_msg(c2v_b + e * z + i);
        }
        sionna_ldpc::cn_update<sionna_ldpc::kLog1p>(
            [&](int k) { return marg[pos[k]] - old[k]; },
            [&](int k) { return mask[eids[k] * z + i]; },
            [&](int k, float c2v_new) {
              marg[pos[k]] = marg[pos[k]] + (c2v_new - old[k]);
              store_msg(c2v_b + eids[k] * z + i, c2v_new);
            },
            d, clip, offset, mode);
      }
      __syncthreads();
    }
  }
  for (int j = i; j < n_cols * z; j += blockDim.x) out_b[j] = marg[j];
}

template <class S>
int launch(const float* llr, const float* mask, const int* edge_col,
           const int* edge_shift, const int* row_ptr, const int* row_edges,
           float* out, S* c2v, int batch, int n_rows, int n_cols,
           int n_edges, int z, int num_iter, float clip, float offset,
           int mode, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_cols) * z * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      layered_bp_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (z + 31) / 32 * 32;
  layered_bp_kernel<S><<<batch, threads, smem, stream>>>(
      llr, mask, edge_col, edge_shift, row_ptr, row_edges, out, c2v, n_rows,
      n_cols, n_edges, z, num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest row degree the kernel's local arrays hold.
int sionna_ldpc_max_degree() { return kMaxDegree; }

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr, out: [batch, n_cols * z]; mask: [n_edges, z]; c2v (scratch):
// [batch, n_edges, z] of float (bf16 == 0) or __nv_bfloat16 (bf16 == 1);
// row tables as in ldpc_lifted_bp.cu. Launches on `stream` with
// n_cols * z floats of dynamic shared memory and returns the CUDA error
// code (0 on success).
int sionna_ldpc_layered_bp(const float* llr, const float* mask,
                           const int* edge_col, const int* edge_shift,
                           const int* row_ptr, const int* row_edges,
                           float* out, void* c2v, int batch, int n_rows,
                           int n_cols, int n_edges, int z, int num_iter,
                           float clip, float offset, int mode, int bf16,
                           void* stream) {
  if (batch <= 0 || z <= 0 || z > 1024 || (mode != 0 && mode != 1) ||
      (bf16 != 0 && bf16 != 1) || c2v == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(llr, mask, edge_col, edge_shift, row_ptr, row_edges, out,
                  static_cast<__nv_bfloat16*>(c2v), batch, n_rows, n_cols,
                  n_edges, z, num_iter, clip, offset, mode, s);
  }
  return launch(llr, mask, edge_col, edge_shift, row_ptr, row_edges, out,
                static_cast<float*>(c2v), batch, n_rows, n_cols, n_edges, z,
                num_iter, clip, offset, mode, s);
}

}  // extern "C"
