// 5G LDPC belief propagation in the lifted (block-circulant) domain.
//
// Replaces the Pallas kernel `_lifted_pallas_decode` in
// sionna_tpu/phy/fec/ldpc/decoding.py (with its check-node math in
// `_lifted_cn_phase`). It computes what that kernel computes: flooding BP
// over per-base-edge message blocks of Z lanes, with boxplus (tanh rule),
// min-sum or offset min-sum check nodes, every iteration inside one
// launch.
//
// Design: one thread block per codeword, one thread per lane i < Z. The
// message state msg[b][e][i] (f32, CN alignment: lane i of base edge
// (r, c, s) links CN (r, i) with VN (c, (i + s) mod Z)) lives in device
// memory, in a scratch buffer the caller allocates. A cyclic shift is an
// index (i + s) mod Z; nothing moves. The CN phase reads and writes only
// the thread's own lane; the VN phase reads and writes lane (j - s) mod Z
// of each edge of column c, a bijection over lanes, so both phases update
// msg in place, with a block barrier between them.
//
// What bounds it on an H100: device-memory traffic. Each iteration makes
// about four passes over msg (CN read + write, VN read + write): at the
// n = 12288 code (BG1, Z = 288, 210 base edges) and batch 2048 that is
// 2048 * 210 * 288 * 4 B * 4 = 2 GB per iteration, far above the 50 MB
// L2. This simple design does nothing about it yet: it neither keeps
// msg in shared memory (one codeword's state is 241,920 B at that code,
// above the 227 KB a block may use; 32,032 B at the n = 2048 code) nor
// splits rows across more threads.
//
// Numerics follow the plain version (LDPC5GLiftedBP.decode) operation by
// operation, in the same order: the check-node math is shared with the
// layered kernel in ldpc_cn.cuh, and no expression here has the
// a * b + c shape that nvcc would contract into an FMA.

#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace {

using sionna_ldpc::clampf;
using sionna_ldpc::kMaxDegree;

// One check-node row for lane i: replaces the row's d messages by the
// check-node update, in place. mode 0: boxplus; 1: (offset) min-sum.
__device__ void cn_row(float* __restrict__ msg, const float* __restrict__ mask,
                       const int* __restrict__ edges, int d, int z, int i,
                       float clip, float offset, int mode) {
  sionna_ldpc::cn_update(
      [&](int k) { return msg[edges[k] * z + i]; },
      [&](int k) { return mask[edges[k] * z + i]; },
      [&](int k, float c2v) { msg[edges[k] * z + i] = c2v; }, d, clip,
      offset, mode);
}

// One variable-node column c for lane j.
__device__ void vn_col(float* __restrict__ msg, float* __restrict__ out,
                       const float* __restrict__ llr,
                       const int* __restrict__ edges,
                       const int* __restrict__ edge_shift, int d, int c,
                       int z, int j, float clip) {
  float rolled[kMaxDegree];
  int lane[kMaxDegree];
  float tot = llr[c * z + j];
  for (int k = 0; k < d; ++k) {
    const int e = edges[k];
    int l = j - edge_shift[e];
    if (l < 0) l += z;
    lane[k] = e * z + l;
    rolled[k] = msg[lane[k]];
    tot = tot + rolled[k];
  }
  out[c * z + j] = clampf(tot, clip);
  for (int k = 0; k < d; ++k) msg[lane[k]] = clampf(tot - rolled[k], clip);
}

__global__ void lifted_bp_kernel(
    const float* __restrict__ llr, const float* __restrict__ mask,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    const int* __restrict__ row_ptr, const int* __restrict__ row_edges,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edges,
    float* __restrict__ out, float* __restrict__ msg, int n_rows,
    int n_cols, int n_edges, int z, int num_iter, float clip, float offset,
    int mode) {
  const int i = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;
  float* msg_b = msg + b * n_edges * z;
  const bool lane_ok = i < z;

  // Init: v2c = clip(llr) in CN alignment; marginals = llr (the
  // num_iter == 0 result).
  if (lane_ok) {
    for (int e = 0; e < n_edges; ++e) {
      int l = i + edge_shift[e];
      if (l >= z) l -= z;
      msg_b[e * z + i] = clampf(llr_b[edge_col[e] * z + l], clip);
    }
    for (int c = 0; c < n_cols; ++c) out_b[c * z + i] = llr_b[c * z + i];
  }
  __syncthreads();

  for (int it = 0; it < num_iter; ++it) {
    if (lane_ok) {
      for (int r = 0; r < n_rows; ++r) {
        const int e0 = row_ptr[r];
        cn_row(msg_b, mask, row_edges + e0, row_ptr[r + 1] - e0, z, i,
               clip, offset, mode);
      }
    }
    __syncthreads();
    if (lane_ok) {
      for (int c = 0; c < n_cols; ++c) {
        const int e0 = col_ptr[c];
        vn_col(msg_b, out_b, llr_b, col_edges + e0, edge_shift,
               col_ptr[c + 1] - e0, c, z, i, clip);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest row or column degree the kernel's local arrays hold.
int sionna_ldpc_max_degree() { return kMaxDegree; }

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr, out: [batch, n_cols * z]; mask, msg (scratch): [n_edges, z] and
// [batch, n_edges, z]; edge tables as described in the header. Launches
// on `stream` and returns cudaGetLastError().
int sionna_ldpc_lifted_bp(const float* llr, const float* mask,
                          const int* edge_col, const int* edge_shift,
                          const int* row_ptr, const int* row_edges,
                          const int* col_ptr, const int* col_edges,
                          float* out, float* msg, int batch, int n_rows,
                          int n_cols, int n_edges, int z, int num_iter,
                          float clip, float offset, int mode,
                          void* stream) {
  if (batch <= 0 || z <= 0 || z > 1024 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (z + 31) / 32 * 32;
  lifted_bp_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      llr, mask, edge_col, edge_shift, row_ptr, row_edges, col_ptr,
      col_edges, out, msg, n_rows, n_cols, n_edges, z, num_iter, clip,
      offset, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
