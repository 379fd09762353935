// 5G LDPC belief propagation in the lifted (block-circulant) domain.
//
// Replaces the Pallas kernel `_lifted_pallas_decode` in
// sionna_tpu/phy/fec/ldpc/decoding.py (with its check-node math in
// `_lifted_cn_phase`). It computes what that kernel computes: flooding BP
// over per-base-edge message blocks of Z lanes, with boxplus (tanh rule),
// min-sum or offset min-sum check nodes, every iteration inside one
// launch; with the kernel's knobs, the v2c state stored in bf16
// (`storage_dtype`) and the boxplus magnitude in the ratio form
// (`atanh_form="ratio"`).
//
// Design: one thread block per codeword, one thread per lane i < Z. The
// message state (CN alignment: lane i of base edge (r, c, s) links CN
// (r, i) with VN (c, (i + s) mod Z)) lives in device memory, in scratch
// buffers the caller allocates. A cyclic shift is an index (i + s) mod Z;
// nothing moves. The CN phase reads v2c and writes c2v, each thread only
// its own lane; the VN phase reads c2v and writes v2c at lane
// (j - s) mod Z of each edge of column c, a bijection over lanes; a block
// barrier separates the phases. With f32 storage v2c and c2v are one
// buffer, updated in place. With bf16 storage v2c is a bf16 buffer and
// c2v a second, f32 one: the Pallas kernel never rounds c2v (it goes from
// the CN phase to the VN phase in f32), so a single bf16 buffer would be
// wrong.
//
// What bounds it on an H100: device-memory traffic. Each iteration makes
// about four passes over the state (CN read + write, VN read + write): at
// the n = 12288 code (BG1, Z = 288, 210 base edges) and batch 2048 that is
// 2048 * 210 * 288 * 16 B = 2 GB per iteration in f32, far above the
// 50 MB L2; bf16 storage moves 12 B per edge lane instead of 16 (v2c
// read and written in 2 B, c2v in 4 B). This simple design does nothing
// more about it yet: it neither keeps the state in shared memory (one
// codeword's f32 state is 241,920 B at that code, above the 227 KB a
// block may use; 32,032 B at the n = 2048 code) nor splits rows across
// more threads.
//
// Numerics follow the plain version (LDPC5GLiftedBP.decode) operation by
// operation, in the same order: the check-node math and the bf16
// rounding are shared with the layered kernel in ldpc_cn.cuh, and no
// expression here has the a * b + c shape that nvcc would contract into
// an FMA.

#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace {

using sionna_ldpc::clampf;
using sionna_ldpc::kMaxDegree;
using sionna_ldpc::load_msg;
using sionna_ldpc::store_msg;

// One check-node row for lane i: reads the row's d v2c messages and
// writes their check-node update to c2v (the same buffer with f32
// storage). mode 0: boxplus; 1: (offset) min-sum.
template <class S, int kForm>
__device__ void cn_row(const S* v2c, float* c2v,
                       const float* __restrict__ mask,
                       const int* __restrict__ edges, int d, int z, int i,
                       float clip, float offset, int mode) {
  sionna_ldpc::cn_update<kForm>(
      [&](int k) { return load_msg(v2c + edges[k] * z + i); },
      [&](int k) { return mask[edges[k] * z + i]; },
      [&](int k, float m) { c2v[edges[k] * z + i] = m; }, d, clip, offset,
      mode);
}

// One variable-node column c for lane j: reads c2v, writes v2c.
template <class S>
__device__ void vn_col(const float* c2v, S* v2c, float* __restrict__ out,
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
    rolled[k] = c2v[lane[k]];
    tot = tot + rolled[k];
  }
  out[c * z + j] = clampf(tot, clip);
  for (int k = 0; k < d; ++k) {
    store_msg(v2c + lane[k], clampf(tot - rolled[k], clip));
  }
}

// S: v2c storage type (float or __nv_bfloat16); kForm: boxplus magnitude.
template <class S, int kForm>
__global__ void lifted_bp_kernel(
    const float* __restrict__ llr, const float* __restrict__ mask,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    const int* __restrict__ row_ptr, const int* __restrict__ row_edges,
    const int* __restrict__ col_ptr, const int* __restrict__ col_edges,
    float* __restrict__ out, S* v2c, float* c2v, int n_rows, int n_cols,
    int n_edges, int z, int num_iter, float clip, float offset, int mode) {
  const int i = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;
  S* v2c_b = v2c + b * n_edges * z;
  float* c2v_b = c2v + b * n_edges * z;
  const bool lane_ok = i < z;

  // Init: v2c = clip(llr) in CN alignment; marginals = llr (the
  // num_iter == 0 result).
  if (lane_ok) {
    for (int e = 0; e < n_edges; ++e) {
      int l = i + edge_shift[e];
      if (l >= z) l -= z;
      store_msg(v2c_b + e * z + i, clampf(llr_b[edge_col[e] * z + l], clip));
    }
    for (int c = 0; c < n_cols; ++c) out_b[c * z + i] = llr_b[c * z + i];
  }
  __syncthreads();

  for (int it = 0; it < num_iter; ++it) {
    if (lane_ok) {
      for (int r = 0; r < n_rows; ++r) {
        const int e0 = row_ptr[r];
        cn_row<S, kForm>(v2c_b, c2v_b, mask, row_edges + e0,
                         row_ptr[r + 1] - e0, z, i, clip, offset, mode);
      }
    }
    __syncthreads();
    if (lane_ok) {
      for (int c = 0; c < n_cols; ++c) {
        const int e0 = col_ptr[c];
        vn_col<S>(c2v_b, v2c_b, out_b, llr_b, col_edges + e0, edge_shift,
                  col_ptr[c + 1] - e0, c, z, i, clip);
      }
    }
    __syncthreads();
  }
}

template <class S, int kForm>
void launch(const float* llr, const float* mask, const int* edge_col,
            const int* edge_shift, const int* row_ptr, const int* row_edges,
            const int* col_ptr, const int* col_edges, float* out, S* v2c,
            float* c2v, int batch, int n_rows, int n_cols, int n_edges,
            int z, int num_iter, float clip, float offset, int mode,
            cudaStream_t stream) {
  const int threads = (z + 31) / 32 * 32;
  lifted_bp_kernel<S, kForm><<<batch, threads, 0, stream>>>(
      llr, mask, edge_col, edge_shift, row_ptr, row_edges, col_ptr,
      col_edges, out, v2c, c2v, n_rows, n_cols, n_edges, z, num_iter, clip,
      offset, mode);
}

}  // namespace

extern "C" {

// Largest row or column degree the kernel's local arrays hold.
int sionna_ldpc_max_degree() { return kMaxDegree; }

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr, out: [batch, n_cols * z]; mask: [n_edges, z]; v2c (scratch):
// [batch, n_edges, z] of float (bf16 == 0) or __nv_bfloat16 (bf16 == 1);
// c2v (scratch): [batch, n_edges, z] floats when bf16 == 1, ignored
// (may be null) when bf16 == 0; edge tables as described in the header.
// ratio == 1 selects the ratio form of the boxplus magnitude. Launches on
// `stream` and returns cudaGetLastError().
int sionna_ldpc_lifted_bp(const float* llr, const float* mask,
                          const int* edge_col, const int* edge_shift,
                          const int* row_ptr, const int* row_edges,
                          const int* col_ptr, const int* col_edges,
                          float* out, void* v2c, float* c2v, int batch,
                          int n_rows, int n_cols, int n_edges, int z,
                          int num_iter, float clip, float offset, int mode,
                          int bf16, int ratio, void* stream) {
  if (batch <= 0 || z <= 0 || z > 1024 || (mode != 0 && mode != 1) ||
      (bf16 != 0 && bf16 != 1) || (ratio != 0 && ratio != 1) ||
      v2c == nullptr || (bf16 && c2v == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto* v = static_cast<__nv_bfloat16*>(v2c);
    (ratio ? launch<__nv_bfloat16, sionna_ldpc::kRatio>
           : launch<__nv_bfloat16, sionna_ldpc::kLog1p>)(
        llr, mask, edge_col, edge_shift, row_ptr, row_edges, col_ptr,
        col_edges, out, v, c2v, batch, n_rows, n_cols, n_edges, z, num_iter,
        clip, offset, mode, s);
  } else {
    auto* v = static_cast<float*>(v2c);  // c2v shares the v2c buffer
    (ratio ? launch<float, sionna_ldpc::kRatio>
           : launch<float, sionna_ldpc::kLog1p>)(
        llr, mask, edge_col, edge_shift, row_ptr, row_edges, col_ptr,
        col_edges, out, v, v, batch, n_rows, n_cols, n_edges, z, num_iter,
        clip, offset, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
