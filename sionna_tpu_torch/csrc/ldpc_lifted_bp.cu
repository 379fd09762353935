// 5G LDPC belief propagation in the lifted (block-circulant) domain,
// flooding schedule (K1).
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
// What bounds it on an H100: the check-node arithmetic. Per edge lane and
// iteration a boxplus update costs one tanhf and two log1pf (or one logf
// and an IEEE division) besides a handful of multiplies, clamps and adds;
// the LLRs in and the marginals out are the only device-memory traffic
// the function needs (0.2 GB per call at n = 12288 x 2048, against 40 GB
// of message traffic per BP-20 call if the state lived in device
// memory).
//
// Design: one codeword per thread block (or per thread-block cluster, see
// the layouts), the whole message state on chip for the whole launch. The
// schedule's code is `decode` in ldpc_lifted_bp.cuh, which the gradient's
// tape kernel K5f (ldpc_lifted_bp_grad.cu) runs too.
// - One 4-byte slot per edge lane (CN alignment: lane l of base edge
//   (r, c, s) links CN (r, l) with VN (c, (l + s) mod Z)) serves v2c and
//   c2v: in flooding an edge lane's v2c is dead once its CN has read it,
//   so the CN phase overwrites it with c2v, and the VN phase overwrites
//   c2v with the next v2c. With bf16 storage the slot holds the
//   bf16-rounded v2c widened to f32, then the unrounded f32 c2v: what the
//   plain version computes (it rounds v2c on store, never c2v).
// - Register edges: for each base row, its first edge whose column has
//   degree 1 (the 5G extension columns). Lane l of such an edge is touched
//   only by CN (r, l) and by VN (c, (l + s) mod Z), so the thread that owns
//   CN unit (r, l) keeps the slot in a register for the whole launch and
//   does that column's VN update right after the CN update. At the
//   n = 12288 code this takes 20 of 210 base edges out of shared memory:
//   190 x 288 x 4 = 218,880 B remain, below the 232,448 B a block may use.
// - Layouts (chosen by `lifted_bp_layout` in
//   sionna_tpu_torch/phy/fec/ldpc/decoding.py, which builds the plan this
//   kernel reads): cluster size 1, every shared slot in the block's own
//   shared memory; or a cluster of 2-8 blocks per codeword when the
//   shared slots do not fit one block (BG1 at Z = 384 needs 2): the
//   shared-memory edges are split into contiguous groups, one per block,
//   and every slot access goes through distributed shared memory
//   (`map_shared_rank`); the CN and VN units are spread over all threads
//   of the cluster, and `cluster.sync()` replaces the block barrier. What
//   crosses blocks is exactly the slots of edges another block owns.
// - All threads on one phase at a time: the (row, lane) CN units, then the
//   (column, lane) VN units of the columns without a register edge,
//   strided over the threads with consecutive lanes on consecutive threads
//   (conflict-free shared-memory access); a barrier between the phases.
// - No local-memory arrays: the CN update is specialised on the row
//   degree (a switch over templated degrees: those of the 5G base graphs'
//   rows, 3-10 and 19, and 1-2), so its per-edge values live in
//   registers; a single copy unrolled over 19 positions and guarded by
//   the degree put them in a 152 B stack frame and ran 1.8x slower. The
//   VN phase rereads its slots instead of keeping them; the register
//   edges' slots are a 12-entry register array (8 in a cluster, whose
//   64-bit slot addresses take more registers) read and written through
//   compile-time selects.
// - Tables read once: the plan (per-row slot ids and cyclic active-lane
//   ranges, per-column slot ids and shifts, row and column lists) is
//   copied into shared memory when the block starts. The per-lane masks
//   of the plain version become one cyclic range of active lanes per edge.
//   The marginals are written once, in the last iteration; the
//   num_iter == 0 result is the LLRs.
//
// Numerics follow the plain version (LDPC5GLiftedBP.decode) operation by
// operation, in the same order: the check-node products from the front
// and the back, the clamp at 1 - 1e-7, the sign product, the VN sum
// llr + c2v[e0] + c2v[e1] + ... in column order; tanhf/log1pf/logf
// without fast math, IEEE division, and no expression with the
// a * b + c shape that nvcc would contract into an FMA.

#include <cuda_runtime.h>

#include "ldpc_lifted_bp.cuh"

namespace {

namespace fl = sionna_ldpc::flooding;

// kRound: bf16 v2c storage; kForm: boxplus magnitude; kMulti: cluster
// layout (ldpc_lifted_bp.cuh's decode, without the tape).
template <bool kRound, int kForm, bool kMulti>
__global__ void __launch_bounds__(fl::kMaxThreads, 1)
lifted_bp_kernel(const float* __restrict__ llr, const int* __restrict__ plan,
                 float* __restrict__ out, int n_cols, int z, int n_reg_rows,
                 int n_plain_rows, int n_vn_cols, int state_floats,
                 int plan_len, int num_iter, float clip, float offset,
                 int mode) {
  fl::decode<kRound, kForm, kMulti, false>(
      llr, plan, out, fl::TapeRows{nullptr, 0, 0}, n_cols, z, n_reg_rows,
      n_plain_rows, n_vn_cols, state_floats, plan_len, num_iter, clip,
      offset, mode);
}

template <bool kRound, int kForm>
cudaError_t launch_layout(int cluster, const float* llr, const int* plan,
                          float* out, int batch, int n_cols, int z,
                          int n_reg_rows, int n_plain_rows, int n_vn_cols,
                          int state_floats, int plan_len, int num_iter,
                          float clip, float offset, int mode, int threads,
                          cudaStream_t stream) {
  return sionna_ldpc::launch_per_codeword(
      cluster > 1 ? lifted_bp_kernel<kRound, kForm, true>
                  : lifted_bp_kernel<kRound, kForm, false>,
      cluster > 1, batch, cluster, threads,
      fl::smem_bytes(state_floats, plan_len), stream, llr, plan, out,
      n_cols, z, n_reg_rows, n_plain_rows, n_vn_cols, state_floats,
      plan_len, num_iter, clip, offset, mode);
}

}  // namespace

extern "C" {

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr, out: [batch, n_cols * z] floats (CUDA); plan: the int32 plan of
// `lifted_bp_layout` (plan_len ints, on the card), whose shared slots need
// state_floats floats per block; threads per block and cluster blocks per
// codeword as the plan was made for. bf16 == 1 rounds the stored v2c to
// bf16; ratio == 1 selects the ratio form of the boxplus magnitude; mode 0
// boxplus, 1 (offset) min-sum. Launches on `stream` and returns the CUDA
// error code (0 on success).
int sionna_ldpc_lifted_bp(const float* llr, const int* plan, float* out,
                          int batch, int n_cols, int z, int n_reg_rows,
                          int n_plain_rows, int n_vn_cols, int state_floats,
                          int plan_len, int num_iter, float clip,
                          float offset, int mode, int bf16, int ratio,
                          int threads, int cluster, void* stream) {
  if (fl::bad_layout(batch, z, n_reg_rows, num_iter, mode, threads, cluster,
                     plan_len) ||
      (bf16 != 0 && bf16 != 1) || (ratio != 0 && ratio != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = (ratio ? launch_layout<true, sionna_ldpc::kRatio>
                 : launch_layout<true, sionna_ldpc::kLog1p>)(
        cluster, llr, plan, out, batch, n_cols, z, n_reg_rows, n_plain_rows,
        n_vn_cols, state_floats, plan_len, num_iter, clip, offset, mode,
        threads, s);
  } else {
    err = (ratio ? launch_layout<false, sionna_ldpc::kRatio>
                 : launch_layout<false, sionna_ldpc::kLog1p>)(
        cluster, llr, plan, out, batch, n_cols, z, n_reg_rows, n_plain_rows,
        n_vn_cols, state_floats, plan_len, num_iter, clip, offset, mode,
        threads, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
