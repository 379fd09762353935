// 5G LDPC belief propagation in the lifted domain, layered (serial-C)
// schedule (K3).
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
// posterior would break the marg/c2v bookkeeping. With bf16 storage
// c2v_old is the stored (rounded) value in both lines above, c2v the
// unrounded new one, and the store rounds it, as the Pallas kernel does.
//
// What bounds it on an H100: the check-node arithmetic (one tanhf and two
// log1pf per edge lane and iteration, as in the flooding kernel K1), the
// integer work around it, and the chain of rows: row r + 1 reads
// posterior lanes that row r wrote. The LLRs in and the marginals out are
// the only device-memory traffic the function needs; with c2v in device
// memory (the first design) each layered-10 call at n = 12288 x 2048
// moved 9.9 GB (f32), 2.96 ms at 3.35 TB/s, above the operation bound.
//
// Design: one codeword per thread block, or per thread-block cluster;
// `layered_bp_layout` in sionna_tpu_torch/phy/fec/ldpc/decoding.py plans
// the layout and the int32 plan this kernel copies into shared memory.
// The schedule's code is `decode` in ldpc_layered_bp.cuh, which the
// gradient's tape kernel K5Lf (ldpc_layered_bp_grad.cu) runs too.
// - Message state on chip for the whole launch: the posterior and every
//   c2v slot (f32 or bf16) live in shared memory; the LLRs are read once
//   and the marginals written once.
// - Cluster layout, split by lanes: where one block's 232,448 B cannot
//   hold the state (f32 at the n = 12288 code: 294,912 B; BG1 at
//   Z = 384), a cluster of 2-8 blocks shares the codeword. Block b owns
//   lanes [b L, b L + L) of every c2v slot (c2v[e][i] is touched only by
//   lane i's work, so c2v stays local) and holds a replica of the whole
//   posterior, which it reads locally. Each posterior lane it updates it
//   also pushes to the other blocks' replicas with `st.async`, whose
//   bytes the receiving block's mbarrier counts; a block starts the next
//   row step once its mbarrier has counted the other blocks' d x (Z - L)
//   lanes of the step. Steps alternate between two mbarriers: a block
//   can run at most one step ahead of another (it waits for the other's
//   pushes of the step before), so its pushes of step s + 1 land on the
//   mbarrier that step s does not use. No cluster barrier runs between
//   steps: its release compiles to a GPU-scope fence (MEMBAR.ALL.GPU) in
//   every thread, on every step's critical path. Each thread maps every
//   block's posterior and mbarrier address once, into registers, and
//   pushes in a loop unrolled over the cluster variant's most blocks:
//   clusters of 2-4 blocks take the variant of 4, those of 5-8 (only
//   the largest codes in f32) that of 8. One variant of 8 for all cost
//   the 2- and 3-block clusters 7-8 %, a `mapa` per push 5-7 %.
// - Row steps: consecutive rows that share no column run as one step (the
//   n = 12288 code's 24 rows take 21 steps); that is exact, the rows'
//   updates touching disjoint posterior columns.
// - Every thread on a step's work, m threads per lane (m * L threads), each
//   on one lane throughout, in three phases per step:
//   A. the (edge, lane) items, all threads: v2c, its check-node input
//      tanh(|v2c|/2) or |v2c| with the sign in the sign bit, into a
//      [d][L] scratch;
//   B. per (row, lane), one thread each: the prefix and suffix products
//      (or the two minima) of the row in registers (a switch over the
//      templated row degrees of ldpc_cn.cuh, shared with K1), each edge's
//      clamped extrinsic with its sign back into the scratch;
//   C. the items again, all threads: the magnitude (two log1pf), the new
//      c2v, the posterior update (and push) and the c2v store.
//   Three block barriers per step (63 per iteration at 21 steps; in a
//   cluster the third is followed by the mbarrier wait). Phase B leaves
//   all but L threads idle on one-row steps, but holds no transcendental
//   function. Two items in flight per thread ran slower than one.
// - No local memory: phase B's per-edge values are registers of the
//   degree's case; A and C hold one item at a time.
// - Tables read once: per row step its rows, per edge a 16-byte record
//   (read with one shared load per edge lane) of its column and shift,
//   folded into a posterior offset and a wrap point, and its cyclic
//   active-lane range (the plain version's masks), in shared memory.
//
// Numerics follow the plain version operation by operation (check-node
// math and bf16 rounding shared with the flooding kernel in ldpc_cn.cuh;
// no expression with the a * b + c shape), so the two agree bit for bit.
// The sign carried in the scratch's sign bit is the product of +-1
// factors, which is exact in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ldpc_layered_bp.cuh"

namespace {

namespace ly = sionna_ldpc::layered;

// S: c2v storage type (float or __nv_bfloat16); kBlocks: 1, or the
// cluster layout for clusters of up to kBlocks blocks
// (ldpc_layered_bp.cuh's decode, without the tapes).
template <class S, int kBlocks>
__global__ void __launch_bounds__(ly::kMaxThreads, 1)
layered_bp_kernel(const float* __restrict__ llr, const int* __restrict__ plan,
                  float* __restrict__ out, int n_steps, int n_cols,
                  int n_edges, int z, int lanes, int step_degree,
                  int plan_len, int num_iter, float clip, float offset,
                  int mode) {
  ly::decode<S, kBlocks, false>(llr, plan, out, ly::Tapes{nullptr, nullptr, 0},
                                n_steps, n_cols, n_edges, z, lanes,
                                step_degree, plan_len, num_iter, clip, offset,
                                mode);
}

// The variant of `cluster` blocks per codeword: one block, or the cluster
// layout of up to kSmallCluster or kMaxCluster blocks.
template <class S>
cudaError_t launch_variant(int cluster, const float* llr, const int* plan,
                           float* out, int batch, int n_steps, int n_cols,
                           int n_edges, int z, int lanes, int step_degree,
                           int plan_len, int num_iter, float clip,
                           float offset, int mode, int threads,
                           cudaStream_t stream) {
  return sionna_ldpc::launch_per_codeword(
      cluster == 1                   ? layered_bp_kernel<S, 1>
      : cluster <= ly::kSmallCluster ? layered_bp_kernel<S, ly::kSmallCluster>
                                     : layered_bp_kernel<S, ly::kMaxCluster>,
      cluster > 1, batch, cluster, threads,
      ly::smem_bytes<S>(n_cols, n_edges, z, lanes, step_degree, plan_len),
      stream, llr, plan, out, n_steps, n_cols, n_edges, z, lanes,
      step_degree, plan_len, num_iter, clip, offset, mode);
}

}  // namespace

extern "C" {

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llr, out: [batch, n_cols * z] floats (CUDA); plan: the int32 plan of
// `layered_bp_layout` (plan_len ints, on the card) with its n_steps row
// steps; lanes per block, the edges of the largest step, threads per
// block (a multiple of lanes) and cluster blocks per codeword as the
// layout gives them. bf16 == 1 stores c2v in bf16; mode 0 boxplus, 1
// (offset) min-sum. Launches on `stream` and returns the CUDA error code
// (0 on success).
int sionna_ldpc_layered_bp(const float* llr, const int* plan, float* out,
                           int batch, int n_steps, int n_cols, int n_edges,
                           int z, int lanes, int step_degree, int plan_len,
                           int num_iter, float clip, float offset, int mode,
                           int bf16, int threads, int cluster,
                           void* stream) {
  if (ly::bad_layout(batch, n_cols, z, lanes, num_iter, mode, threads,
                     cluster, step_degree, plan_len) ||
      (bf16 != 0 && bf16 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      (bf16 ? launch_variant<__nv_bfloat16> : launch_variant<float>)(
          cluster, llr, plan, out, batch, n_steps, n_cols, n_edges, z, lanes,
          step_degree, plan_len, num_iter, clip, offset, mode, threads, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
