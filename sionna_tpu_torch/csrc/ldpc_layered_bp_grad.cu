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
// - K5Lf is K3 (ldpc_layered_bp.cu) with its tapes: it runs K3's code,
//   `decode` of ldpc_layered_bp.cuh, in K3's f32 layout and plan
//   (`layered_bp_layout`), so its marginals are K3's bit for bit, and
//   stores each iteration's starting posterior (tape_m [T, C, B, Z]) and
//   c2v (tape_c [T, E, B, Z]).
// - K5Lb walks the iterations backwards. In iteration t it replays the
//   row sweep from the tape into the posterior, keeping every edge's v2c;
//   then walks the rows backwards: with gP = dL/dpost and gC = dL/dc2v,
//   per edge gN = gC + gP[(i + s) mod Z] is dL/dc2v_new, cn_adjoint gives
//   gV = dL/dv2c, and gP[(i + s) mod Z] += gV, gC = -gP_before - gV.
//   After iteration 0, dL/dllr is gP (the posterior starts at the LLRs).
//
// What bounds K5Lf on an H100: K3's check-node arithmetic and its chain
// of row steps (1.76 ms of operations at n = 12288 x 2048 layered-10)
// against the tapes written once (6.04 GB there, 1.80 ms at 3.35 TB/s).
// Its first design ran one thread per lane, one row at a time with a
// block barrier after each, the posterior in the output in device memory,
// and read each row's c2v_old back from the tape row it wrote an
// iteration before. Now the state stays on chip as in K3 (the posterior
// and every c2v slot in shared memory, row steps in phases A/B/C with m
// threads per lane, a cluster splitting the lanes where one block is too
// small), and the tapes are side stores that are never read back:
// - tape_c[t]: phase A of iteration t reads each (edge, lane) item's
//   c2v_old from its slot, whose index is the edge's row position, and
//   stores it there (tape_c[0] gets the zeros the slots start with);
// - tape_m[t]: when iteration t starts, each block stores its own lane
//   run of every column from its replica of the posterior, which is whole
//   once the last step's mbarrier wait has passed. In a cluster a block
//   may run one step ahead and push the first step's lanes into the
//   replica being stored, so the blocks meet at a cluster barrier after
//   the stores: one per iteration.
// Each tape element is stored once, by the block that owns its lane, with
// streaming stores (write-once data, read only by K5Lb).
//
// What bounds K5Lb on an H100: the check-node arithmetic (a forward in the
// replay, a forward, a division and the adjoint in the walk: 95 + 95 + 12
// + 24 FP32 operations per edge lane and iteration, against one read of
// the tapes, T x (E + C) x B x Z x 4 bytes: 6.04 GB at n = 12288 x 2048
// layered-10) and, above both, the chain of rows: each row step reads
// posterior (or dL/dpost) lanes that the step before wrote.
//
// K5Lb's design is K3's (`layered_grad_layout` in lifted_grad.py plans it;
// the int32 plan is K3's, `_layered_bp_plan`), one block per codeword:
// - The replayed posterior and dL/dpost live in shared memory for the whole
//   launch; the tapes are read once (the starting posterior when an
//   iteration begins, each row's c2v_old in the replay) and dL/dllr is
//   written once.
// - Row steps: consecutive rows that share no column run as one step, in
//   order in the replay and in reverse in the walk (exact: their updates
//   touch disjoint posterior columns); one block barrier per step.
// - Threads: m per lane (m the most rows of a step), each on one lane
//   throughout, a (row, lane) unit of the step each; the unit's check node
//   and adjoint keep their per-edge values in registers (a switch over the
//   row degrees).
// - What sets the speed is the lanes in flight on an SM: the walk is a
//   chain of dependent row steps (21 for the 24 rows of n = 12288), each a
//   few hundred operations of one thread per lane, with nothing else to
//   hide its latency. So the launch bound asks for two blocks of 384
//   threads an SM (80 registers a thread; the degree-19 adjoint spills
//   about 1.5 KB to L1); v2c (written in the replay, read in the walk)
//   lives in device memory ([B, E, Z], coalesced per edge), and dL/dc2v
//   (carried between iterations, taken as 0 in the first iteration walked,
//   so its buffer needs no clearing) in shared memory only where that
//   keeps as many blocks resident on an SM as device memory does (small
//   codes: not the link, not n = 12288). Measured on an H100 (PERF.md,
//   Findings): 80 registers against 168, 4.60 against 6.24 ms at the
//   n = 2048 x 2000 link and 37.2 against 54.3 at n = 12288 x 2048 (56
//   registers: 4.70, 44.4); at 80 registers v2c and dL/dc2v both on chip
//   7.56 ms at the link (2 blocks an SM), dL/dc2v on chip 5.72 (4), both
//   in device memory 4.59 (6 blocks); at n = 12288, where they do not fit
//   one block, K3's cluster split of the lanes (replicas of the posterior
//   and dL/dpost pushed by `st.async`) took 189.9 ms with both on chip (4
//   blocks of 72 lanes) and 114.1 with dL/dc2v on chip (2 of 144), against
//   37.2 in one block of 288 lanes with both in device memory. So no
//   cluster: 4 E Z x 4 B of v2c and dL/dc2v per codeword and iteration in
//   device memory (19.8 GB per layered-10 call at n = 12288, besides the
//   tapes' 6.04 GB, much of it L2 hits).
// Numerics: each element is updated by the same expressions, in the same
// order, wherever dL/dc2v lives (the rows of a step touch disjoint
// elements), with the check node and adjoint of ldpc_cn_grad.cuh; no
// atomics.

#include <cuda_runtime.h>

#include "ldpc_cn_grad.cuh"
#include "ldpc_layered_bp.cuh"

namespace {

namespace ly = sionna_ldpc::layered;
using ly::edge_active;
using ly::post_index;
using sionna_ldpc::cn_adjoint;
using sionna_ldpc::cn_forward;
using sionna_ldpc::with_degree;

// K5Lf: K3's decode with the tapes, in K3's f32 layout. tape_m: [num_iter,
// n_cols, batch, z]; tape_c: [num_iter, n_edges, batch, z].
template <int kBlocks>
__global__ void __launch_bounds__(ly::kMaxThreads, 1)
layered_tape_kernel(const float* __restrict__ llr,
                    const int* __restrict__ plan, float* __restrict__ out,
                    ly::Tapes tapes, int n_steps, int n_cols, int n_edges,
                    int z, int lanes, int step_degree, int plan_len,
                    int num_iter, float clip, float offset, int mode) {
  ly::decode<float, kBlocks, true>(llr, plan, out, tapes, n_steps, n_cols,
                                   n_edges, z, lanes, step_degree, plan_len,
                                   num_iter, clip, offset, mode);
}

// K5Lb's layout limits, from lifted_grad.py (K5LB_MAX_THREADS, ...). Its
// plan is K3's (ly::kEdge, ...): one int4 edge record per row position p,
// which is also the edge's index in the tapes.
#if !defined(SIONNA_K5LB_MAX_THREADS) || !defined(SIONNA_K5LB_MIN_BLOCKS)
#error "build with the defines of LAYERED_BP_GRAD_KERNEL (lifted_grad.py)"
#endif
constexpr int kLbMaxThreads = SIONNA_K5LB_MAX_THREADS;
constexpr int kLbMinBlocks = SIONNA_K5LB_MIN_BLOCKS;  // per SM

// K5Lb. llr (unused: the tape holds the posterior), g_marg, g_llr: [B, C *
// z] (padded: 0 beyond the code's VNs); tape_m: [T, C, B, z]; tape_c: [T, E,
// B, z]; v2c: [B, E, z]; g_c2v: [B, E, z], or null when dL/dc2v lives in
// shared memory (neither is read before it is written). One block of m z
// threads per codeword. Dynamic shared memory: the plan's plan_len ints,
// the posterior and dL/dpost [n_cols][z] f32 each, then [n_edges][z] f32
// of dL/dc2v when g_c2v is null.
__global__ void __launch_bounds__(kLbMaxThreads, kLbMinBlocks)
layered_reverse_kernel(const float* __restrict__ llr,
                       const int* __restrict__ plan,
                       const float* __restrict__ g_marg,
                       const float* __restrict__ tape_m,
                       const float* __restrict__ tape_c,
                       float* __restrict__ g_llr, float* __restrict__ v2c,
                       float* __restrict__ g_c2v, int batch, int n_steps,
                       int n_cols, int n_edges, int z, int plan_len,
                       int num_iter, float clip, float offset, int mode) {
  extern __shared__ int4 smem_v[];  // 16-byte aligned: the plan's int4s
  const size_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const float* gm_b = g_marg + b * n_cols * z;
  float* gl_b = g_llr + b * n_cols * z;
  if (num_iter == 0) {
    for (int u = t; u < n_cols * z; u += nt) gl_b[u] = gm_b[u];
    return;
  }
  int* tab = reinterpret_cast<int*>(smem_v);
  float* post = reinterpret_cast<float*>(tab + plan_len);
  float* gp = post + n_cols * z;  // dL/dpost
  for (int u = t; u < plan_len; u += nt) tab[u] = plan[u];
  for (int u = t; u < n_cols * z; u += nt) gp[u] = gm_b[u];
  __syncthreads();
  const int4* edge = reinterpret_cast<const int4*>(tab + tab[ly::kEdge]);
  const int* step_ptr = tab + tab[ly::kStepPtr];
  const int* row_ptr = tab + tab[ly::kRowPtr];
  // Thread t works on lane i = t mod z throughout, on the rows t / z, + m,
  // ... of each step.
  const int m = nt / z;  // the host launches m * z threads
  const int j0 = t / z;
  const int i = t - j0 * z;
  const bool on = j0 < m;
  const size_t estride = static_cast<size_t>(batch) * z;
  // row position p of lane i: dL/dc2v at gc_i[p * z], in shared or in
  // device memory; v2c at v2c_i[p * z]
  float* gc_i = (g_c2v ? g_c2v + b * n_edges * z : gp + n_cols * z) + i;
  float* v2c_i = v2c + b * n_edges * z + i;
  for (int it = num_iter - 1; it >= 0; --it) {
    // the posterior at the iteration's start
    const float* tm = tape_m + static_cast<size_t>(it) * n_cols * estride +
                      b * z;
    for (int u = t; u < n_cols * z; u += nt) {
      const int c = u / z;
      post[u] = tm[c * estride + (u - c * z)];
    }
    __syncthreads();
    const float* c_old = tape_c + static_cast<size_t>(it) * n_edges * estride
                         + b * z + i;
    // the replay: each row of a step from the posterior and the tape's
    // c2v_old, keeping its v2c
    for (int s = 0; s < n_steps; ++s) {
      if (on) {
        for (int r = step_ptr[s] + j0; r < step_ptr[s + 1]; r += m) {
          const int q = row_ptr[r];
          with_degree(row_ptr[r + 1] - q, [&](auto dc) {
            constexpr int D = decltype(dc)::value;
            float mv[D], old[D], out[D];
            unsigned act = 0;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const int4 rec = edge[q + k];
              old[k] = c_old[(q + k) * estride];
              mv[k] = post[post_index(rec, i, z)] - old[k];
              v2c_i[(q + k) * z] = mv[k];
              if (edge_active(rec, i, z)) act |= 1u << k;
            }
            cn_forward<D>(mv, act, clip, offset, mode, out);
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const int j = post_index(edge[q + k], i, z);
              post[j] = post[j] + (out[k] - old[k]);
            }
          });
        }
      }
      __syncthreads();
    }
    // the walk: the steps backwards, each row's posterior update, check
    // node and v2c subtraction reversed; dL/dc2v is 0 before the first
    // iteration walked (the last one run)
    const bool first = it == num_iter - 1;
    for (int s = n_steps - 1; s >= 0; --s) {
      if (on) {
        for (int r = step_ptr[s] + j0; r < step_ptr[s + 1]; r += m) {
          const int q = row_ptr[r];
          with_degree(row_ptr[r + 1] - q, [&](auto dc) {
            constexpr int D = decltype(dc)::value;
            float mv[D], g[D], gpb[D];
            unsigned act = 0;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const int4 rec = edge[q + k];
              gpb[k] = gp[post_index(rec, i, z)];
              g[k] = (first ? 0.f : gc_i[(q + k) * z]) + gpb[k];
              mv[k] = v2c_i[(q + k) * z];
              if (edge_active(rec, i, z)) act |= 1u << k;
            }
            cn_adjoint<D>(mv, g, act, clip, offset, mode);
#pragma unroll
            for (int k = 0; k < D; ++k) {
              gp[post_index(edge[q + k], i, z)] = gpb[k] + g[k];
              gc_i[(q + k) * z] = -gpb[k] - g[k];
            }
          });
        }
      }
      __syncthreads();
    }
  }
  for (int u = t; u < n_cols * z; u += nt) gl_b[u] = gp[u];
}

}  // namespace

extern "C" {

// K5Lf. llr, out: [batch, n_cols * z] f32 (CUDA); plan: the int32 plan of
// `layered_bp_layout` (K3's; plan_len ints, on the card) with its n_steps
// row steps, edges numbered row by row; lanes per block, the edges of the
// largest step, threads per block and cluster blocks per codeword as the
// f32 layout gives them; tape_m: [num_iter, n_cols, batch, z]; tape_c:
// [num_iter, n_edges, batch, z]. mode 0 boxplus, 1 (offset) min-sum.
// Launches on `stream`; returns the CUDA error code.
int sionna_ldpc_layered_tape(const float* llr, const int* plan, float* out,
                             float* tape_m, float* tape_c, int batch,
                             int n_steps, int n_cols, int n_edges, int z,
                             int lanes, int step_degree, int plan_len,
                             int num_iter, float clip, float offset,
                             int mode, int threads, int cluster,
                             void* stream) {
  if (ly::bad_layout(batch, n_cols, z, lanes, num_iter, mode, threads,
                     cluster, step_degree, plan_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = sionna_ldpc::launch_per_codeword(
      cluster == 1                   ? layered_tape_kernel<1>
      : cluster <= ly::kSmallCluster ? layered_tape_kernel<ly::kSmallCluster>
                                     : layered_tape_kernel<ly::kMaxCluster>,
      cluster > 1, batch, cluster, threads,
      ly::smem_bytes<float>(n_cols, n_edges, z, lanes, step_degree,
                            plan_len),
      static_cast<cudaStream_t>(stream), llr, plan, out,
      ly::Tapes{tape_m, tape_c, static_cast<size_t>(batch) * z}, n_steps,
      n_cols, n_edges, z, lanes, step_degree, plan_len, num_iter, clip,
      offset, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K5Lb. g_marg, g_llr: [batch, n_cols * z]; the tapes as K5Lf wrote them;
// plan: the int32 plan of `layered_grad_layout` (plan_len ints, on the
// card) with its n_steps row steps; v2c: [batch, n_edges, z] scratch;
// g_c2v: [batch, n_edges, z] scratch, or null for dL/dc2v in shared
// memory; threads per block (a multiple of z) as the layout gives them.
// Other arguments as K5Lf's.
int sionna_ldpc_layered_reverse(const float* llr, const int* plan,
                                const float* g_marg, const float* tape_m,
                                const float* tape_c, float* g_llr, float* v2c,
                                float* g_c2v, int batch, int n_steps,
                                int n_cols, int n_edges, int z, int plan_len,
                                int num_iter, float clip, float offset,
                                int mode, int threads, void* stream) {
  if (batch <= 0 || n_steps <= 0 || n_cols <= 0 || n_edges <= 0 || z <= 0 ||
      num_iter < 0 || (mode != 0 && mode != 1) || threads <= 0 ||
      threads > kLbMaxThreads || threads % z != 0 || !v2c ||
      plan_len < ly::kHeader) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(plan_len) + 2 * static_cast<size_t>(n_cols) * z +
       (g_c2v ? 0 : static_cast<size_t>(n_edges) * z)) *
      4;
  // the opt-in shared memory, set once per layout that needs more
  static size_t opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        layered_reverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  layered_reverse_kernel<<<batch, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      llr, plan, g_marg, tape_m, tape_c, g_llr, v2c, g_c2v, batch, n_steps,
      n_cols, n_edges, z, plan_len, num_iter, clip, offset, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
