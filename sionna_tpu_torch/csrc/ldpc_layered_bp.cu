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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace cg = cooperative_groups;

namespace {

using sionna_ldpc::load_msg;
using sionna_ldpc::store_msg;

// The layout limits come from sionna_tpu_torch/phy/fec/ldpc/decoding.py
// (K3_MAX_THREADS, ...), their one source, as defines on nvcc's command
// line.
#if !defined(SIONNA_K3_MAX_THREADS) || !defined(SIONNA_K3_MAX_CLUSTER) || \
    !defined(SIONNA_K3_PLAN_ARRAYS)
#error "build with the defines of LAYERED_BP_KERNEL (see _build.py)"
#endif
constexpr int kMaxThreads = SIONNA_K3_MAX_THREADS;  // threads per block
constexpr int kMaxCluster = SIONNA_K3_MAX_CLUSTER;  // blocks per codeword
constexpr int kSmallCluster = 4;  // the most blocks of the smaller variant
static_assert(kMaxCluster > kSmallCluster, "K3_MAX_CLUSTER must exceed 4");

// Header of the plan: offsets (in ints, multiples of 4) of its arrays, in
// the order of K3_PLAN_ARRAYS. The edge records, one int4 per row
// position p (rows in order, edges in row order; p is also the edge's c2v
// slot): column * z + shift, z - shift, and the cyclic active-lane range
// (lo, length).
enum { kEdge, kStepPtr, kRowPtr, kHeader };
static_assert(kHeader == SIONNA_K3_PLAN_ARRAYS,
              "the plan's arrays differ from K3_PLAN_ARRAYS");

// 32-bit shared::cta address of a shared-memory pointer, and the
// shared::cluster address of the same offset in block `rank`.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned map_rank(unsigned a, int rank) {
  unsigned out;  // a pure function of its inputs: not volatile, hoistable
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// Cluster layout: writes v into another block's shared memory (remote
// address) and counts its 4 bytes on that block's mbarrier.
__device__ __forceinline__ void push(unsigned remote, float v,
                                     unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(remote),
      "f"(v), "r"(remote_bar)
      : "memory");
}

// Cluster barrier: relaxed arrive, acquiring wait (after the mbarrier's
// init fence, and once before exit).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Waits for the phase of parity `parity` of the mbarrier at `bar` to
// complete, acquiring at cluster scope what the other blocks pushed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT_%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// An edge's input to its check node, from its v2c message m: tanh(|m|/2)
// (mode 0, boxplus) or |m| (mode 1, min-sum); an inactive lane reads as
// the neutral value (1, or 1e30).
__device__ __forceinline__ float cn_input(float m, bool active, int mode) {
  const float v = mode == 0 ? tanhf(fabsf(m) / 2.f) : fabsf(m);
  return active ? v : (mode == 0 ? 1.f : 1e30f);
}

// Phase B for one lane of a row of degree D: reads the D signed inputs at
// x[k * stride], writes each edge's clamped extrinsic (boxplus) or (offset)
// min-sum magnitude, carrying the sign sign_tot * sign_k in its sign bit.
template <int D>
__device__ __forceinline__ void cn_lane(float* x, int stride, float offset,
                                        int mode) {
  float val[D];
  unsigned neg = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float v = x[k * stride];
    val[k] = fabsf(v);
    if (signbit(v)) neg |= 1u << k;
  }
  const unsigned tot = __popc(neg) & 1u;
  sionna_ldpc::cn_extrinsic<D, sionna_ldpc::kProduct>(
      val, mode, offset, [&](int k, float e) {
        x[k * stride] = ((tot ^ (neg >> k)) & 1u) ? -e : e;
      });
}

__device__ __forceinline__ void cn_lane_dispatch(int d, float* x, int stride,
                                                 float offset, int mode) {
  switch (d) {
#define SIONNA_CN_CASE(D)                \
  case D:                                \
    cn_lane<D>(x, stride, offset, mode); \
    return;
    SIONNA_CN_DEGREES(SIONNA_CN_CASE)
#undef SIONNA_CN_CASE
    default:
      return;  // the host refuses a code with any other degree
  }
}

// Posterior index of lane gi's item on an edge (record rec: column * z +
// shift, z - shift, lo, length), column * z + (gi + shift) mod z, and
// whether lane gi of the edge is active ((gi - lo) mod z < length).
__device__ __forceinline__ int post_index(int4 rec, int gi, int z) {
  return rec.x + gi - (gi >= rec.y ? z : 0);
}
__device__ __forceinline__ bool edge_active(int4 rec, int gi, int z) {
  return gi - rec.z + (gi < rec.z ? z : 0) < rec.w;
}

// S: c2v storage type (float or __nv_bfloat16); kBlocks: 1, or the cluster
// layout for clusters of up to kBlocks blocks, block b of the cluster
// owning lanes [b lanes, b lanes + lanes) of the c2v slots and a replica
// of the whole posterior. Dynamic shared memory: two mbarriers (16 B),
// the plan's plan_len ints, the posterior [n_cols][z] f32, the scratch
// [step_degree][lanes] f32, c2v [n_edges][lanes] of S.
template <class S, int kBlocks>
__global__ void __launch_bounds__(kMaxThreads, 1)
layered_bp_kernel(const float* __restrict__ llr, const int* __restrict__ plan,
                  float* __restrict__ out, int n_steps, int n_cols,
                  int n_edges, int z, int lanes, int step_degree,
                  int plan_len, int num_iter, float clip, float offset,
                  int mode) {
  constexpr bool kMulti = kBlocks > 1;
  extern __shared__ unsigned long long smem[];
  int rank = 0;
  int n_blocks = 1;
  size_t b = blockIdx.x;
  if constexpr (kMulti) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    n_blocks = static_cast<int>(cluster.num_blocks());
    b = blockIdx.x / n_blocks;
  }
  const int lo = rank * lanes;        // first lane this block owns
  const int nb = min(lanes, z - lo);  // lanes it owns
  unsigned long long* bar = smem;  // two mbarriers, by step parity
  int* tab = reinterpret_cast<int*>(smem + 2);  // 16-byte aligned
  float* post = reinterpret_cast<float*>(tab + plan_len);
  float* scratch = post + n_cols * z;
  S* c2v = reinterpret_cast<S*>(scratch + step_degree * lanes);
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;
  const unsigned bar_a = smem_addr(bar);
  // cluster: every block's posterior and mbarrier in the shared::cluster
  // window (a block's shared memory is one contiguous run there)
  unsigned remote_post[kBlocks], remote_bar[kBlocks];
  if constexpr (kMulti) {
#pragma unroll
    for (int r = 0; r < kBlocks; ++r) {
      remote_post[r] = r < n_blocks ? map_rank(smem_addr(post), r) : 0u;
      remote_bar[r] = r < n_blocks ? map_rank(bar_a, r) : 0u;
    }
  }

  if (kMulti && t == 0) {
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
        "mbarrier.init.shared::cta.b64 [%1], 1;" ::"r"(bar_a),
        "r"(bar_a + 8u)
        : "memory");
  }
  for (int u = t; u < plan_len; u += nt) tab[u] = plan[u];
  for (int u = t; u < n_cols * z; u += nt) post[u] = llr_b[u];
  for (int u = t; u < n_edges * nb; u += nt) {
    const int p = u / nb;
    store_msg(c2v + p * lanes + (u - p * nb), 0.f);
  }
  __syncthreads();
  if constexpr (kMulti) {
    // every block's mbarrier is set up before another block pushes to it
    if (t == 0) {
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync_relaxed();
  }
  const int4* edge = reinterpret_cast<const int4*>(tab + tab[kEdge]);
  const int* step_ptr = tab + tab[kStepPtr];
  const int* row_ptr = tab + tab[kRowPtr];
  // Thread t works on lane i = t mod lanes of the block throughout: on the
  // edges k = t / lanes, + m, ... of each step in phases A and C, on the
  // check nodes of rows t / lanes, + m, ... of the step in phase B.
  const int m = nt / lanes;  // the host launches m * lanes threads
  const int j0 = t / lanes;
  const int i = t - j0 * lanes;
  const int k0 = i < nb ? j0 : 0x7fffffff;  // lanes past z: no work
  const int gi = lo + i;                     // the lane among all z
  S* c2v_i = c2v + i;
  float* scratch_i = scratch + i;
  unsigned step = 0;  // steps run, over all iterations

  for (int it = 0; it < num_iter; ++it) {
    for (int s = 0; s < n_steps; ++s) {
      // a step: consecutive rows r0 .. r1 - 1 that share no column, whose
      // edges are the positions p0 .. p0 + d - 1
      const int r0 = step_ptr[s];
      const int r1 = step_ptr[s + 1];
      const int p0 = row_ptr[r0];
      const int d = row_ptr[r1] - p0;
      // A: v2c and its check-node input, sign in the sign bit
      for (int k = k0; k < d; k += m) {
        const int p = p0 + k;
        const int4 rec = edge[p];
        const float v2c =
            post[post_index(rec, gi, z)] - load_msg(c2v_i + p * lanes);
        const bool active = edge_active(rec, gi, z);
        const float v = cn_input(v2c, active, mode);
        scratch_i[k * lanes] = active && v2c < 0.f ? -v : v;
      }
      __syncthreads();
      // B: lane i's check node of each row of the step, its extrinsics
      if (k0 < m) {
        for (int r = r0 + j0; r < r1; r += m) {
          const int q = row_ptr[r];
          cn_lane_dispatch(row_ptr[r + 1] - q, scratch_i + (q - p0) * lanes,
                           lanes, offset, mode);
        }
      }
      __syncthreads();
      // C: new c2v, posterior update (pushed to the other blocks'
      // replicas in a cluster), c2v store
      for (int k = k0; k < d; k += m) {
        const int p = p0 + k;
        const int4 rec = edge[p];
        const float x = scratch_i[k * lanes];
        const float e = fabsf(x);
        const float mag =
            mode == 0 ? sionna_ldpc::boxplus_mag<sionna_ldpc::kLog1p>(e) : e;
        const float c2v_new =
            (signbit(x) ? -1.f : 1.f) * fminf(mag, clip) *
            (edge_active(rec, gi, z) ? 1.f : 0.f);
        S* slot = c2v_i + p * lanes;
        const int j = post_index(rec, gi, z);
        const float marg = post[j] + (c2v_new - load_msg(slot));
        post[j] = marg;
        store_msg(slot, c2v_new);
        if constexpr (kMulti) {
#pragma unroll
          for (int r = 0; r < kBlocks; ++r) {
            if (r < n_blocks && r != rank) {
              push(remote_post[r] + 4u * j, marg,
                   remote_bar[r] + 8u * (step & 1u));
            }
          }
        }
      }
      // the next step reads posterior lanes this one wrote: in this block
      // after the block barrier, from the other blocks once this block's
      // mbarrier of the step has counted their d x (z - nb) lanes of it
      __syncthreads();
      if constexpr (kMulti) {
        const unsigned b_step = bar_a + 8u * (step & 1u);
        if (t == 0) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                  b_step),
              "r"(4u * static_cast<unsigned>(d * (z - nb)))
              : "memory");
        }
        mbar_wait(b_step, (step >> 1) & 1u);  // its (step / 2)-th phase
      }
      ++step;
    }
  }
  if constexpr (kMulti) {
    cluster_sync_relaxed();  // no block leaves while another pushes to it
  }
  for (int u = t; u < n_cols * nb; u += nt) {
    const int c = u / nb;
    const int j = c * z + lo + (u - c * nb);
    out_b[j] = post[j];
  }
}

template <class S, int kBlocks>
cudaError_t launch(const float* llr, const int* plan, float* out, int batch,
                   int n_steps, int n_cols, int n_edges, int z, int lanes,
                   int step_degree, int plan_len, int num_iter, float clip,
                   float offset, int mode, int threads, int cluster,
                   cudaStream_t stream) {
  auto kernel = layered_bp_kernel<S, kBlocks>;
  const size_t smem =
      16 +
      (static_cast<size_t>(n_cols) * z +
       static_cast<size_t>(step_degree) * lanes + plan_len) * 4 +
      static_cast<size_t>(n_edges) * lanes * sizeof(S);
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
  cfg.numAttrs = kBlocks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, llr, plan, out, n_steps, n_cols,
                            n_edges, z, lanes, step_degree, plan_len,
                            num_iter, clip, offset, mode);
}

// The variant of `cluster` blocks per codeword: one block, or the
// cluster layout of up to kSmallCluster or kMaxCluster blocks.
template <class S>
cudaError_t launch_variant(int cluster, const float* llr, const int* plan,
                           float* out, int batch, int n_steps, int n_cols,
                           int n_edges, int z, int lanes, int step_degree,
                           int plan_len, int num_iter, float clip,
                           float offset, int mode, int threads,
                           cudaStream_t stream) {
  auto go = cluster == 1                ? launch<S, 1>
            : cluster <= kSmallCluster ? launch<S, kSmallCluster>
                                       : launch<S, kMaxCluster>;
  return go(llr, plan, out, batch, n_steps, n_cols, n_edges, z, lanes,
            step_degree, plan_len, num_iter, clip, offset, mode, threads,
            cluster, stream);
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
  if (batch <= 0 || z <= 0 || z > 0xffff || n_cols > 0x7fff || lanes <= 0 ||
      num_iter < 0 || (mode != 0 && mode != 1) ||
      (bf16 != 0 && bf16 != 1) || threads <= 0 || threads > kMaxThreads ||
      threads % lanes != 0 || cluster < 1 || cluster > kMaxCluster ||
      lanes * cluster < z || (cluster - 1) * lanes >= z ||
      (cluster > 1 && lanes < 2) ||
      step_degree <= 0 || plan_len < kHeader) {
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
