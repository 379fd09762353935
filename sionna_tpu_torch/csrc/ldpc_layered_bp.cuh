// The layered (serial-C) schedule of the lifted 5G LDPC decoder in K3's
// on-chip layout: one copy, shared by K3 (ldpc_layered_bp.cu, the decode)
// and K5Lf (ldpc_layered_bp_grad.cu, the decode with its gradient's tape).
// K3's note in ldpc_layered_bp.cu describes the layout and the numerics.
// `decode` with kTape (f32 c2v only) also stores each iteration t's
// starting posterior to tape_m[t] ([T, C, B, Z] f32) and the c2v_old
// that phase A reads to tape_c[t] ([T, E, B, Z]) at its row position (the
// edge's index: edges are numbered row by row), write-once data, by
// streaming stores; nothing is read back. K5Lb (ldpc_layered_bp_grad.cu)
// takes the same plan and helpers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace sionna_ldpc {
namespace layered {

namespace cg = cooperative_groups;

// The layout limits come from sionna_tpu_torch/phy/fec/ldpc/decoding.py
// (K3_MAX_THREADS, ...), their one source, as defines on nvcc's command
// line.
#if !defined(SIONNA_K3_MAX_THREADS) || !defined(SIONNA_K3_MAX_CLUSTER) || \
    !defined(SIONNA_K3_PLAN_ARRAYS)
#error "build with K3's defines (sionna_tpu_torch/phy/fec/ldpc/decoding.py)"
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

// The tapes (kTape), a kernel parameter: tape_m[t][c][b][j] at
// marg[(t * n_cols + c) * estride + b * z + j], tape_c[t][e][b][i] at
// c2v[(t * n_edges + e) * estride + b * z + i].
struct Tapes {
  float* marg;
  float* c2v;
  size_t estride;  // batch * z
};

// The layered decode of the block's (or cluster's) codeword. S: c2v
// storage type (float or __nv_bfloat16); kBlocks: 1, or the cluster
// layout for clusters of up to kBlocks blocks, block b of the cluster
// owning lanes [b lanes, b lanes + lanes) of the c2v slots and a replica
// of the whole posterior; kTape: stores the tapes (f32 only). Dynamic
// shared memory: two mbarriers (16 B), the plan's plan_len ints, the
// posterior [n_cols][z] f32, the scratch [step_degree][lanes] f32, c2v
// [n_edges][lanes] of S.
template <class S, int kBlocks, bool kTape>
__device__ __forceinline__ void decode(
    const float* __restrict__ llr, const int* __restrict__ plan,
    float* __restrict__ out, Tapes tape, int n_steps, int n_cols,
    int n_edges, int z, int lanes, int step_degree, int plan_len,
    int num_iter, float clip, float offset, int mode) {
  static_assert(!kTape || sizeof(S) == 4, "the tapes hold f32 messages");
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
    // kTape: this iteration's tape rows of the codeword, at lane gi of
    // row position p for tape_c (64-bit: the tapes of a layered-10 call
    // at n = 12288 x 2048 hold 1.5e9 floats)
    float* tape_c = nullptr;
    if constexpr (kTape) {
      const size_t est = tape.estride;
      tape_c = tape.c2v + static_cast<size_t>(it) * n_edges * est + b * z +
               gi;
      // tape_m[it]: this block's lane run of every column, from its
      // replica of the posterior, whole since the last step's barrier and
      // mbarrier wait
      float* tm = tape.marg + static_cast<size_t>(it) * n_cols * est +
                  b * z + lo;
      for (int u = t; u < n_cols * nb; u += nt) {
        const int c = u / nb;
        const int l = u - c * nb;
        __stcs(tm + c * est + l, post[c * z + lo + l]);
      }
      // Cluster: another block can run a step ahead of this one and push
      // the first step's posterior lanes into this replica, lanes of this
      // block's run among them; so the blocks meet once their stores
      // have read the replica (each load's value feeds its store, which
      // issues before this thread arrives) and before any pushes again.
      if constexpr (kMulti) cluster_sync_relaxed();
    }
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
        if constexpr (kTape) {
          __stcs(tape_c + p * tape.estride, load_msg(c2v_i + p * lanes));
        }
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

// Dynamic shared memory of a launch: the mbarriers, the plan, the
// posterior, the scratch, then the c2v slots of S.
template <class S>
size_t smem_bytes(int n_cols, int n_edges, int z, int lanes,
                  int step_degree, int plan_len) {
  return 16 +
         (static_cast<size_t>(n_cols) * z +
          static_cast<size_t>(step_degree) * lanes + plan_len) * 4 +
         static_cast<size_t>(n_edges) * lanes * sizeof(S);
}

// Whether a launch's layout is outside what the kernels take.
inline bool bad_layout(int batch, int n_cols, int z, int lanes, int num_iter,
                       int mode, int threads, int cluster, int step_degree,
                       int plan_len) {
  return batch <= 0 || z <= 0 || z > 0xffff || n_cols > 0x7fff ||
         lanes <= 0 || num_iter < 0 || (mode != 0 && mode != 1) ||
         threads <= 0 || threads > kMaxThreads || threads % lanes != 0 ||
         cluster < 1 || cluster > kMaxCluster || lanes * cluster < z ||
         (cluster - 1) * lanes >= z || (cluster > 1 && lanes < 2) ||
         step_degree <= 0 || plan_len < kHeader;
}

}  // namespace layered
}  // namespace sionna_ldpc
