// The flooding schedule of the lifted 5G LDPC decoder in K1's on-chip
// layout: one copy, shared by K1 (ldpc_lifted_bp.cu, the decode) and K5f
// (ldpc_lifted_bp_grad.cu, the decode with its gradient's tape). K1's note
// in ldpc_lifted_bp.cu describes the layout and the numerics; `decode`
// with kTape also stores, in each iteration t, every v2c message a
// check-node unit reads to tape[t] ([T, E, B, Z] f32), at the row position
// it reads it from: edges are numbered row by row, so that is the edge's
// index. K5b (ldpc_lifted_bp_grad.cu) takes the same plan and helpers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace sionna_ldpc {
namespace flooding {

namespace cg = cooperative_groups;

// The layout limits come from sionna_tpu_torch/phy/fec/ldpc/decoding.py
// (K1_MAX_THREADS, ...), their one source, as defines on nvcc's command
// line.
#if !defined(SIONNA_K1_MAX_THREADS) || !defined(SIONNA_K1_MAX_CLUSTER) || \
    !defined(SIONNA_K1_REG_UNITS) || !defined(SIONNA_K1_REG_UNITS_CLUSTER) || \
    !defined(SIONNA_K1_PLAN_ARRAYS)
#error "build with K1's defines (sionna_tpu_torch/phy/fec/ldpc/decoding.py)"
#endif
constexpr int kMaxThreads = SIONNA_K1_MAX_THREADS;  // threads per block
constexpr int kMaxCluster = SIONNA_K1_MAX_CLUSTER;  // blocks per codeword
// register-edge CN units per thread: one block; cluster (whose slot
// addresses take more registers)
constexpr int kRegUnits = SIONNA_K1_REG_UNITS;
constexpr int kRegUnitsCluster = SIONNA_K1_REG_UNITS_CLUSTER;

// Header of the plan: offsets (in ints) of its arrays, in the order of
// K1_PLAN_ARRAYS.
enum {
  kRowPtr, kRowSlot, kRowRange, kColPtr, kColSlot, kColShift, kRegRows,
  kRegPos, kRegCol, kRegShift, kPlainRows, kVnCols, kHeader
};
static_assert(kHeader == SIONNA_K1_PLAN_ARRAYS,
              "the plan's arrays differ from K1_PLAN_ARRAYS");

// What a store into a slot does to a v2c message: nothing (f32 storage)
// or rounding to bf16, nearest even, and widening back.
template <bool kRound>
__device__ __forceinline__ float stored(float v) {
  if constexpr (kRound) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Address of lane l of a shared slot. Single block: `slot` is the edge's
// index in the block's state. Cluster: (owner block << 16) | index.
template <bool kMulti>
__device__ __forceinline__ float* slot_ptr(float* state, int slot, int z,
                                           int l) {
  if constexpr (kMulti) {
    float* base = cg::this_cluster().map_shared_rank(state, slot >> 16);
    return base + (slot & 0xffff) * z + l;
  } else {
    return state + slot * z + l;
  }
}

// Lane l of an edge is active when (l - lo) mod z < len; range packs
// lo | len << 16.
__device__ __forceinline__ bool lane_active(int range, int z, int l) {
  int d = l - (range & 0xffff);
  if (d < 0) d += z;
  return d < (range >> 16);
}

// The tape (kTape), a kernel parameter: tape[t][e][b][l] at
// rows + (t * n_edges + e) * estride + b * z + l.
struct TapeRows {
  float* rows;
  size_t estride;  // batch * z: edge to edge
  int n_edges;
};

// Row position p of iteration t's tape rows of codeword b (64-bit: a
// BP-20 tape at n = 12288 x 2048 has 2.5e9 floats), from the kernel's
// parameters and the loop's counters alone, so that no 64-bit address
// stays in registers across the iterations.
__device__ __forceinline__ float* tape_rows(const TapeRows& tape, int t,
                                            int p, size_t b, int z) {
  return tape.rows +
         (static_cast<size_t>(t) * tape.n_edges + p) * tape.estride + b * z;
}

// One check-node unit (row of degree D, lane l): reads the row's v2c from
// the slots (or, at position reg_pos, from reg_v2c), writes each edge's
// c2v back into its slot, and returns the c2v of position reg_pos. kTape:
// stores each v2c at tape[k * estride + l] (the row's first position in
// this iteration's tape), write-once data, by a streaming store. mode 0:
// boxplus; 1: (offset) min-sum.
template <int D, int kForm, bool kMulti, bool kTape>
__device__ __forceinline__ float cn_unit(float* state,
                                         const int* __restrict__ slot,
                                         const int* __restrict__ range,
                                         int z, int l, int reg_pos,
                                         float reg_v2c, float clip,
                                         float offset, int mode, float* tape,
                                         size_t estride) {
  float val[D];  // tanh(|m|/2) (boxplus) or |m| (min-sum)
  unsigned neg = 0, act = 0;
  float sign_tot = 1.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float m;
    if (k == reg_pos) {
      m = reg_v2c;
    } else {
      m = *slot_ptr<kMulti>(state, slot[k], z, l);
    }
    if constexpr (kTape) __stcs(tape + k * estride + l, m);
    const bool on = lane_active(range[k], z, l);
    if (on) act |= 1u << k;
    sionna_ldpc::cn_edge_in<D>(k, m, on, mode, val, neg, sign_tot);
  }
  float reg_c2v = 0.f;
  sionna_ldpc::cn_extrinsic<D, kForm>(val, mode, offset, [&](int k,
                                                             float mag) {
    const float c2v =
        sionna_ldpc::cn_edge_out(k, mag, neg, act, sign_tot, clip);
    if (k == reg_pos) {
      reg_c2v = c2v;
    } else {
      *slot_ptr<kMulti>(state, slot[k], z, l) = c2v;
    }
  });
  return reg_c2v;
}

// cn_unit for a runtime degree d of SIONNA_CN_DEGREES (ldpc_cn.cuh).
template <int kForm, bool kMulti, bool kTape>
__device__ __forceinline__ float cn_dispatch(int d, float* state,
                                             const int* slot,
                                             const int* range, int z, int l,
                                             int reg_pos, float reg_v2c,
                                             float clip, float offset,
                                             int mode, float* tape,
                                             size_t estride) {
  switch (d) {
#define SIONNA_CN_CASE(D)                                                  \
  case D:                                                                  \
    return cn_unit<D, kForm, kMulti, kTape>(state, slot, range, z, l,      \
                                            reg_pos, reg_v2c, clip, offset, \
                                            mode, tape, estride);
    SIONNA_CN_DEGREES(SIONNA_CN_CASE)
#undef SIONNA_CN_CASE
    default:
      return 0.f;  // the host refuses a code with any other degree
  }
}

template <bool kMulti>
__device__ __forceinline__ void phase_barrier() {
  if constexpr (kMulti) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The flooding decode of the block's (or cluster's) codeword. kRound:
// bf16 v2c storage; kForm: boxplus magnitude; kMulti: cluster layout;
// kTape: stores the tape (f32 storage only). Dynamic shared memory:
// state_floats floats of slots, then the plan's plan_len ints.
template <bool kRound, int kForm, bool kMulti, bool kTape>
__device__ __forceinline__ void decode(
    const float* __restrict__ llr, const int* __restrict__ plan,
    float* __restrict__ out, TapeRows tape, int n_cols, int z,
    int n_reg_rows, int n_plain_rows, int n_vn_cols, int state_floats,
    int plan_len, int num_iter, float clip, float offset, int mode) {
  static_assert(!(kTape && kRound), "the tape holds f32 messages");
  extern __shared__ float smem[];
  float* state = smem;
  int* tab = reinterpret_cast<int*>(smem + state_floats);
  int rank = 0;
  int n_blocks = 1;
  size_t b = blockIdx.x;
  if constexpr (kMulti) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    n_blocks = static_cast<int>(cluster.num_blocks());
    b = blockIdx.x / n_blocks;
  }
  const int g = rank * blockDim.x + threadIdx.x;  // thread in the codeword
  const int n_threads = n_blocks * blockDim.x;
  const float* llr_b = llr + b * n_cols * z;
  float* out_b = out + b * n_cols * z;

  if (num_iter == 0) {
    for (int u = g; u < n_cols * z; u += n_threads) out_b[u] = llr_b[u];
    return;
  }
  for (int u = threadIdx.x; u < plan_len; u += blockDim.x) tab[u] = plan[u];
  // every block of the cluster is running (and has its plan) before any
  // slot of another block is written
  phase_barrier<kMulti>();
  const int* row_ptr = tab + tab[kRowPtr];
  const int* row_slot = tab + tab[kRowSlot];
  const int* row_range = tab + tab[kRowRange];
  const int* col_ptr = tab + tab[kColPtr];
  const int* col_slot = tab + tab[kColSlot];
  const int* col_shift = tab + tab[kColShift];
  const int* reg_rows = tab + tab[kRegRows];
  const int* reg_pos = tab + tab[kRegPos];
  const int* reg_col = tab + tab[kRegCol];
  const int* reg_shift = tab + tab[kRegShift];
  const int* plain_rows = tab + tab[kPlainRows];
  const int* vn_cols = tab + tab[kVnCols];
  const int n_reg_units = n_reg_rows * z;
  constexpr int kUnits = kMulti ? kRegUnitsCluster : kRegUnits;

  // Init: v2c = clip(llr) in CN alignment, written from the VN side
  // (every shared edge lies in a column without a register edge)
  for (int u = g; u < n_vn_cols * z; u += n_threads) {
    const int ci = u / z;
    const int j = u - ci * z;
    const int c = vn_cols[ci];
    const float v = stored<kRound>(clampf(llr_b[c * z + j], clip));
    for (int p = col_ptr[c]; p < col_ptr[c + 1]; ++p) {
      int l = j - col_shift[p];
      if (l < 0) l += z;
      *slot_ptr<kMulti>(state, col_slot[p], z, l) = v;
    }
  }
  float reg_v2c[kUnits];  // register edges, CN units g + k * n_threads
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int q = g + k * n_threads;
    reg_v2c[k] = 0.f;
    if (q < n_reg_units) {
      const int ri = q / z;
      int j = q - ri * z + reg_shift[ri];
      if (j >= z) j -= z;
      reg_v2c[k] = stored<kRound>(clampf(llr_b[reg_col[ri] * z + j], clip));
    }
  }
  phase_barrier<kMulti>();

  for (int it = 0; it < num_iter; ++it) {
    const bool last = it == num_iter - 1;
    // CN phase, rows with a register edge: that edge's degree-1 column
    // is updated right after, by the same thread (loops over units are
    // kept rolled: each body holds the degree switch)
#pragma unroll 1
    for (int k = 0; k < kUnits; ++k) {
      const int q = g + k * n_threads;
      if (q >= n_reg_units) break;
      const int ri = q / z;
      const int l = q - ri * z;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kUnits; ++i) v = i == k ? reg_v2c[i] : v;
      const int r = reg_rows[ri];
      const int p0 = row_ptr[r];
      const float c2v = cn_dispatch<kForm, kMulti, kTape>(
          row_ptr[r + 1] - p0, state, row_slot + p0, row_range + p0, z, l,
          reg_pos[ri], v, clip, offset, mode,
          kTape ? tape_rows(tape, it, p0, b, z) : nullptr, tape.estride);
      int j = l + reg_shift[ri];
      if (j >= z) j -= z;
      const int vn = reg_col[ri] * z + j;
      const float tot = llr_b[vn] + c2v;
      if (last) out_b[vn] = clampf(tot, clip);
      v = stored<kRound>(clampf(tot - c2v, clip));
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        reg_v2c[i] = i == k ? v : reg_v2c[i];
      }
    }
    // CN phase, the other rows
#pragma unroll 1
    for (int u = g; u < n_plain_rows * z; u += n_threads) {
      const int ri = u / z;
      const int l = u - ri * z;
      const int r = plain_rows[ri];
      const int p0 = row_ptr[r];
      cn_dispatch<kForm, kMulti, kTape>(
          row_ptr[r + 1] - p0, state, row_slot + p0, row_range + p0, z, l,
          -1, 0.f, clip, offset, mode,
          kTape ? tape_rows(tape, it, p0, b, z) : nullptr, tape.estride);
    }
    phase_barrier<kMulti>();
    // VN phase: marginal = llr + c2v[e0] + c2v[e1] + ..., then each
    // edge's v2c = clip(marginal - its c2v), rereading the slot
#pragma unroll 1
    for (int u = g; u < n_vn_cols * z; u += n_threads) {
      const int ci = u / z;
      const int j = u - ci * z;
      const int c = vn_cols[ci];
      const int p0 = col_ptr[c];
      const int p1 = col_ptr[c + 1];
      float tot = llr_b[c * z + j];
      for (int p = p0; p < p1; ++p) {
        int l = j - col_shift[p];
        if (l < 0) l += z;
        tot = tot + *slot_ptr<kMulti>(state, col_slot[p], z, l);
      }
      if (last) out_b[c * z + j] = clampf(tot, clip);
      for (int p = p0; p < p1; ++p) {
        int l = j - col_shift[p];
        if (l < 0) l += z;
        float* s = slot_ptr<kMulti>(state, col_slot[p], z, l);
        *s = stored<kRound>(clampf(tot - *s, clip));
      }
    }
    // also keeps every block of a cluster alive until no other block
    // reads its slots
    phase_barrier<kMulti>();
  }
}

// Dynamic shared memory of a launch: the slots, then the plan.
inline size_t smem_bytes(int state_floats, int plan_len) {
  return (static_cast<size_t>(state_floats) + plan_len) * 4;
}

// Whether a launch's layout is outside what the kernels take.
inline bool bad_layout(int batch, int z, int n_reg_rows, int num_iter,
                       int mode, int threads, int cluster, int plan_len) {
  return batch <= 0 || z <= 0 || z > 0xffff || num_iter < 0 ||
         (mode != 0 && mode != 1) || threads <= 0 || threads > kMaxThreads ||
         threads % 32 != 0 || cluster < 1 || cluster > kMaxCluster ||
         n_reg_rows * z > (cluster > 1 ? kRegUnitsCluster : kRegUnits) *
                              threads * cluster ||
         plan_len < kHeader;
}

}  // namespace flooding
}  // namespace sionna_ldpc
