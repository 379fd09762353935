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
// the layouts), the whole message state on chip for the whole launch.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ldpc_cn.cuh"

namespace cg = cooperative_groups;

namespace {

using sionna_ldpc::clampf;
using sionna_ldpc::signf;

// The layout limits come from sionna_tpu_torch/phy/fec/ldpc/decoding.py
// (K1_MAX_THREADS, ...), their one source, as defines on nvcc's command
// line.
#if !defined(SIONNA_K1_MAX_THREADS) || !defined(SIONNA_K1_MAX_CLUSTER) || \
    !defined(SIONNA_K1_REG_UNITS) || !defined(SIONNA_K1_REG_UNITS_CLUSTER) || \
    !defined(SIONNA_K1_PLAN_ARRAYS)
#error "build with the defines of LIFTED_BP_KERNEL (sionna_tpu_torch/_build.py)"
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

// One check-node unit (row of degree D, lane l): reads the row's v2c from
// the slots (or, at position reg_pos, from reg_v2c), writes each edge's
// c2v back into its slot, and returns the c2v of position reg_pos.
// mode 0: boxplus; 1: (offset) min-sum.
template <int D, int kForm, bool kMulti>
__device__ __forceinline__ float cn_unit(float* state,
                                         const int* __restrict__ slot,
                                         const int* __restrict__ range,
                                         int z, int l, int reg_pos,
                                         float reg_v2c, float clip,
                                         float offset, int mode) {
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
    float v = mode == 0 ? tanhf(fabsf(m) / 2.f) : fabsf(m);
    float s = signf(m);
    if (lane_active(range[k], z, l)) {
      act |= 1u << k;
    } else {
      v = mode == 0 ? 1.f : 1e30f;
      s = 1.f;
    }
    val[k] = v;
    if (s < 0.f) neg |= 1u << k;
    sign_tot = k == 0 ? s : sign_tot * s;
  }
  float reg_c2v = 0.f;
  sionna_ldpc::cn_extrinsic<D, kForm>(val, mode, offset, [&](int k,
                                                             float mag) {
    const float sgn = (neg >> k) & 1u ? -1.f : 1.f;
    const float c2v = sign_tot * sgn * fminf(mag, clip) *
                      ((act >> k) & 1u ? 1.f : 0.f);
    if (k == reg_pos) {
      reg_c2v = c2v;
    } else {
      *slot_ptr<kMulti>(state, slot[k], z, l) = c2v;
    }
  });
  return reg_c2v;
}

// cn_unit for a runtime degree d of SIONNA_CN_DEGREES (ldpc_cn.cuh).
template <int kForm, bool kMulti>
__device__ __forceinline__ float cn_dispatch(int d, float* state,
                                             const int* slot,
                                             const int* range, int z, int l,
                                             int reg_pos, float reg_v2c,
                                             float clip, float offset,
                                             int mode) {
  switch (d) {
#define SIONNA_CN_CASE(D)                                                  \
  case D:                                                                  \
    return cn_unit<D, kForm, kMulti>(state, slot, range, z, l, reg_pos,    \
                                     reg_v2c, clip, offset, mode);
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

// kRound: bf16 v2c storage; kForm: boxplus magnitude; kMulti: cluster
// layout. Dynamic shared memory: state_floats floats of slots, then the
// plan's plan_len ints.
template <bool kRound, int kForm, bool kMulti>
__global__ void __launch_bounds__(kMaxThreads, 1)
lifted_bp_kernel(const float* __restrict__ llr, const int* __restrict__ plan,
                 float* __restrict__ out, int n_cols, int z, int n_reg_rows,
                 int n_plain_rows, int n_vn_cols, int state_floats,
                 int plan_len, int num_iter, float clip, float offset,
                 int mode) {
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
      const float c2v = cn_dispatch<kForm, kMulti>(
          row_ptr[r + 1] - p0, state, row_slot + p0, row_range + p0, z, l,
          reg_pos[ri], v, clip, offset, mode);
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
      cn_dispatch<kForm, kMulti>(row_ptr[r + 1] - p0, state, row_slot + p0,
                                 row_range + p0, z, l, -1, 0.f, clip,
                                 offset, mode);
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

template <bool kRound, int kForm, bool kMulti>
cudaError_t launch(const float* llr, const int* plan, float* out, int batch,
                   int n_cols, int z, int n_reg_rows, int n_plain_rows,
                   int n_vn_cols, int state_floats, int plan_len,
                   int num_iter, float clip, float offset, int mode,
                   int threads, int cluster, cudaStream_t stream) {
  auto kernel = lifted_bp_kernel<kRound, kForm, kMulti>;
  const size_t smem = (static_cast<size_t>(state_floats) + plan_len) * 4;
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
  cfg.numAttrs = kMulti ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, llr, plan, out, n_cols, z,
                            n_reg_rows, n_plain_rows, n_vn_cols,
                            state_floats, plan_len, num_iter, clip, offset,
                            mode);
}

template <bool kRound, int kForm>
cudaError_t launch_layout(int cluster, const float* llr, const int* plan,
                          float* out, int batch, int n_cols, int z,
                          int n_reg_rows, int n_plain_rows, int n_vn_cols,
                          int state_floats, int plan_len, int num_iter,
                          float clip, float offset, int mode, int threads,
                          cudaStream_t stream) {
  return (cluster > 1 ? launch<kRound, kForm, true>
                      : launch<kRound, kForm, false>)(
      llr, plan, out, batch, n_cols, z, n_reg_rows, n_plain_rows, n_vn_cols,
      state_floats, plan_len, num_iter, clip, offset, mode, threads, cluster,
      stream);
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
  if (batch <= 0 || z <= 0 || z > 0xffff || num_iter < 0 ||
      (mode != 0 && mode != 1) || (bf16 != 0 && bf16 != 1) ||
      (ratio != 0 && ratio != 1) || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || cluster < 1 || cluster > kMaxCluster ||
      n_reg_rows * z > (cluster > 1 ? kRegUnitsCluster : kRegUnits) *
                           threads * cluster ||
      plan_len < kHeader) {
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
