// The gradient of the lifted 5G LDPC decoder, flooding schedule: K5f, the
// decode with its tape, and K5b, its reverse.
//
// Replaces, on the training path, the flooding branch of the Pallas kernel
// `_lifted_pallas_decode` in sionna_tpu/phy/fec/ldpc/decoding.py (which has
// no VJP) together with what the JAX package differentiates instead: XLA's
// autodiff of `LDPC5GLiftedBP.decode` (its `fori_loop` of `_lifted_cn_phase`
// and the VN phase). The plain versions are `flooding_tape_forward` and
// `flooding_reverse` in sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py.
//
// - K5f is K1 (ldpc_lifted_bp.cu) with its tape: it runs K1's code,
//   `decode` of ldpc_lifted_bp.cuh, in K1's layout and plan
//   (`lifted_bp_layout`), so its marginals are K1's bit for bit, and
//   stores tape[t], the CN-aligned v2c that iteration t reads ([T, E, B,
//   Z] f32; the carry of JAX's loop).
// - K5b walks the iterations backwards. In iteration t it recomputes the
//   c2v from tape[t] (K1's arithmetic, so the same values); takes the
//   VN phase's reverse (the clips of the marginal, only in the last
//   iteration, and of each v2c, JAX's 1/2 at the bound; the rolls inverted
//   by the CN-aligned indexing), which leaves dL/dc2v over the c2v; then
//   the CN phase's (cn_adjoint), into dL/dv2c; last, the initial clip of
//   the LLRs. dL/dllr accumulates per VN lane in the output, in the same
//   order as the plain reverse.
//
// What bounds K5f on an H100: K1's check-node arithmetic (95 FP32
// operations per boxplus edge-lane update, 3.51 ms at n = 12288 x 2048
// BP-20) against the bytes it must move, now the tape written once (9.91
// GB there, 2.96 ms at 3.35 TB/s; 1.28 GB at the n = 2048 x 2000 link).
// Its first design kept the c2v state in a [B, E, Z] slab in device
// memory, one block of 256 threads per codeword, and read each v2c back
// from the tape row it wrote an iteration before: about 2.5 GB of
// message traffic per iteration at n = 12288 x 2048, which took it to
// nearly twice K1's time (PERF.md, Findings). Now the state stays on chip
// as in K1 (one f32 slot per edge lane in shared memory, the register
// edges in registers, a cluster where the slots do not fit one block);
// each CN unit (row r, lane l) stores the row's D v2c at tape[t][row_ptr[r]
// + k][b][l] as it reads them (the register edge's from its register),
// consecutive lanes at consecutive addresses, with streaming stores
// (write-once data, read only by K5b; they measured faster than plain
// stores); iteration 0's v2c, clip(llr), is what the first CN phase
// reads, so there is no separate pass. Nothing is read back: the device
// traffic is the LLRs, the marginals and the tape. The tape addresses
// come from the kernel's parameters and loop counters at each unit, so
// K5f keeps K1's 512 threads at 128 registers (the one-block variant
// spills 12 bytes; fewer threads would need more register-edge units per
// thread than K1 holds, a 2-block cluster at n = 12288).
//
// What bounds K5b on an H100: the check-node arithmetic, one forward
// (95 FP32 operations per edge lane and iteration), a division and the
// adjoint (26); the bytes the function needs are the LLRs, dL/dmarg, the
// tape (read once: 1.28 GB at the n = 2048 x 2000 link at BP-20, 9.91 GB
// at n = 12288 x 2048) and dL/dllr, below the operations at both shapes.
//
// K5b's design keeps the message state on chip for the whole launch, as
// K1 does (`flooding_grad_layout` in lifted_grad.py plans the layout and
// the int32 plan, K1's, that it copies into shared memory):
// - Two f32 slots per edge lane in shared memory, in two slabs: c2v, then
//   dL/dc2v written over it by the VN reverse; and dL/dv2c, written by the
//   CN adjoint of iteration t + 1 and read by the VN reverse of t.
// - Register edges: each base row's first edge whose column has degree 1
//   keeps both slots in registers of the thread of CN unit (row, lane),
//   which takes that column's VN reverse itself right after the row's
//   forward (20 of 210 base edges at n = 12288).
// - Cluster layout: where the slabs do not fit one block's 232,448 B
//   (n = 12288: 2 x 190 x 288 x 4 = 437,760 B), a cluster of 2-8 blocks
//   shares the codeword, each block holding a contiguous group of edges'
//   slots; every slot access goes through distributed shared memory
//   (`map_shared_rank`) and `cluster.sync()` replaces the block barrier.
// - The tape: each unit reads its row's v2c twice per iteration, in the
//   forward and in the adjoint, since the row's D values do not stay in
//   registers across the VN reverse (a thread holds several units of
//   different degrees). Staged layout (one block with room for two more
//   [E, Z] buffers, the link's code): the rows of tape[t - 1] are copied
//   into shared memory with cp.async while iteration t runs, so the tape
//   is read from device memory once and both reads are shared-memory
//   reads. Otherwise (n = 12288, whose slots fill the block) the second
//   read finds the rows of the codewords in flight in L2 (about 16 MB).
// - Three barriers per iteration: after the forward, after the VN
//   reverse, after the adjoint.
// Numerics: the check node and its adjoint are ldpc_cn_grad.cuh's; each
// VN lane's sums run in column order and dL/dllr accumulates iteration by
// iteration, as in the plain reverse; no atomics, so a call's output does
// not depend on the layout or the schedule of the threads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ldpc_cn_grad.cuh"
#include "ldpc_lifted_bp.cuh"

namespace {

namespace cg = cooperative_groups;
namespace fl = sionna_ldpc::flooding;
using fl::lane_active;
using fl::phase_barrier;
using fl::slot_ptr;
using sionna_ldpc::clampf;
using sionna_ldpc::cn_adjoint;
using sionna_ldpc::cn_forward;
using sionna_ldpc::d_clip;
using sionna_ldpc::with_degree;

// K5f: K1's decode with the tape, in K1's layout (the f32 log1p variant,
// the only one under grad). tape: [num_iter, n_edges, batch, z].
template <bool kMulti>
__global__ void __launch_bounds__(fl::kMaxThreads, 1)
flooding_tape_kernel(const float* __restrict__ llr,
                     const int* __restrict__ plan, float* __restrict__ out,
                     fl::TapeRows tape, int n_cols, int z, int n_reg_rows,
                     int n_plain_rows, int n_vn_cols, int state_floats,
                     int plan_len, int num_iter, float clip, float offset,
                     int mode) {
  fl::decode<false, sionna_ldpc::kLog1p, kMulti, true>(
      llr, plan, out, tape, n_cols, z, n_reg_rows, n_plain_rows, n_vn_cols,
      state_floats, plan_len, num_iter, clip, offset, mode);
}

// K5b's layout limits, from lifted_grad.py (K5B_MAX_THREADS, ...). Its
// plan is K1's (fl::kRowPtr, ...): a slot id indexes both slabs.
#if !defined(SIONNA_K5B_MAX_THREADS) || !defined(SIONNA_K5B_MAX_CLUSTER) || \
    !defined(SIONNA_K5B_REG_UNITS)
#error "build with the defines of LIFTED_BP_GRAD_KERNEL (lifted_grad.py)"
#endif
constexpr int kBMaxThreads = SIONNA_K5B_MAX_THREADS;
constexpr int kBMaxCluster = SIONNA_K5B_MAX_CLUSTER;
constexpr int kRegUnits = SIONNA_K5B_REG_UNITS;

// Copies one iteration's tape rows of the codeword (row e at src + e *
// estride, z floats) into dst [E][z] with cp.async, 16 bytes a copy where
// z is a multiple of 4 (every row then 16-byte aligned), and commits them
// as one group.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t estride, int n_edges,
                                           int z) {
  if ((z & 3) == 0) {
    const int zq = z >> 2;
    for (int u = threadIdx.x; u < n_edges * zq; u += blockDim.x) {
      const int e = u / zq;
      const int q = 4 * (u - e * zq);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       static_cast<unsigned>(
                           __cvta_generic_to_shared(dst + e * z + q))),
                   "l"(__cvta_generic_to_global(src + e * estride + q))
                   : "memory");
    }
  } else {
    for (int u = threadIdx.x; u < n_edges * z; u += blockDim.x) {
      const int e = u / z;
      const unsigned to =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + u));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                   "l"(__cvta_generic_to_global(src + e * estride +
                                                (u - e * z)))
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The forward of one CN unit (row of degree D, lane l): the row's v2c at
// rows[k * rstride + l], its c2v into the c2v slab (or, at position
// reg_pos, returned).
template <int D, bool kMulti>
__device__ __forceinline__ float cn_unit_forward(
    float* slab_c, const int* slot, const int* range, const float* rows,
    size_t rstride, int z, int l, int reg_pos, float clip, float offset,
    int mode) {
  float m[D], out[D];
  unsigned act = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    m[k] = rows[k * rstride + l];
    if (lane_active(range[k], z, l)) act |= 1u << k;
  }
  cn_forward<D>(m, act, clip, offset, mode, out);
  float reg = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k == reg_pos) {
      reg = out[k];
    } else {
      *slot_ptr<kMulti>(slab_c, slot[k], z, l) = out[k];
    }
  }
  return reg;
}

// The adjoint of one CN unit: dL/dc2v from the c2v slab (position reg_pos:
// reg_g), the row's v2c again from the tape rows; dL/dv2c into the other
// slab (position reg_pos: returned).
template <int D, bool kMulti>
__device__ __forceinline__ float cn_unit_adjoint(
    float* slab_c, float* slab_g, const int* slot, const int* range,
    const float* rows, size_t rstride, int z, int l, int reg_pos,
    float reg_g, float clip, float offset, int mode) {
  float m[D], g[D];
  unsigned act = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    m[k] = rows[k * rstride + l];
    if (k == reg_pos) {
      g[k] = reg_g;
    } else {
      g[k] = *slot_ptr<kMulti>(slab_c, slot[k], z, l);
    }
    if (lane_active(range[k], z, l)) act |= 1u << k;
  }
  cn_adjoint<D>(m, g, act, clip, offset, mode);
  float reg = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k == reg_pos) {
      reg = g[k];
    } else {
      *slot_ptr<kMulti>(slab_g, slot[k], z, l) = g[k];
    }
  }
  return reg;
}

// Register i of regs[] for a runtime i (compile-time selects, so the
// array stays in registers).
__device__ __forceinline__ float reg_get(const float (&regs)[kRegUnits],
                                         int i) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) v = k == i ? regs[k] : v;
  return v;
}
__device__ __forceinline__ void reg_set(float (&regs)[kRegUnits], int i,
                                        float v) {
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) regs[k] = k == i ? v : regs[k];
}

// K5b. llr, g_marg, g_llr: [B, C * z] (padded: 0 beyond the code's VNs);
// tape: [T, E, B, z]. kMulti: cluster layout; kStaged: tape rows copied
// ahead into shared memory. Dynamic shared memory: the staged rows [2][E][z]
// (kStaged), the slabs c2v/dL-dc2v and dL/dv2c (slab_floats floats each),
// the plan's plan_len ints.
template <bool kMulti, bool kStaged>
__global__ void __launch_bounds__(kBMaxThreads, 1)
flooding_reverse_kernel(const float* __restrict__ llr,
                        const int* __restrict__ plan,
                        const float* __restrict__ g_marg,
                        const float* __restrict__ tape,
                        float* __restrict__ g_llr, int batch, int n_cols,
                        int n_edges, int z, int n_reg_rows, int n_plain_rows,
                        int n_vn_cols, int slab_floats, int plan_len,
                        int num_iter, float clip, float offset, int mode) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tape_floats = kStaged ? n_edges * z : 0;
  float* stage = smem;
  float* slab_c = smem + 2 * tape_floats;  // c2v, then dL/dc2v
  float* slab_g = slab_c + slab_floats;    // dL/dv2c
  int* tab = reinterpret_cast<int*>(slab_g + slab_floats);
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
  const float* gm_b = g_marg + b * n_cols * z;
  float* gl_b = g_llr + b * n_cols * z;
  if (num_iter == 0) {
    for (int u = g; u < n_cols * z; u += n_threads) gl_b[u] = gm_b[u];
    return;
  }
  const size_t estride = static_cast<size_t>(batch) * z;  // edge to edge
  const size_t tstride = estride * n_edges;               // iteration
  const float* tape_b = tape + b * z;
  for (int u = threadIdx.x; u < plan_len; u += blockDim.x) tab[u] = plan[u];
  if constexpr (kStaged) {
    const int t = num_iter - 1;
    stage_rows(stage + (t & 1) * tape_floats, tape_b + t * tstride, estride,
               n_edges, z);
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  // every block of the cluster is running (and has its plan) before any
  // slot of another block is written
  phase_barrier<kMulti>();
  const int* row_ptr = tab + tab[fl::kRowPtr];
  const int* row_slot = tab + tab[fl::kRowSlot];
  const int* row_range = tab + tab[fl::kRowRange];
  const int* col_ptr = tab + tab[fl::kColPtr];
  const int* col_slot = tab + tab[fl::kColSlot];
  const int* col_shift = tab + tab[fl::kColShift];
  const int* reg_rows = tab + tab[fl::kRegRows];
  const int* reg_pos = tab + tab[fl::kRegPos];
  const int* reg_col = tab + tab[fl::kRegCol];
  const int* reg_shift = tab + tab[fl::kRegShift];
  const int* plain_rows = tab + tab[fl::kPlainRows];
  const int* vn_cols = tab + tab[fl::kVnCols];
  const int n_reg_units = n_reg_rows * z;
  // register edges of CN units g + k * n_threads: dL/dv2c, dL/dc2v
  float reg_gv[kRegUnits], reg_gc[kRegUnits];
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    reg_gv[k] = 0.f;
    reg_gc[k] = 0.f;
  }

  for (int it = num_iter - 1; it >= 0; --it) {
    const bool last = it == num_iter - 1;
    // the rows of tape[it]: row position p of a row at rows + p * rstride
    const float* rows;
    size_t rstride;
    if constexpr (kStaged) {
      rows = stage + (it & 1) * tape_floats;
      rstride = z;
      if (it > 0) {  // the buffer iteration it + 1 read
        stage_rows(stage + ((it - 1) & 1) * tape_floats,
                   tape_b + (it - 1) * tstride, estride, n_edges, z);
      }
    } else {
      rows = tape_b + it * tstride;
      rstride = estride;
    }
    // CN forward, rows with a register edge, then that edge's degree-1
    // column's VN reverse by the same thread: h = dL/dv2c * clip'(sum -
    // c2v); dL/dsum = dL/dmarg * clip'(sum) (last iteration) or h;
    // dL/dc2v = dL/dsum - h
#pragma unroll 1
    for (int k = 0; k < kRegUnits; ++k) {
      const int q = g + k * n_threads;
      if (q >= n_reg_units) break;
      const int ri = q / z;
      const int l = q - ri * z;
      const int r = reg_rows[ri];
      const int p0 = row_ptr[r];
      float c2v = 0.f;
      with_degree(row_ptr[r + 1] - p0, [&](auto dc) {
        c2v = cn_unit_forward<decltype(dc)::value, kMulti>(
            slab_c, row_slot + p0, row_range + p0, rows + p0 * rstride,
            rstride, z, l, reg_pos[ri], clip, offset, mode);
      });
      int j = l + reg_shift[ri];
      if (j >= z) j -= z;
      const int vn = reg_col[ri] * z + j;
      const float gv = reg_get(reg_gv, k);
      const float tot = llr_b[vn] + c2v;
      float gt = 0.f;
      if (last) {
        gt = gm_b[vn] * d_clip(tot, clip);
      } else {
        gt = gt + gv * d_clip(tot - c2v, clip);
      }
      const float h = last ? 0.f : gv * d_clip(tot - c2v, clip);
      reg_set(reg_gc, k, gt - h);
      gl_b[vn] = (last ? 0.f : gl_b[vn]) + gt;
    }
    // CN forward, the other rows
#pragma unroll 1
    for (int u = g; u < n_plain_rows * z; u += n_threads) {
      const int ri = u / z;
      const int l = u - ri * z;
      const int r = plain_rows[ri];
      const int p0 = row_ptr[r];
      with_degree(row_ptr[r + 1] - p0, [&](auto dc) {
        cn_unit_forward<decltype(dc)::value, kMulti>(
            slab_c, row_slot + p0, row_range + p0, rows + p0 * rstride,
            rstride, z, l, -1, clip, offset, mode);
      });
    }
    phase_barrier<kMulti>();
    // VN reverse of the other columns, as above over the column's edges:
    // dL/dsum = dL/dmarg * clip'(sum) or the sum of the h_e; dL/dc2v_e =
    // dL/dsum - h_e, written over c2v_e
#pragma unroll 1
    for (int u = g; u < n_vn_cols * z; u += n_threads) {
      const int ci = u / z;
      const int j = u - ci * z;
      const int c = vn_cols[ci];
      const int p0 = col_ptr[c];
      const int p1 = col_ptr[c + 1];
      const int vn = c * z + j;
      float tot = llr_b[vn];
      for (int p = p0; p < p1; ++p) {
        int l = j - col_shift[p];
        if (l < 0) l += z;
        tot = tot + *slot_ptr<kMulti>(slab_c, col_slot[p], z, l);
      }
      float gt = 0.f;
      if (last) {
        gt = gm_b[vn] * d_clip(tot, clip);
      } else {
        for (int p = p0; p < p1; ++p) {
          int l = j - col_shift[p];
          if (l < 0) l += z;
          gt = gt + *slot_ptr<kMulti>(slab_g, col_slot[p], z, l) *
                        d_clip(tot - *slot_ptr<kMulti>(slab_c, col_slot[p],
                                                       z, l),
                               clip);
        }
      }
      for (int p = p0; p < p1; ++p) {
        int l = j - col_shift[p];
        if (l < 0) l += z;
        float* sc = slot_ptr<kMulti>(slab_c, col_slot[p], z, l);
        const float h =
            last ? 0.f
                 : *slot_ptr<kMulti>(slab_g, col_slot[p], z, l) *
                       d_clip(tot - *sc, clip);
        *sc = gt - h;
      }
      gl_b[vn] = (last ? 0.f : gl_b[vn]) + gt;
    }
    phase_barrier<kMulti>();
    // CN adjoint: dL/dv2c of each (row, lane) unit
#pragma unroll 1
    for (int k = 0; k < kRegUnits; ++k) {
      const int q = g + k * n_threads;
      if (q >= n_reg_units) break;
      const int ri = q / z;
      const int l = q - ri * z;
      const int r = reg_rows[ri];
      const int p0 = row_ptr[r];
      const float gc = reg_get(reg_gc, k);
      float gv = 0.f;
      with_degree(row_ptr[r + 1] - p0, [&](auto dc) {
        gv = cn_unit_adjoint<decltype(dc)::value, kMulti>(
            slab_c, slab_g, row_slot + p0, row_range + p0,
            rows + p0 * rstride, rstride, z, l, reg_pos[ri], gc, clip,
            offset, mode);
      });
      reg_set(reg_gv, k, gv);
    }
#pragma unroll 1
    for (int u = g; u < n_plain_rows * z; u += n_threads) {
      const int ri = u / z;
      const int l = u - ri * z;
      const int r = plain_rows[ri];
      const int p0 = row_ptr[r];
      with_degree(row_ptr[r + 1] - p0, [&](auto dc) {
        cn_unit_adjoint<decltype(dc)::value, kMulti>(
            slab_c, slab_g, row_slot + p0, row_range + p0,
            rows + p0 * rstride, rstride, z, l, -1, 0.f, clip, offset, mode);
      });
    }
    if constexpr (kStaged) {
      asm volatile("cp.async.wait_all;" ::: "memory");  // tape[it - 1]
    }
    phase_barrier<kMulti>();
  }
  // iteration 0's v2c = clip(llr): dL/dllr += clip'(llr) * sum of dL/dv2c
#pragma unroll 1
  for (int k = 0; k < kRegUnits; ++k) {
    const int q = g + k * n_threads;
    if (q >= n_reg_units) break;
    const int ri = q / z;
    int j = q - ri * z + reg_shift[ri];
    if (j >= z) j -= z;
    const int vn = reg_col[ri] * z + j;
    float acc = 0.f;
    acc = acc + reg_get(reg_gv, k);
    gl_b[vn] += d_clip(llr_b[vn], clip) * acc;
  }
#pragma unroll 1
  for (int u = g; u < n_vn_cols * z; u += n_threads) {
    const int ci = u / z;
    const int j = u - ci * z;
    const int c = vn_cols[ci];
    const int p0 = col_ptr[c];
    const int p1 = col_ptr[c + 1];
    if (p0 == p1) continue;
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      int l = j - col_shift[p];
      if (l < 0) l += z;
      acc = acc + *slot_ptr<kMulti>(slab_g, col_slot[p], z, l);
    }
    gl_b[c * z + j] += d_clip(llr_b[c * z + j], clip) * acc;
  }
  // no block leaves while another reads its slots
  if constexpr (kMulti) phase_barrier<kMulti>();
}

template <bool kMulti, bool kStaged>
cudaError_t launch_reverse(const float* llr, const int* plan,
                           const float* g_marg, const float* tape,
                           float* g_llr, int batch, int n_cols, int n_edges,
                           int z, int n_reg_rows, int n_plain_rows,
                           int n_vn_cols, int slab_floats, int plan_len,
                           int num_iter, float clip, float offset, int mode,
                           int threads, int cluster, cudaStream_t stream) {
  auto kernel = flooding_reverse_kernel<kMulti, kStaged>;
  const size_t smem =
      ((kStaged ? 2 * static_cast<size_t>(n_edges) * z : 0) +
       2 * static_cast<size_t>(slab_floats) + plan_len) * 4;
  // the opt-in shared memory, set once per layout that needs more
  static size_t opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
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
  return cudaLaunchKernelEx(&cfg, kernel, llr, plan, g_marg, tape, g_llr,
                            batch, n_cols, n_edges, z, n_reg_rows,
                            n_plain_rows, n_vn_cols, slab_floats, plan_len,
                            num_iter, clip, offset, mode);
}

}  // namespace

extern "C" {

// K5f. llr, out: [batch, n_cols * z] f32 (CUDA); plan: the int32 plan of
// `lifted_bp_layout` (K1's; plan_len ints, on the card), whose shared
// slots take state_floats floats per block, with edges numbered row by
// row; tape: [num_iter, n_edges, batch, z]; threads per block and cluster
// blocks per codeword as the layout gives them. mode 0 boxplus, 1
// (offset) min-sum. Launches on `stream` and returns the CUDA error code
// (0 on success).
int sionna_ldpc_flooding_tape(const float* llr, const int* plan, float* out,
                              float* tape, int batch, int n_cols,
                              int n_edges, int z, int n_reg_rows,
                              int n_plain_rows, int n_vn_cols,
                              int state_floats, int plan_len, int num_iter,
                              float clip, float offset, int mode,
                              int threads, int cluster, void* stream) {
  if (fl::bad_layout(batch, z, n_reg_rows, num_iter, mode, threads, cluster,
                     plan_len) ||
      n_edges <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = sionna_ldpc::launch_per_codeword(
      cluster > 1 ? flooding_tape_kernel<true> : flooding_tape_kernel<false>,
      cluster > 1, batch, cluster, threads,
      fl::smem_bytes(state_floats, plan_len),
      static_cast<cudaStream_t>(stream), llr, plan, out,
      fl::TapeRows{tape, static_cast<size_t>(batch) * z, n_edges}, n_cols,
      z, n_reg_rows, n_plain_rows, n_vn_cols, state_floats, plan_len,
      num_iter, clip, offset, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K5b. g_marg, g_llr: [batch, n_cols * z]; tape as K5f wrote it; plan:
// the int32 plan of `flooding_grad_layout` (plan_len ints, on the card),
// whose slabs take slab_floats floats each per block; staged == 1 copies
// the tape rows ahead into shared memory (one block only); threads per
// block and cluster blocks per codeword as the layout gives them. Other
// arguments as K5f's.
int sionna_ldpc_flooding_reverse(const float* llr, const int* plan,
                                 const float* g_marg, const float* tape,
                                 float* g_llr, int batch, int n_cols,
                                 int n_edges, int z, int n_reg_rows,
                                 int n_plain_rows, int n_vn_cols,
                                 int slab_floats, int staged, int plan_len,
                                 int num_iter, float clip, float offset,
                                 int mode, int threads, int cluster,
                                 void* stream) {
  if (batch <= 0 || n_cols <= 0 || n_edges <= 0 || z <= 0 || z > 0xffff ||
      num_iter < 0 || (mode != 0 && mode != 1) ||
      (staged != 0 && staged != 1) || (staged && cluster != 1) ||
      threads <= 0 || threads > kBMaxThreads || threads % 32 != 0 ||
      cluster < 1 || cluster > kBMaxCluster || slab_floats < 0 ||
      n_reg_rows * z > kRegUnits * threads * cluster ||
      plan_len < fl::kHeader) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = cluster > 1 ? launch_reverse<true, false>
            : staged    ? launch_reverse<false, true>
                        : launch_reverse<false, false>;
  const cudaError_t err =
      go(llr, plan, g_marg, tape, g_llr, batch, n_cols, n_edges, z,
         n_reg_rows, n_plain_rows, n_vn_cols, slab_floats, plan_len,
         num_iter, clip, offset, mode, threads, cluster, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
