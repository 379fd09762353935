// The precoding of a perfectly known channel, as PUSCHReceiver applies it
// (sionna_tpu_torch/phy/nr/pusch_receiver.py, precode_channel): for h
// [b, rx, rxa, tx, P, sym, sc] and each transmitter's precoding matrix w
// [tx, P, L],
//   h_eff[b, rx, rxa, tx, l, sym, sc] = sum_p h[b, rx, rxa, tx, p, sym, sc]
//                                            * w[tx, p, l],
// written as a contiguous complex64 [b, rx, rxa, tx, L, sym, sc] tensor,
// for 1 <= L <= P <= 4.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (a transpose, a matmul and a transpose back). It was added because the
// port's plain path (the same three steps) copies the permuted h to
// contiguous memory and hands cuBLAS 2.9 M batched (4 x 2) x (2 x 2)
// complex products, which it runs in 32 x 32 x 8 tiles: 11.3 ms an MC
// iteration at the 273-PRB PUSCH's h of 64 x 4 x 2 x 14 x 3,276 values on
// an H100.
//
// Numerics: each output is the float32 complex sum over p of h times w,
// p in increasing order, as the GEMM sums; each product is accumulated
// with fused multiply-adds, so the result may differ from the GEMM's only
// by float32 rounding and FMA contraction.
//
// What bounds it on an H100: bytes. Each RE of each (b, rx, rxa, tx) row
// reads P complex64 values and writes L: at P = L = 2, 187.9 MB read and
// 187.9 MB written at the PUSCH's shape, 0.112 ms at 3.35 TB/s. The
// arithmetic is 8 FP32 operations an output value.
//
// Design:
// - h is read in its own layout: its sym and sc axes merged into the
//   columns of a row (one stride), the (b, rx, rxa) axes merged where
//   their strides allow into up to three row dimensions, tx and the port
//   axis each with a stride of its own; the wrapper copies to contiguous
//   only an h whose sym and sc do not merge. No permute, no GEMM.
// - A tile is kThreads x kVec consecutive columns of one (b, rx, rxa, tx)
//   row; the blocks walk the tiles (as many blocks as the card holds at
//   once). Each thread reads its kVec columns of each of the P port planes
//   and writes its kVec columns of each of the L layer planes: neighbouring
//   threads on neighbouring REs, 16 bytes a load and a store (two complex
//   values, kVec = 2) wherever the column stride is 1 and every offset
//   and pointer allows it, else 8 bytes (kVec = 1). h is read once, with
//   evict-first loads.
// - The tile's transmitter's w (P x L complex values, at most 128 bytes)
//   is read into registers at each tile; every thread of a warp reads the
//   same addresses, which the L1 cache serves.
// - One template instance for each (P, L) with L <= P <= 4 and each kVec.
// - Launches on the caller's stream, allocates nothing, and returns
//   cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The row dimensions outside tx (pusch_receiver.py's _PRECODE_ROW_DIMS:
// b, rx and rxa) and the most ports (_PRECODE_MAX_PORTS), as defines on
// nvcc's command line from their one source; the switch over p in
// sionna_precode_channel has an instance for each P up to the second.
#if !defined(SIONNA_PRECODE_ROW_DIMS) || !defined(SIONNA_PRECODE_MAX_PORTS)
#error "build with the kernel's defines (sionna_tpu_torch/phy/nr/pusch_receiver.py)"
#endif
constexpr int kRowDims = SIONNA_PRECODE_ROW_DIMS;
constexpr int kMaxPorts = SIONNA_PRECODE_MAX_PORTS;
static_assert(kMaxPorts == 4, "sionna_precode_channel instantiates P up to 4");
constexpr int kThreads = 256;

struct Layout {
  long long cols;             // REs a row (sym x sc)
  long long col;              // their stride
  int row_size[kRowDims];     // the (b, rx, rxa) dimensions, innermost first
  long long row[kRowDims];    // their strides
  int num_tx;
  long long tx;               // the strides of tx and of the port axis
  long long port;
};

// acc += a b
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

template <int kVec>
struct Values;
template <>
struct Values<1> {
  float2 v[1];
  __device__ __forceinline__ void load(const float2* p) { v[0] = __ldcs(p); }
  __device__ __forceinline__ void store(float2* p) const { *p = v[0]; }
};
template <>
struct Values<2> {
  float2 v[2];
  __device__ __forceinline__ void load(const float2* p) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(q.x, q.y);
    v[1] = make_float2(q.z, q.w);
  }
  __device__ __forceinline__ void store(float2* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x,
                                                v[1].y);
  }
};

template <int kP, int kL, int kVec>
__global__ void __launch_bounds__(kThreads)
    precode_channel_kernel(const float2* __restrict__ h,
                           const float2* __restrict__ w,
                           float2* __restrict__ out, const Layout lay,
                           long long tiles_per_row, long long tiles) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kVec;
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const long long row = tl / tiles_per_row;
    // the thread's first column (kVec 2 needs an even column count, so
    // both of its columns lie in the row)
    const long long c =
        (tl - row * tiles_per_row) * kTile + threadIdx.x * kVec;
    if (c >= lay.cols) continue;
    // row = n * num_tx + t, n over (b, rx, rxa) in row-major order
    const int t = static_cast<int>(row % lay.num_tx);
    long long rest = row / lay.num_tx;
    long long at = t * lay.tx + c * lay.col;
#pragma unroll
    for (int d = 0; d < kRowDims; ++d) {
      const long long next = rest / lay.row_size[d];
      at += (rest - next * lay.row_size[d]) * lay.row[d];
      rest = next;
    }
    float2 wt[kP][kL];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int l = 0; l < kL; ++l) wt[p][l] = __ldg(w + (t * kP + p) * kL + l);
    }
    Values<kVec> hv[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) hv[p].load(h + at + p * lay.port);
    float2* o = out + (row * kL) * lay.cols + c;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      Values<kVec> acc;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        acc.v[v] = make_float2(0.f, 0.f);
#pragma unroll
        for (int p = 0; p < kP; ++p) cmac(acc.v[v], hv[p].v[v], wt[p][l]);
      }
      acc.store(o + l * lay.cols);
    }
  }
}

template <int kP, int kL, int kVec>
cudaError_t launch(const void* h, const void* w, void* out,
                   const Layout& lay, long long rows, cudaStream_t stream) {
  const auto kernel = precode_channel_kernel<kP, kL, kVec>;
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  constexpr long long kTile = static_cast<long long>(kThreads) * kVec;
  const long long tiles_per_row = (lay.cols + kTile - 1) / kTile;
  const long long tiles = rows * tiles_per_row;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(w),
      static_cast<float2*>(out), lay, tiles_per_row, tiles);
  return cudaGetLastError();
}

template <int kP, int kL>
cudaError_t launch_vec(const void* h, const void* w, void* out,
                       const Layout& lay, long long rows, bool wide,
                       cudaStream_t stream) {
  return wide ? launch<kP, kL, 2>(h, w, out, lay, rows, stream)
              : launch<kP, kL, 1>(h, w, out, lay, rows, stream);
}

template <int kP>
cudaError_t launch_l(const void* h, const void* w, void* out,
                     const Layout& lay, long long rows, int l, bool wide,
                     cudaStream_t stream) {
  switch (l) {
    case 1:
      return launch_vec<kP, 1>(h, w, out, lay, rows, wide, stream);
    case 2:
      if constexpr (kP >= 2) {
        return launch_vec<kP, 2>(h, w, out, lay, rows, wide, stream);
      }
      break;
    case 3:
      if constexpr (kP >= 3) {
        return launch_vec<kP, 3>(h, w, out, lay, rows, wide, stream);
      }
      break;
    case 4:
      if constexpr (kP >= 4) {
        return launch_vec<kP, 4>(h, w, out, lay, rows, wide, stream);
      }
      break;
  }
  return cudaErrorInvalidValue;
}

bool even(long long v) { return v % 2 == 0; }

}  // namespace

extern "C" {

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h: complex64 channel on the current card, read through `layout` (int64,
// in complex values): the columns a row and their stride, the kRowDims row
// dimensions' sizes (innermost first) and their strides, num_tx and the
// strides of tx and of the port axis. w: [num_tx, p, l] complex64,
// contiguous. out: [rows * num_tx, l, cols] complex64, contiguous, rows in
// row-major order of the row dimensions. 1 <= l <= p <= 4. Launches on
// `stream` and returns the CUDA error code (0 on success).
int sionna_precode_channel(const void* h, const void* w, void* out,
                           const long long* layout, int p, int l,
                           void* stream) {
  if (p < 1 || p > kMaxPorts || l < 1 || l > p || layout[0] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout lay;
  lay.cols = layout[0];
  lay.col = layout[1];
  long long rows = 1;
  for (int d = 0; d < kRowDims; ++d) {
    if (layout[2 + d] < 1 || layout[2 + d] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lay.row_size[d] = static_cast<int>(layout[2 + d]);
    lay.row[d] = layout[2 + kRowDims + d];
    rows *= layout[2 + d];
  }
  const long long* rest = layout + 2 + 2 * kRowDims;
  if (rest[0] < 1 || rest[0] > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lay.num_tx = static_cast<int>(rest[0]);
  lay.tx = rest[1];
  lay.port = rest[2];
  rows *= lay.num_tx;
  // 16 bytes a thread where every load and store of two columns is
  // aligned: unit column stride, even offsets, 16-byte aligned pointers
  bool wide = lay.col == 1 && even(lay.cols) && even(lay.tx) &&
              even(lay.port) &&
              reinterpret_cast<std::uintptr_t>(h) % 16 == 0 &&
              reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  for (int d = 0; d < kRowDims; ++d) wide = wide && even(lay.row[d]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p) {
    case 1:
      err = launch_l<1>(h, w, out, lay, rows, l, wide, s);
      break;
    case 2:
      err = launch_l<2>(h, w, out, lay, rows, l, wide, s);
      break;
    case 3:
      err = launch_l<3>(h, w, out, lay, rows, l, wide, s);
      break;
    default:
      err = launch_l<4>(h, w, out, lay, rows, l, wide, s);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
