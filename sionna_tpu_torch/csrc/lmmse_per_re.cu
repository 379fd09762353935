// Whitened LMMSE equalization with a noise covariance S of its own for each
// resource element (RE): lmmse_equalizer(y, h, s, whiten_interference=True)
// in sionna_tpu_torch/phy/mimo/equalization.py for M <= 4 receive antennas
// and K <= 4 streams, one launch for all REs. The OFDM detectors hand it
// such an S: no I + diag(sum of the channel estimates' error variances) +
// H_u H_u^H, a value per RE.
//
// Replaces no Pallas kernel: the JAX package leaves this algebra to XLA (the
// unrolled helpers of its phy/utils/linalg.py). It was added because the
// port's unrolled path runs each step of the 4 x 4 factor, its inverse, the
// whitening products and the K x K solve as a separate tensor operation
// over every RE (about 190 of them), each writing its result to device
// memory: 15.6 ms an MC iteration at the 273-PRB PUSCH's 2,935,296 REs on
// an H100.
//
// For each RE, in the plain path's order (utils/linalg.py's small_cholesky,
// _small_solve_lower, _matmul and cholesky_solve):
//   S = L L^H, L^-1 by forward substitution against the identity,
//   y_w = L^-1 y, H_w = L^-1 H (sums over the columns of L^-1 in increasing
//   order), A = H_w^H H_w + I = C C^H (sums over the rows in increasing
//   order), G = A^-1 H_w^H a column at a time (C z = conj(row r of H_w),
//   then C^H g = z), d = diag(G H_w), x_hat = G y_w / d,
//   no_eff = Re(1 / d) - 1.
// All in float32 on complex64 data; divisions and square roots are
// IEEE-rounded (no fast math). A division by a real Cholesky diagonal c is
// a product with 1 / c, which is what Smith's complex division (c10::complex,
// NumPy) computes for a divisor with a zero imaginary part; the divisions by
// the complex d are Smith's algorithm itself. Only S's lower triangle and
// the real part of its diagonal are read, as the plain path reads them; a
// non-positive-definite S gives NaN (the square root of a negative), as the
// plain path's unrolled factor does.
//
// What bounds it on an H100: bytes. Each RE reads y (M complex64), h (M x K)
// and S (M x M) and writes x_hat (K complex64) and no_eff (K float32): at
// M = 4, K = 2, 32 + 64 + 128 + 16 + 8 = 248 B, 728 MB at the PUSCH's
// 2,935,296 REs, 0.217 ms at 3.35 TB/s. The arithmetic is a few hundred
// FP32 operations an RE (under 1 GFLOP), so it hides under the loads.
//
// Design:
// - One thread for each RE, all of its algebra unrolled in registers: one
//   template instance for each (M, K), 1 to 4 each.
// - The batch is walked as rows of REs: the innermost batch dimension (the
//   longest run the three layouts share) gives the columns, up to three
//   outer dimensions the rows, each input with strides of its own (0 where
//   it is broadcast), so that the OFDM detectors' permuted views of y and h
//   are read where they lie, without a copy.
// - A tile is kThreads consecutive REs of one row. Blocks are persistent,
//   as many as the card holds at once, each walking tiles. A tile's y, h and
//   S's lower triangle are staged with 8-byte cp.async copies into one
//   record per RE in shared memory, in the order that puts neighbouring
//   threads on neighbouring addresses: RE by RE where an input's REs lie
//   next to each other (y and h of the OFDM detectors, one plane per
//   antenna and stream), value by value where an RE's values do (S, 128 B
//   a RE). The record's pitch is odd in 8-byte words, so the threads of a
//   half warp reach 16 different bank pairs in either order.
// - Each thread copies its record into registers, the block syncs, and the
//   next tile's copy is issued into the same buffer while the thread solves
//   its RE: the registers are the pipeline's second stage, and the blocks
//   of an SM overlap each other's copies.
// - x_hat and no_eff are written with streaming stores (the demapper reads
//   them once), 16 bytes a store where the row allows it.
// - Launches on the caller's stream, allocates nothing, and returns
//   cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// The largest M and K (utils/linalg.py's _SMALL_M) and the batch
// dimensions outside the columns (equalization.py's _PER_RE_ROW_DIMS), as
// defines on nvcc's command line from their one source; launch_mk's switch
// has an instance for each M and K up to the first.
#if !defined(SIONNA_LMMSE_PER_RE_MAX_DIM) || \
    !defined(SIONNA_LMMSE_PER_RE_ROW_DIMS)
#error "build with the kernel's defines (sionna_tpu_torch/phy/mimo/equalization.py)"
#endif
constexpr int kMaxDim = SIONNA_LMMSE_PER_RE_MAX_DIM;
static_assert(kMaxDim == 4, "launch_mk instantiates M and K up to 4");
constexpr int kRowDims = SIONNA_LMMSE_PER_RE_ROW_DIMS;
constexpr int kThreads = 128;  // REs a tile, one a thread

// One input's layout, in complex values: the stride of a column, of each
// row dimension, and of the RE's first and second index (a row and a
// column of h or S; y has one); and whether its REs lie closer together
// than its values (then a thread stages its own RE's values).
struct Strides {
  long long col, row[kRowDims], e0, e1;
  bool by_re;
};

struct Layout {
  int cols;                 // REs a row
  int rows;                 // rows, the product of row_size
  int row_size[kRowDims];   // the row dimensions, innermost first
  Strides y, h, s;
};

// acc += a b
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}
// acc += conj(a) b
__device__ __forceinline__ void cmac_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}
// acc -= a b
__device__ __forceinline__ void cmsub(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(-a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}
// acc -= a conj(b)
__device__ __forceinline__ void cmsub_bconj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}
// acc -= conj(a) b
__device__ __forceinline__ void cmsub_aconj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(-a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}
__device__ __forceinline__ float2 scale(float2 v, float r) {
  return make_float2(v.x * r, v.y * r);
}

// a / b by Smith's algorithm, as c10::complex divides.
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float ac = fabsf(b.x), ad = fabsf(b.y);
  if (ac >= ad) {
    if (ac == 0.f && ad == 0.f) return make_float2(a.x / ac, a.y / ad);
    const float rat = b.y / b.x;
    const float scl = 1.0f / (b.x + b.y * rat);
    return make_float2((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
  }
  const float rat = b.x / b.y;
  const float scl = 1.0f / (b.y + b.x * rat);
  return make_float2((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An RE's record in shared memory, in complex values: h (M x K, row-major),
// y (M), S's lower triangle by rows (M (M + 1) / 2), padded to an odd
// number of values.
template <int kM, int kK>
struct Record {
  static constexpr int kH = kM * kK;
  static constexpr int kY = kM;
  static constexpr int kS = kM * (kM + 1) / 2;
  static constexpr int kLen = kH + kY + kS;
  static constexpr int kPitch = kLen % 2 == 1 ? kLen : kLen + 1;
  static constexpr size_t kSmem =
      static_cast<size_t>(kThreads) * kPitch * sizeof(float2);
};

// The offset of value e of an input's part of the record from its RE's
// first value: h by rows of kCols, S's lower triangle by rows (kCols 0), y
// one index (kCols 1).
template <int kCols>
__device__ __forceinline__ long long value_offset(int e, const Strides& st) {
  if constexpr (kCols == 0) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    return i * st.e0 + (e - i * (i + 1) / 2) * st.e1;
  } else {
    return (e / kCols) * st.e0 + (e % kCols) * st.e1;
  }
}

// Copies the kLen values (an input's part) of each of `uses` REs of the
// tile (src: the tile's first RE) into the field at `at` of their records:
// RE by RE (thread c copies RE c's values) or value by value (consecutive
// threads on consecutive values of an RE), as Strides::by_re says.
template <int kPitch, int kLen, int kCols>
__device__ __forceinline__ void stage(float2* tile, const float2* src,
                                      const Strides& st, int uses, int at) {
  if (st.by_re) {
    const int c = threadIdx.x;
    if (c < uses) {
#pragma unroll
      for (int e = 0; e < kLen; ++e) {
        cp_async8(tile + c * kPitch + at + e,
                  src + c * st.col + value_offset<kCols>(e, st));
      }
    }
  } else {
    for (int q = threadIdx.x; q < uses * kLen; q += kThreads) {
      const int c = q / kLen, e = q - c * kLen;
      cp_async8(tile + c * kPitch + at + e,
                src + c * st.col + value_offset<kCols>(e, st));
    }
  }
}

template <int kK>
__device__ __forceinline__ void store(float2* __restrict__ xo,
                                      float* __restrict__ no,
                                      const float2 (&x)[kK],
                                      const float (&ne)[kK]) {
  if constexpr (kK == 4) {
    float4* xv = reinterpret_cast<float4*>(xo);
    __stcs(xv, make_float4(x[0].x, x[0].y, x[1].x, x[1].y));
    __stcs(xv + 1, make_float4(x[2].x, x[2].y, x[3].x, x[3].y));
    __stcs(reinterpret_cast<float4*>(no),
           make_float4(ne[0], ne[1], ne[2], ne[3]));
  } else if constexpr (kK == 2) {
    __stcs(reinterpret_cast<float4*>(xo),
           make_float4(x[0].x, x[0].y, x[1].x, x[1].y));
    __stcs(reinterpret_cast<float2*>(no), make_float2(ne[0], ne[1]));
  } else {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      __stcs(xo + k, x[k]);
      __stcs(no + k, ne[k]);
    }
  }
}

// Cholesky factor of the Hermitian n x n matrix whose lower triangle is a
// (rows i >= j; the imaginary part of the diagonal unread) as
// utils/linalg.py's small_cholesky orders it: the strict lower triangle
// into l, the reciprocals of the (real) diagonal into inv.
template <int kN>
__device__ __forceinline__ void cholesky(const float2 (&a)[kN][kN],
                                         float2 (&l)[kN][kN],
                                         float (&inv)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float djj = a[j][j].x;
#pragma unroll
    for (int p = 0; p < j; ++p) {
      djj = fmaf(-l[j][p].x, l[j][p].x, djj);
      djj = fmaf(-l[j][p].y, l[j][p].y, djj);
    }
    inv[j] = 1.0f / sqrtf(djj);
#pragma unroll
    for (int i = j + 1; i < kN; ++i) {
      float2 v = a[i][j];
#pragma unroll
      for (int p = 0; p < j; ++p) cmsub_bconj(v, l[i][p], l[j][p]);
      l[i][j] = scale(v, inv[j]);
    }
  }
}

// One RE: h, y and S's lower triangle from its record, in registers.
template <int kM, int kK>
__device__ __forceinline__ void equalize(
    const float2 (&rec)[Record<kM, kK>::kLen],
    float2* __restrict__ xo, float* __restrict__ no) {
  using Rec = Record<kM, kK>;
  float2 h[kM][kK], y[kM], s[kM][kM];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int k = 0; k < kK; ++k) h[i][k] = rec[i * kK + k];
    y[i] = rec[Rec::kH + i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      s[i][j] = rec[Rec::kH + kM + i * (i + 1) / 2 + j];
    }
  }
  // S = L L^H, then L^-1 row by row: (e_i - sum_{p < i} L[i][p] L^-1[p])
  // / L[i][i], nonzero only up to the diagonal
  float2 l[kM][kM], linv[kM][kM];
  float inv[kM];
  cholesky<kM>(s, l, inv);
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int c = 0; c <= i; ++c) {
      float2 v = make_float2(c == i ? 1.f : 0.f, 0.f);
#pragma unroll
      for (int p = c; p < i; ++p) cmsub(v, l[i][p], linv[p][c]);
      linv[i][c] = scale(v, inv[i]);
    }
  }
  // y_w = L^-1 y and H_w = L^-1 H in place, last row first (row i reads
  // rows <= i)
#pragma unroll
  for (int i = kM - 1; i >= 0; --i) {
    float2 hw[kK], yw = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kK; ++k) hw[k] = make_float2(0.f, 0.f);
#pragma unroll
    for (int p = 0; p <= i; ++p) {
#pragma unroll
      for (int k = 0; k < kK; ++k) cmac(hw[k], linv[i][p], h[p][k]);
      cmac(yw, linv[i][p], y[p]);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) h[i][k] = hw[k];
    y[i] = yw;
  }
  // A = H_w^H H_w + I (lower triangle), summed over the rows in increasing
  // order, as the plain path's products sum
  float2 a[kK][kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kM; ++r) cmac_conj(v, h[r][i], h[r][j]);
      a[i][j] = v;
    }
    a[i][i].x += 1.0f;
  }
  float2 c[kK][kK];
  float cinv[kK];
  cholesky<kK>(a, c, cinv);
  // G = A^-1 H_w^H a column at a time (column r: A^-1 conj(row r of H_w)),
  // each used at once for d = diag(G H_w) and G y_w
  float2 d[kK], gy[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    d[k] = make_float2(0.f, 0.f);
    gy[k] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int r = 0; r < kM; ++r) {
    float2 g[kK];
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      g[i] = make_float2(h[r][i].x, -h[r][i].y);
#pragma unroll
      for (int p = 0; p < i; ++p) cmsub(g[i], c[i][p], g[p]);
      g[i] = scale(g[i], cinv[i]);
    }
#pragma unroll
    for (int i = kK - 1; i >= 0; --i) {
#pragma unroll
      for (int p = i + 1; p < kK; ++p) cmsub_aconj(g[i], c[p][i], g[p]);
      g[i] = scale(g[i], cinv[i]);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      cmac(d[k], g[k], h[r][k]);
      cmac(gy[k], g[k], y[r]);
    }
  }
  float2 x[kK];
  float ne[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    x[k] = cdiv(gy[k], d[k]);
    ne[k] = cdiv(make_float2(1.f, 0.f), d[k]).x - 1.0f;
  }
  store<kK>(xo, no, x, ne);
}

// Tile tl's row, its first column and, for each input, the offset (in
// complex values) of its first RE.
struct TileAt {
  int row, first;
  long long y, h, s;
};
__device__ __forceinline__ TileAt tile_at(int tl, int tiles_per_row,
                                          const Layout& lay) {
  TileAt at;
  at.row = tl / tiles_per_row;
  at.first = (tl - at.row * tiles_per_row) * kThreads;
  at.y = at.first * lay.y.col;
  at.h = at.first * lay.h.col;
  at.s = at.first * lay.s.col;
  int rest = at.row;
#pragma unroll
  for (int d = 0; d < kRowDims; ++d) {
    const int next = rest / lay.row_size[d];
    const int idx = rest - next * lay.row_size[d];
    rest = next;
    at.y += idx * lay.y.row[d];
    at.h += idx * lay.h.row[d];
    at.s += idx * lay.s.row[d];
  }
  return at;
}

template <int kM, int kK>
__global__ void __launch_bounds__(kThreads)
    lmmse_per_re_kernel(const float2* __restrict__ y,
                        const float2* __restrict__ h,
                        const float2* __restrict__ s,
                        float2* __restrict__ x_hat,
                        float* __restrict__ no_eff, const Layout lay,
                        int tiles_per_row, int tiles) {
  using Rec = Record<kM, kK>;
  constexpr int kPitch = Rec::kPitch;
  extern __shared__ float4 smem[];
  float2* tile = reinterpret_cast<float2*>(smem);

  auto load = [&](int tl) {
    const TileAt at = tile_at(tl, tiles_per_row, lay);
    const int uses = lay.cols - at.first < kThreads ? lay.cols - at.first
                                                    : kThreads;
    stage<kPitch, Rec::kH, kK>(tile, h + at.h, lay.h, uses, 0);
    stage<kPitch, Rec::kY, 1>(tile, y + at.y, lay.y, uses, Rec::kH);
    stage<kPitch, Rec::kS, 0>(tile, s + at.s, lay.s, uses,
                              Rec::kH + Rec::kY);
    cp_async_commit();
  };

  int tl = blockIdx.x;  // < tiles: the grid is at most the tile count
  load(tl);
  for (; tl < tiles; tl += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the tile is in place
    float2 rec[Rec::kLen];
#pragma unroll
    for (int q = 0; q < Rec::kLen; ++q) {
      rec[q] = tile[threadIdx.x * kPitch + q];
    }
    __syncthreads();  // every record read: the buffer takes the next tile
    if (tl + static_cast<int>(gridDim.x) < tiles) load(tl + gridDim.x);
    const int row = tl / tiles_per_row;
    const int col = (tl - row * tiles_per_row) * kThreads + threadIdx.x;
    if (col < lay.cols) {
      const long long u = static_cast<long long>(row) * lay.cols + col;
      equalize<kM, kK>(rec, x_hat + u * kK, no_eff + u * kK);
    }
  }
}

template <int kM, int kK>
cudaError_t launch(const void* y, const void* h, const void* s, void* x_hat,
                   void* no_eff, const Layout& lay, cudaStream_t stream) {
  const auto kernel = lmmse_per_re_kernel<kM, kK>;
  const size_t smem = Record<kM, kK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_per_row = (lay.cols + kThreads - 1) / kThreads;
  const int tiles = lay.rows * tiles_per_row;  // checked by the caller
  const int resident = per_sm * sms;
  const int grid = tiles < resident ? tiles : resident;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(h),
      static_cast<const float2*>(s), static_cast<float2*>(x_hat),
      static_cast<float*>(no_eff), lay, tiles_per_row, tiles);
  return cudaGetLastError();
}

template <int kM>
cudaError_t launch_k(const void* y, const void* h, const void* s,
                     void* x_hat, void* no_eff, const Layout& lay, int k,
                     cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch<kM, 1>(y, h, s, x_hat, no_eff, lay, stream);
    case 2:
      return launch<kM, 2>(y, h, s, x_hat, no_eff, lay, stream);
    case 3:
      return launch<kM, 3>(y, h, s, x_hat, no_eff, lay, stream);
    default:
      return launch<kM, 4>(y, h, s, x_hat, no_eff, lay, stream);
  }
}

cudaError_t launch_mk(const void* y, const void* h, const void* s,
                      void* x_hat, void* no_eff, const Layout& lay, int m,
                      int k, cudaStream_t stream) {
  switch (m) {
    case 1:
      return launch_k<1>(y, h, s, x_hat, no_eff, lay, k, stream);
    case 2:
      return launch_k<2>(y, h, s, x_hat, no_eff, lay, k, stream);
    case 3:
      return launch_k<3>(y, h, s, x_hat, no_eff, lay, k, stream);
    default:
      return launch_k<4>(y, h, s, x_hat, no_eff, lay, k, stream);
  }
}

// One input's strides from v (the column's, the rows', the two indices'),
// and whether to stage it RE by RE: where its column stride is no larger
// than the stride of any index that runs over more than one value (n0 and
// n1 values).
Strides read_strides(const long long* v, int n0, int n1) {
  Strides st;
  st.col = v[0];
  for (int d = 0; d < kRowDims; ++d) st.row[d] = v[1 + d];
  st.e0 = v[1 + kRowDims];
  st.e1 = v[2 + kRowDims];
  st.by_re = (n0 == 1 || st.col <= st.e0) && (n1 == 1 || st.col <= st.e1);
  return st;
}

}  // namespace

extern "C" {

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y, h, s: complex64 inputs of one batch of REs on the current card, read
// through `layout` (int64, in complex values): the columns a row, the
// kRowDims row dimensions' sizes (innermost first), then for y, h and s in
// turn the column stride, the kRowDims row strides and the strides of the
// RE's two indices (y's second 0). x_hat: [rows * cols, k] complex64, no_eff:
// [rows * cols, k] float32, contiguous, rows in row-major order of the row
// dimensions. 1 <= m, k <= kMaxDim. Launches on `stream` and returns the
// CUDA error code (0 on success).
int sionna_lmmse_per_re(const void* y, const void* h, const void* s,
                        void* x_hat, void* no_eff, const long long* layout,
                        int m, int k, void* stream) {
  constexpr int kPer = 3 + kRowDims;  // values a Strides
  if (m < 1 || m > kMaxDim || k < 1 || k > kMaxDim || layout[0] < 1 ||
      layout[0] > 0x7fffffffLL - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout lay;
  lay.cols = static_cast<int>(layout[0]);
  long long rows = 1;
  for (int d = 0; d < kRowDims; ++d) {
    if (layout[1 + d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    rows *= layout[1 + d];
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    lay.row_size[d] = static_cast<int>(layout[1 + d]);
  }
  lay.rows = static_cast<int>(rows);
  if (rows * ((lay.cols + kThreads - 1) / kThreads) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* st = layout + 1 + kRowDims;
  lay.y = read_strides(st, m, 1);
  lay.h = read_strides(st + kPer, m, k);
  lay.s = read_strides(st + 2 * kPer, m, m);
  return static_cast<int>(launch_mk(y, h, s, x_hat, no_eff, lay, m, k,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
