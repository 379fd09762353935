// Whitened LMMSE equalization for a noise covariance S shared by the whole
// batch: lmmse_equalizer(y, h, s, whiten_interference=True) in
// sionna_tpu_torch/phy/mimo/equalization.py, one launch for all channel
// uses.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// and has no kernel here. It was added because the library path on the card
// takes seven batched library calls on tiny matrices (the Cholesky factor
// of S, whose result torch checks on the host, its triangular inverse, the
// two whitening products, H^H H, G H and G y): cuBLAS runs each 16 x 4
// product as a GEMM of 32 x 32 or larger tiles, and every intermediate goes
// to device memory and back. At the 4 x 16 flat MIMO link's 1,048,576
// channel uses that path took 25 ms an MC iteration on an H100.
//
// For each channel use, with S = L L^H:
//   H_w = L^-1 H, y_w = L^-1 y, A = H_w^H H_w + I = C C^H,
//   G = A^-1 H_w^H, d = diag(G H_w), x_hat = G y_w / d,
//   no_eff = Re(1 / d - 1),
// with the products reassociated: H_w replaces H in registers row by row,
// and G is formed a column at a time and used at once, so that neither H_w
// nor G is stored; each sum runs in the order a GEMM takes. All in
// float32 on complex64 data; divisions and square roots are IEEE-rounded
// (no fast math). A division by a real Cholesky diagonal c is a product
// with 1 / c, which is what Smith's complex division (c10::complex, NumPy)
// computes for a divisor with a zero imaginary part; the divisions by the
// complex d are Smith's algorithm itself. S is factored without a check:
// a non-positive-definite S gives NaN (the square root of a negative), as
// jnp.linalg.cholesky does, where torch.linalg.cholesky raises.
//
// What bounds it on an H100: bytes. Each channel use reads h (M x K
// complex64, 512 B at M = 16, K = 4) and y (128 B) and writes x_hat (32 B)
// and no_eff (16 B): 721 MB at the flat link's 1,048,576 channel uses,
// 0.215 ms at 3.35 TB/s. The arithmetic (about 4,800 FMAs a channel use
// at M = 16, K = 4: 2,720 for the whitening, 1,500 for G and its
// products) takes about 0.15 ms at 67 TFLOP/s, so the FMA pipes have to
// stay busy while the loads run.
//
// Design:
// - Persistent blocks, as many as the card holds at once, each walking
//   tiles of kThreads channel uses. A block factors S and forms L^-1 in
//   shared memory once (one warp: lanes on rows for the factor, on columns
//   for the inverse), while its first tile loads: no library call and no
//   host check.
// - A tile is staged with cp.async, 16 bytes a copy (8 where a channel
//   use holds an odd number of values or the data lies off a 16-byte
//   boundary), neighbouring threads on neighbouring addresses, into one
//   record per channel use (h, then y).
//   The record's pitch is an odd number of 16-byte words, so that when
//   each thread reads its own record in 16-byte words, the 8 threads of a
//   shared-memory wavefront hit 8 different groups of banks.
// - Each thread copies its record into registers, the block syncs, and the
//   next tile's copy is issued into the same buffer while the thread
//   solves its channel use: the registers are the pipeline's second stage,
//   and two blocks an SM overlap each other's copies. Rows of L^-1 are
//   read from shared memory as broadcasts; the K x K factor and its solves
//   are unrolled.
// - x_hat and no_eff are written with streaming stores: the demapper reads
//   them once.
// - One variant for each K (1 to 4), at the largest M: a smaller M leaves
//   the rows past it unread (one loop bound, checked at run time).
// - Launches on the caller's stream, allocates nothing, and returns
//   cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// The largest M (equalization.py's _KERNEL_MAX_M, its one source, as a
// define on nvcc's command line). The largest K is that of launch_k's
// switch, one variant each for K = 1 to 4 (_KERNEL_MAX_K there).
#ifndef SIONNA_LMMSE_MAX_M
#error "build with the kernel's define (sionna_tpu_torch/phy/mimo/equalization.py)"
#endif
constexpr int kMaxM = SIONNA_LMMSE_MAX_M;
constexpr int kMaxK = 4;
constexpr int kThreads = 128;  // channel uses a tile, one a thread

// One channel use's record in shared memory, in complex values: h (kMaxM x
// kK, row-major), then y (kMaxM), then 2 of padding. kMaxM is a multiple of
// 4, so the pitch is 2 more than a multiple of 4: an odd number of 16-byte
// words.
template <int kK>
struct Record {
  static constexpr int kY = kMaxM * kK;
  static constexpr int kPitch = kMaxM * (kK + 1) + 2;
  static_assert(kMaxM % 4 == 0 && kPitch % 4 == 2, "record pitch");
  // L, L^-1 (kMaxM x kMaxM each), then the tile
  static constexpr size_t kSmem =
      (2 * kMaxM * kMaxM + static_cast<size_t>(kThreads) * kPitch) *
      sizeof(float2);
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
__device__ __forceinline__ float2 conj(float2 v) {
  return make_float2(v.x, -v.y);
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

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies the `per` consecutive values of each of `uses` channel uses (src:
// the first one's, contiguous) into the field at `at` of their records,
// kV values (8 kV bytes) a copy; copy c of the tile goes to thread
// c % kThreads, so neighbouring threads copy neighbouring addresses.
template <int kPitch, int kV>
__device__ __forceinline__ void stage(float2* tile, const float2* src,
                                      int uses, int per, int at) {
  const int chunks = per / kV;  // copies a channel use
  const int total = uses * chunks;
  int t = threadIdx.x / chunks, q = threadIdx.x - t * chunks;
  const int dt = kThreads / chunks, dq = kThreads - dt * chunks;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    cp_async<8 * kV>(tile + t * kPitch + at + q * kV,
                     src + static_cast<size_t>(c) * kV);
    t += dt;
    q += dq;
    if (q >= chunks) {
      q -= chunks;
      ++t;
    }
  }
}

// L^-1 of S = L L^H ([m, m], row-major) into linv (rows of kMaxM), by the
// 32 threads of one warp; l is kMaxM x kMaxM scratch. Reads S's lower
// triangle and the real part of its diagonal, as torch.linalg.cholesky
// does.
__device__ void inv_cholesky(const float2* __restrict__ s, int m, float2* l,
                             float2* linv) {
  const int lane = threadIdx.x;
  for (int e = lane; e < m * m; e += 32) {
    const int i = e / m, j = e - i * m;
    if (j <= i) l[i * kMaxM + j] = s[e];
  }
  __syncwarp();
  for (int j = 0; j < m; ++j) {
    if (lane == j) {
      float d = l[j * kMaxM + j].x;
      for (int p = 0; p < j; ++p) {
        const float2 v = l[j * kMaxM + p];
        d = fmaf(-v.x, v.x, d);
        d = fmaf(-v.y, v.y, d);
      }
      l[j * kMaxM + j] = make_float2(sqrtf(d), 0.f);
    }
    __syncwarp();
    if (lane > j && lane < m) {
      float2 v = l[lane * kMaxM + j];
      for (int p = 0; p < j; ++p) {
        cmsub_bconj(v, l[lane * kMaxM + p], l[j * kMaxM + p]);
      }
      l[lane * kMaxM + j] = scale(v, 1.0f / l[j * kMaxM + j].x);
    }
    __syncwarp();
  }
  // column c of L^-1 by forward substitution, lane c
  if (lane < m) {
    const int c = lane;
    for (int i = c; i < m; ++i) {
      float2 v = make_float2(i == c ? 1.f : 0.f, 0.f);
      for (int p = c; p < i; ++p) {
        cmsub(v, l[i * kMaxM + p], linv[p * kMaxM + c]);
      }
      linv[i * kMaxM + c] = scale(v, 1.0f / l[i * kMaxM + i].x);
    }
  }
}

// Solves A x = r in place, A = C C^H (C lower, inv its diagonal's
// reciprocals): L y = r, then C^H x = y, as the unrolled m <= 4 helpers of
// phy/utils/linalg.py order them.
template <int kK>
__device__ __forceinline__ void chol_solve(const float2 (&c)[kK][kK],
                                           const float (&inv)[kK],
                                           float2 (&r)[kK]) {
#pragma unroll
  for (int i = 0; i < kK; ++i) {
#pragma unroll
    for (int p = 0; p < i; ++p) cmsub(r[i], c[i][p], r[p]);
    r[i] = scale(r[i], inv[i]);
  }
#pragma unroll
  for (int i = kK - 1; i >= 0; --i) {
#pragma unroll
    for (int p = i + 1; p < kK; ++p) cmsub_aconj(r[i], c[p][i], r[p]);
    r[i] = scale(r[i], inv[i]);
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

// One channel use: h and y in registers (rows < m), linv in shared memory.
template <int kK>
__device__ __forceinline__ void equalize(float2 (&hr)[kMaxM][kK],
                                         float2 (&yr)[kMaxM],
                                         const float2* linv, int m,
                                         float2* __restrict__ xo,
                                         float* __restrict__ no) {
  // H_w and y_w in place of h and y, last row first (row i reads rows <=
  // i)
#pragma unroll
  for (int i = kMaxM - 1; i >= 0; --i) {
    if (i >= m) continue;  // (uniform; a break would stop the unrolling)
    float2 hw[kK], yw = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kK; ++k) hw[k] = make_float2(0.f, 0.f);
    const float2* lrow = linv + i * kMaxM;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float2 lij = lrow[j];
#pragma unroll
      for (int k = 0; k < kK; ++k) cmac(hw[k], lij, hr[j][k]);
      cmac(yw, lij, yr[j]);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) hr[i][k] = hw[k];
    yr[i] = yw;
  }
  // the Gram matrix H_w^H H_w (diagonal gd, upper triangle go), summed
  // over the rows in increasing order, as a GEMM sums (on ill-conditioned
  // channels the order shows in the result)
  float gd[kK];
  float2 go[kK][kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    gd[k] = 0.f;
#pragma unroll
    for (int l = 0; l < kK; ++l) go[k][l] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
    if (i >= m) continue;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      gd[k] = fmaf(hr[i][k].x, hr[i][k].x, gd[k]);
      gd[k] = fmaf(hr[i][k].y, hr[i][k].y, gd[k]);
#pragma unroll
      for (int l = k + 1; l < kK; ++l) cmac_conj(go[k][l], hr[i][k], hr[i][l]);
    }
  }
  // A = Gram + I = C C^H
  float2 c[kK][kK];
  float inv[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    float djj = gd[j] + 1.0f;
#pragma unroll
    for (int p = 0; p < j; ++p) {
      djj = fmaf(-c[j][p].x, c[j][p].x, djj);
      djj = fmaf(-c[j][p].y, c[j][p].y, djj);
    }
    inv[j] = 1.0f / sqrtf(djj);
#pragma unroll
    for (int i = j + 1; i < kK; ++i) {
      float2 v = conj(go[j][i]);  // A[i][j]
#pragma unroll
      for (int p = 0; p < j; ++p) cmsub_bconj(v, c[i][p], c[j][p]);
      c[i][j] = scale(v, inv[j]);
    }
  }
  // G = A^-1 H_w^H a column at a time (column i: A^-1 conj(row i of H_w)),
  // each used at once for d = diag(G H_w) and G y_w. Forming G and its
  // products, and not A^-1 times the Gram matrix, keeps the plain path's
  // accuracy on ill-conditioned channels: there the Gram matrix's rounding
  // largely cancels between G and H_w.
  float2 d[kK], gy[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    d[k] = make_float2(0.f, 0.f);
    gy[k] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
    if (i >= m) continue;
    float2 g[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) g[k] = conj(hr[i][k]);
    chol_solve<kK>(c, inv, g);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      cmac(d[k], g[k], hr[i][k]);
      cmac(gy[k], g[k], yr[i]);
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

template <int kK>
__global__ void __launch_bounds__(kThreads, 2)
    lmmse_whitened_kernel(const float2* __restrict__ y,
                          const float2* __restrict__ h,
                          const float2* __restrict__ s,
                          float2* __restrict__ x_hat,
                          float* __restrict__ no_eff, long long n, int m,
                          int tiles, bool vec_h, bool vec_y) {
  using Rec = Record<kK>;
  constexpr int kPitch = Rec::kPitch;
  extern __shared__ float4 smem[];
  float2* l = reinterpret_cast<float2*>(smem);
  float2* linv = l + kMaxM * kMaxM;
  float2* tile = linv + kMaxM * kMaxM;
  const int mk = m * kK;

  auto load = [&](int tl) {
    const long long first = static_cast<long long>(tl) * kThreads;
    const int uses = static_cast<int>(
        n - first < kThreads ? n - first : kThreads);
    const float2* hs = h + first * mk;
    const float2* ys = y + first * m;
    if (vec_h) {
      stage<kPitch, 2>(tile, hs, uses, mk, 0);
    } else {
      stage<kPitch, 1>(tile, hs, uses, mk, 0);
    }
    if (vec_y) {
      stage<kPitch, 2>(tile, ys, uses, m, Rec::kY);
    } else {
      stage<kPitch, 1>(tile, ys, uses, m, Rec::kY);
    }
    cp_async_commit();
  };

  int tl = blockIdx.x;  // < tiles: the grid is at most the tile count
  load(tl);
  if (threadIdx.x < 32) inv_cholesky(s, m, l, linv);
  for (; tl < tiles; tl += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the tile (and, the first time, L^-1) is in place
    float2 hr[kMaxM][kK], yr[kMaxM];
    const float4* rec =
        reinterpret_cast<const float4*>(tile + threadIdx.x * kPitch);
#pragma unroll
    for (int q = 0; q < kMaxM * kK / 2; ++q) {
      const float4 v = rec[q];
      hr[(2 * q) / kK][(2 * q) % kK] = make_float2(v.x, v.y);
      hr[(2 * q + 1) / kK][(2 * q + 1) % kK] = make_float2(v.z, v.w);
    }
#pragma unroll
    for (int q = 0; q < kMaxM / 2; ++q) {
      const float4 v = rec[Rec::kY / 2 + q];
      yr[2 * q] = make_float2(v.x, v.y);
      yr[2 * q + 1] = make_float2(v.z, v.w);
    }
    __syncthreads();  // every record read: the buffer takes the next tile
    if (tl + static_cast<int>(gridDim.x) < tiles) load(tl + gridDim.x);
    const long long u = static_cast<long long>(tl) * kThreads + threadIdx.x;
    if (u < n) {
      equalize<kK>(hr, yr, linv, m, x_hat + u * kK, no_eff + u * kK);
    }
  }
}

template <int kK>
cudaError_t launch(const void* y, const void* h, const void* s, void* x_hat,
                   void* no_eff, long long n, int m, cudaStream_t stream) {
  const auto kernel = lmmse_whitened_kernel<kK>;
  const size_t smem = Record<kK>::kSmem;
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
  const long long tiles = (n + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  const bool vec_h =
      (m * kK) % 2 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec_y = m % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(h),
      static_cast<const float2*>(s), static_cast<float2*>(x_hat),
      static_cast<float*>(no_eff), n, m, static_cast<int>(tiles), vec_h,
      vec_y);
  return cudaGetLastError();
}

cudaError_t launch_k(const void* y, const void* h, const void* s,
                     void* x_hat, void* no_eff, long long n, int m, int k,
                     cudaStream_t stream) {
  switch (k) {
    case 1:
      return launch<1>(y, h, s, x_hat, no_eff, n, m, stream);
    case 2:
      return launch<2>(y, h, s, x_hat, no_eff, n, m, stream);
    case 3:
      return launch<3>(y, h, s, x_hat, no_eff, n, m, stream);
    default:
      return launch<4>(y, h, s, x_hat, no_eff, n, m, stream);
  }
}

}  // namespace

extern "C" {

const char* sionna_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y: [n, m], h: [n, m, k], s: [m, m] complex64; x_hat: [n, k] complex64,
// no_eff: [n, k] float32; all contiguous on the current card, 1 <= m <=
// kMaxM, 1 <= k <= kMaxK. Launches on `stream` and returns the CUDA error
// code (0 on success).
int sionna_lmmse_whitened(const void* y, const void* h, const void* s,
                          void* x_hat, void* no_eff, long long n, int m,
                          int k, void* stream) {
  if (n < 0 || m < 1 || m > kMaxM || k < 1 || k > kMaxK ||
      (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_k(y, h, s, x_hat, no_eff, n, m, k,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
