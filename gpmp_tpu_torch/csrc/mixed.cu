// gpmp_tpu_torch/csrc/mixed.cu
//
// K3, K4, K5, K7 and K7b: the hand-written kernels of the mixed-precision
// Cholesky engine (gpmp_tpu_torch/ops/mixed.py), and K8s, the residual of
// its sampling root (gpmp_tpu_torch/ops/refine.py), for Hopper, sm_90a.
// Plain C entry points, loaded with ctypes by gpmp_tpu_torch/ops/_build.py.
//
// K3 residual (replaces gpmp_tpu/ops/mixed.py _f64_matvec and the residual
//    norms of refined_cholesky_solve):
//      R = B - K X, and (sum R^2, sum B^2), K (n, n), X and B (n, k <= 8).
//    Bound on the H100: reading K once (8 n^2 bytes in f64) against ~2 k
//    flops per element read: memory-bound (8 MB, ~2.4 us at 3.35 TB/s, at
//    n = 1000).  Design: one warp per row of K, read with consecutive
//    lanes on consecutive columns; the k columns of X are staged in shared
//    memory in 256-row tiles, so each block reads X from L2 once per tile;
//    sums in f64 in registers, warp shuffles, per-block partials, and a
//    second launch reduces the partials in a fixed order (no atomics:
//    bitwise reproducible, so SLSQP sees the same numbers every run).
//
// K4 factorization residual (replaces _factorization_residual_f32):
//      R = K - L L^T, computed in f64 on the lower-triangular tiles only,
//      cast to f32, and written to (i, j) and (j, i): exactly symmetric.
//    Bound: n^3/6 f64 FMAs (3.3e8 flops at n = 1000), ~5 us at the f64
//    tensor-core peak (67 TFLOP/s) against ~4.8 us for its 16 n^2 bytes:
//    compute-bound.  Design: 32 x 32 output tiles, only bi >= bj launched;
//    the k loop stops at the tile's last column, because L is lower
//    triangular; L (f32 in device memory) is promoted to f64 while staged
//    in shared memory.  Plain f64 FMAs on the vector units, no DMMA.
//
// K8s sampling residual (replaces E = K - L L^T of gpmp_tpu/ops/refine.py
//    sampling_sqrt): K4's kernel with an output in K's dtype instead of
//    f32, so E keeps f64 for the sampling root C = L + L (M E M^T) / 2.
//    Same bound (n^3/6 FMAs, 5.0 us at n = 1000, 2.7 ms at n = 8192 at
//    67 TFLOP/s) and design; E is exactly symmetric, where the JAX
//    package's dense product is symmetric only up to roundoff.
//
// K5 diagonal-block triangular inverse (replaces the base case of
//    _block_tri_inv, a batched triangular solve):
//      for each base x base diagonal block A of lower-triangular L32,
//      A^{-1}, a ragged last block completed with the identity.
//    Bound: under 1 MB of traffic at n = 1000 (~0.3 us); in practice
//    latency-bound by the base serial steps of the substitution.  Design:
//    one thread block per diagonal block, A and A^{-1} in dynamic shared
//    memory (2 x 64 KB at base = 128, above the 48 KB default, so the
//    entry raises the limit with cudaFuncSetAttribute), one thread per
//    column: thread c substitutes down its own column, reading row i of A
//    (consecutive words across threads) and its own column of A^{-1}, so
//    the threads never wait on each other.
//
// K7 trace-series sums (replaces the traces of _mp_solve_and_logdet_core
//    and its _series branch):
//      launch 1: (tr H, sum H^2); launch 2: (sum H^2 o H, sum (H^2)^2),
//      products and sums in f64 from f32 H and H^2.
//    Bound: reading H and H^2 once (8 n^2 bytes, ~2.4 us at n = 1000):
//    memory-bound.  Design: grid-stride loops with a grid fixed by n,
//    f64 accumulators, block tree reduction, per-block partials, and the
//    fixed-order second pass shared with K3.  Launch 1 alone lets the host
//    choose the branch before launch 2 reads H^2.
//
// K7b LOO diagonal series (replaces the column sums of
//    gpmp_tpu/ops/mixed.py mp_solve_and_inv_diag):
//      series:    d_j = sum_i M_ij^2 - sum_i M_ij B_ij, M = M32, B (f32),
//                 B = (D - D^2) M, reading M once for both sums;
//      two-level: d_j = sum_i G_ij W_ij (K's dtype).
//    Products and sums in f64 (squares and products of f32 values are exact
//    there).  Bound: reading M and B once (8 n^2 bytes in f32, ~2.4 us at
//    n = 1000): memory-bound.  Design: a block owns 32 consecutive columns
//    (a warp reads 32 consecutive words of a row) and a chunk of rows, 8 rows
//    in flight; the chunks are sized so that ~2 blocks per SM run; each
//    block writes per-column partials, and a second launch sums the chunks
//    of each column in a fixed order (no atomics, bitwise reproducible).
//
// Tensor cores, TMA and wgmma are not used: these kernels are simple and
// right first; making them fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int RED_THREADS = 256;

// out[j] = sum_b partial[b * 2 + j], j in {0, 1}, in a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
reduce_pairs_kernel(const double* __restrict__ partial, long long nblocks,
                    double* __restrict__ out) {
  __shared__ double s0[RED_THREADS];
  __shared__ double s1[RED_THREADS];
  double a = 0.0, b = 0.0;
  for (long long i = threadIdx.x; i < nblocks; i += RED_THREADS) {
    a += partial[2 * i];
    b += partial[2 * i + 1];
  }
  s0[threadIdx.x] = a;
  s1[threadIdx.x] = b;
  __syncthreads();
  for (int h = RED_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      s0[threadIdx.x] += s0[threadIdx.x + h];
      s1[threadIdx.x] += s1[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = s0[0];
    out[1] = s1[0];
  }
}

// Sum of (a, b) over a block of RED_THREADS threads, in a fixed order,
// written by thread 0 to partial[2 * blockIdx.x + {0, 1}].
__device__ void block_pair_to_partial(double a, double b, double* __restrict__ partial) {
  __shared__ double s0[RED_THREADS];
  __shared__ double s1[RED_THREADS];
  s0[threadIdx.x] = a;
  s1[threadIdx.x] = b;
  __syncthreads();
  for (int h = RED_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      s0[threadIdx.x] += s0[threadIdx.x + h];
      s1[threadIdx.x] += s1[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s0[0];
    partial[2 * blockIdx.x + 1] = s1[0];
  }
}

// ---------------------------------------------------------------- K3
constexpr int RES_ROWS = 8;  // rows per block, one warp each
constexpr int RES_THREADS = 32 * RES_ROWS;
constexpr int RES_TILE = 256;  // rows of X staged per step
constexpr int RES_MAX_K = 8;

template <typename T>
__global__ void __launch_bounds__(RES_THREADS)
residual_kernel(const T* __restrict__ K, const T* __restrict__ X, const T* __restrict__ B,
                T* __restrict__ R, double* __restrict__ partial, long long n, int k) {
  __shared__ double xs[RES_TILE * RES_MAX_K];
  __shared__ double rows[RES_ROWS][2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * RES_ROWS + warp;
  double acc[RES_MAX_K];
#pragma unroll
  for (int c = 0; c < RES_MAX_K; ++c) acc[c] = 0.0;

  for (long long c0 = 0; c0 < n; c0 += RES_TILE) {
    const int w = static_cast<int>(n - c0 < RES_TILE ? n - c0 : RES_TILE);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < w * k; t += RES_THREADS)
      xs[t] = static_cast<double>(X[c0 * k + t]);  // X is row-major (n, k)
    __syncthreads();
    if (row < n) {
      const T* Krow = K + row * n + c0;
      for (int j = lane; j < w; j += 32) {
        const double kv = static_cast<double>(Krow[j]);
#pragma unroll
        for (int c = 0; c < RES_MAX_K; ++c)
          if (c < k) acc[c] += kv * xs[j * k + c];
      }
    }
  }

  double rr = 0.0, bb = 0.0;
#pragma unroll
  for (int c = 0; c < RES_MAX_K; ++c) {
    if (c < k) {
      double v = acc[c];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && row < n) {
        const T b = B[row * k + c];
        const T r = static_cast<T>(static_cast<double>(b) - v);
        R[row * k + c] = r;
        rr += static_cast<double>(r) * static_cast<double>(r);
        bb += static_cast<double>(b) * static_cast<double>(b);
      }
    }
  }
  if (lane == 0) {
    rows[warp][0] = rr;
    rows[warp][1] = bb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int wi = 0; wi < RES_ROWS; ++wi) {
      a += rows[wi][0];
      b += rows[wi][1];
    }
    partial[2 * blockIdx.x] = a;
    partial[2 * blockIdx.x + 1] = b;
  }
}

long long residual_blocks(long long n) { return (n + RES_ROWS - 1) / RES_ROWS; }

template <typename T>
int launch_residual(const void* K, const void* X, const void* B, void* R, void* partial,
                    void* norms, long long n, int k, void* stream) {
  if (n <= 0 || k < 1 || k > RES_MAX_K || residual_blocks(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = residual_blocks(n);
  residual_kernel<T><<<static_cast<unsigned>(nb), RES_THREADS, 0, s>>>(
      static_cast<const T*>(K), static_cast<const T*>(X), static_cast<const T*>(B),
      static_cast<T*>(R), static_cast<double*>(partial), n, k);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(norms));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K4
constexpr int FR_TILE = 32;
constexpr int FR_TY = 8;  // block (32, 8): each thread owns 4 rows of a column
constexpr int FR_ROWS = FR_TILE / FR_TY;

template <typename T, typename TOut>
__global__ void __launch_bounds__(FR_TILE * FR_TY)
fact_residual_kernel(const T* __restrict__ K, const float* __restrict__ L,
                     TOut* __restrict__ R, long long n) {
  // blockIdx.x -> lower-triangular tile (bi, bj), bi >= bj
  const long long b = blockIdx.x;
  long long bi = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) / 2.0);
  while (bi * (bi + 1) / 2 > b) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
  const long long bj = b - bi * (bi + 1) / 2;

  __shared__ double As[FR_TILE][FR_TILE + 1];  // L[i0 + r, k0 + c]
  __shared__ double Bs[FR_TILE][FR_TILE + 1];  // L[j0 + r, k0 + c]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i0 = bi * FR_TILE, j0 = bj * FR_TILE;
  double acc[FR_ROWS];
#pragma unroll
  for (int q = 0; q < FR_ROWS; ++q) acc[q] = 0.0;

  // L[j, k] = 0 for k > j: the sum stops at the tile's last column
  const long long kend = (j0 + FR_TILE < n) ? j0 + FR_TILE : n;
  for (long long k0 = 0; k0 < kend; k0 += FR_TILE) {
    const long long gk = k0 + tx;
    for (int r = ty; r < FR_TILE; r += FR_TY) {
      const long long gi = i0 + r, gj = j0 + r;
      As[r][tx] = (gi < n && gk < n) ? static_cast<double>(L[gi * n + gk]) : 0.0;
      Bs[r][tx] = (gj < n && gk < n) ? static_cast<double>(L[gj * n + gk]) : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FR_TILE; ++kk) {
      const double bv = Bs[tx][kk];
#pragma unroll
      for (int q = 0; q < FR_ROWS; ++q) acc[q] += As[ty + FR_TY * q][kk] * bv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < FR_ROWS; ++q) {
    const long long gi = i0 + ty + FR_TY * q, gj = j0 + tx;
    if (gi < n && gj < n && gi >= gj) {
      const TOut v = static_cast<TOut>(static_cast<double>(K[gi * n + gj]) - acc[q]);
      R[gi * n + gj] = v;
      R[gj * n + gi] = v;
    }
  }
}

template <typename T, typename TOut>
int launch_fact_residual(const void* K, const void* L, void* R, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = (n + FR_TILE - 1) / FR_TILE;
  const long long tiles = nt * (nt + 1) / 2;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fact_residual_kernel<T, TOut><<<static_cast<unsigned>(tiles), dim3(FR_TILE, FR_TY), 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<const float*>(L), static_cast<TOut*>(R), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K5
constexpr int TI_MAX_BASE = 128;

__global__ void __launch_bounds__(TI_MAX_BASE)
diag_block_inv_kernel(const float* __restrict__ L, float* __restrict__ out, long long n,
                      int base) {
  extern __shared__ float sm[];
  float* A = sm;                // base x base, the diagonal block
  float* Xs = sm + base * base;  // base x base, its inverse
  const long long r0 = static_cast<long long>(blockIdx.x) * base;
  const int bsz = static_cast<int>(n - r0 < base ? n - r0 : base);
  for (int t = threadIdx.x; t < base * base; t += blockDim.x) {
    const int i = t / base, j = t % base;
    A[t] = (i < bsz && j < bsz) ? L[(r0 + i) * n + r0 + j] : (i == j ? 1.0f : 0.0f);
    Xs[t] = 0.0f;
  }
  __syncthreads();
  // thread c owns column c of the inverse: rows i >= c by forward
  // substitution, X[i][c] = (delta_ic - sum_{c<=k<i} A[i][k] X[k][c]) / A[i][i]
  const int c = threadIdx.x;
  for (int i = c; i < base; ++i) {
    float s = (i == c) ? 1.0f : 0.0f;
    for (int k = c; k < i; ++k) s -= A[i * base + k] * Xs[k * base + c];
    Xs[i * base + c] = s / A[i * base + i];
  }
  __syncthreads();
  float* o = out + static_cast<long long>(blockIdx.x) * base * base;
  for (int t = threadIdx.x; t < base * base; t += blockDim.x) o[t] = Xs[t];
}

int launch_diag_block_inv(const void* L, void* out, long long n, int base, void* stream) {
  if (n <= 0 || base < 1 || base > TI_MAX_BASE) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + base - 1) / base;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * base * base * static_cast<int>(sizeof(float));
  int err = static_cast<int>(cudaFuncSetAttribute(
      diag_block_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  diag_block_inv_kernel<<<static_cast<unsigned>(nb), base, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<float*>(out), n, base);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K7
constexpr long long TS_MAX_BLOCKS = 264;  // two per SM of the H100
constexpr int TS_PER_THREAD = 8;

long long trace_sums_blocks(long long n) {
  const long long per_block = static_cast<long long>(RED_THREADS) * TS_PER_THREAD;
  long long b = (n * n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return b < TS_MAX_BLOCKS ? b : TS_MAX_BLOCKS;
}

__global__ void __launch_bounds__(RED_THREADS)
trace_sums_kernel(const float* __restrict__ H, double* __restrict__ partial, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * RED_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  double tr = 0.0, sq = 0.0;
  for (long long t = first; t < n * n; t += stride) {
    const double h = static_cast<double>(H[t]);
    sq += h * h;
  }
  for (long long i = first; i < n; i += stride) tr += static_cast<double>(H[i * (n + 1)]);
  block_pair_to_partial(tr, sq, partial);
}

__global__ void __launch_bounds__(RED_THREADS)
series_sums_kernel(const float* __restrict__ H, const float* __restrict__ H2,
                   double* __restrict__ partial, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * RED_THREADS;
  double s3 = 0.0, s4 = 0.0;
  for (long long t = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
       t < n * n; t += stride) {
    const double h = static_cast<double>(H[t]);
    const double h2 = static_cast<double>(H2[t]);
    s3 += h2 * h;
    s4 += h2 * h2;
  }
  block_pair_to_partial(s3, s4, partial);
}

// ---------------------------------------------------------------- K7b
constexpr int LD_COLS = 32;
constexpr int LD_TY = 8;
constexpr long long LD_TARGET_BLOCKS = 264;  // two per SM of the H100

long long loo_diag_chunks(long long n) {
  const long long col_blocks = (n + LD_COLS - 1) / LD_COLS;
  long long ch = (LD_TARGET_BLOCKS + col_blocks - 1) / col_blocks;
  const long long max_ch = (n + LD_TY - 1) / LD_TY;  // at least LD_TY rows a chunk
  if (ch > max_ch) ch = max_ch;
  return ch < 1 ? 1 : ch;
}

// SERIES: partial[c, j] = sum over the chunk's rows of A_ij^2 - A_ij B_ij;
// else sum of A_ij B_ij.  A, B (n, n) row-major.
template <typename T, bool SERIES>
__global__ void __launch_bounds__(LD_COLS * LD_TY)
loo_diag_kernel(const T* __restrict__ A, const T* __restrict__ B, double* __restrict__ partial,
                long long n, long long rows_per_chunk) {
  __shared__ double red[LD_TY][LD_COLS];
  const long long j = static_cast<long long>(blockIdx.x) * LD_COLS + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < n ? r0 + rows_per_chunk : n;
  double s = 0.0;
  if (j < n) {
    for (long long i = r0 + threadIdx.y; i < r1; i += LD_TY) {
      const double a = static_cast<double>(A[i * n + j]);
      const double b = static_cast<double>(B[i * n + j]);
      s += SERIES ? a * a - a * b : a * b;
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    double t = 0.0;
    for (int q = 0; q < LD_TY; ++q) t += red[q][threadIdx.x];
    partial[blockIdx.y * n + j] = t;
  }
}

// out[j] = sum_c partial[c, j], chunks in order.
__global__ void __launch_bounds__(RED_THREADS)
loo_diag_reduce_kernel(const double* __restrict__ partial, long long chunks, long long n,
                       double* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (j >= n) return;
  double t = 0.0;
  for (long long c = 0; c < chunks; ++c) t += partial[c * n + j];
  out[j] = t;
}

template <typename T, bool SERIES>
int launch_loo_diag(const void* A, const void* B, void* partial, void* out, long long n,
                    void* stream) {
  if (n <= 0 || (n + LD_COLS - 1) / LD_COLS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = loo_diag_chunks(n);
  const long long rows = (n + chunks - 1) / chunks;
  loo_diag_kernel<T, SERIES><<<dim3(static_cast<unsigned>((n + LD_COLS - 1) / LD_COLS),
                                    static_cast<unsigned>(chunks)),
                               dim3(LD_COLS, LD_TY), 0, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<double*>(partial), n,
      rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  loo_diag_reduce_kernel<<<static_cast<unsigned>((n + RED_THREADS - 1) / RED_THREADS),
                           RED_THREADS, 0, s>>>(static_cast<const double*>(partial), chunks,
                                                n, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long gpmp_residual_blocks(long long n) { return residual_blocks(n); }

int gpmp_residual_f64(const void* K, const void* X, const void* B, void* R, void* partial,
                      void* norms, long long n, int k, void* stream) {
  return launch_residual<double>(K, X, B, R, partial, norms, n, k, stream);
}

int gpmp_residual_f32(const void* K, const void* X, const void* B, void* R, void* partial,
                      void* norms, long long n, int k, void* stream) {
  return launch_residual<float>(K, X, B, R, partial, norms, n, k, stream);
}

int gpmp_fact_residual_f64(const void* K, const void* L, void* R, long long n, void* stream) {
  return launch_fact_residual<double, float>(K, L, R, n, stream);
}

int gpmp_fact_residual_f32(const void* K, const void* L, void* R, long long n, void* stream) {
  return launch_fact_residual<float, float>(K, L, R, n, stream);
}

int gpmp_sampling_residual_f64(const void* K, const void* L, void* R, long long n,
                               void* stream) {
  return launch_fact_residual<double, double>(K, L, R, n, stream);
}

int gpmp_sampling_residual_f32(const void* K, const void* L, void* R, long long n,
                               void* stream) {
  return launch_fact_residual<float, float>(K, L, R, n, stream);
}

long long gpmp_loo_diag_chunks(long long n) { return loo_diag_chunks(n); }

int gpmp_loo_diag_series(const void* M32, const void* B32, void* partial, void* out,
                         long long n, void* stream) {
  return launch_loo_diag<float, true>(M32, B32, partial, out, n, stream);
}

int gpmp_loo_diag_pairs_f64(const void* G, const void* W, void* partial, void* out,
                            long long n, void* stream) {
  return launch_loo_diag<double, false>(G, W, partial, out, n, stream);
}

int gpmp_loo_diag_pairs_f32(const void* G, const void* W, void* partial, void* out,
                            long long n, void* stream) {
  return launch_loo_diag<float, false>(G, W, partial, out, n, stream);
}

int gpmp_diag_block_inv_max_base() { return TI_MAX_BASE; }

int gpmp_diag_block_inv(const void* L, void* out, long long n, int base, void* stream) {
  return launch_diag_block_inv(L, out, n, base, stream);
}

long long gpmp_trace_sums_blocks(long long n) { return trace_sums_blocks(n); }

int gpmp_trace_sums(const void* H, void* partial, void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = trace_sums_blocks(n);
  trace_sums_kernel<<<static_cast<unsigned>(nb), RED_THREADS, 0, s>>>(
      static_cast<const float*>(H), static_cast<double*>(partial), n);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gpmp_series_sums(const void* H, const void* H2, void* partial, void* out, long long n,
                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = trace_sums_blocks(n);
  series_sums_kernel<<<static_cast<unsigned>(nb), RED_THREADS, 0, s>>>(
      static_cast<const float*>(H), static_cast<const float*>(H2),
      static_cast<double*>(partial), n);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
