// gpmp_tpu_torch/csrc/mixed.cu
//
// K3, K5, K6, K7 and K7b: the hand-written kernels of the mixed-precision
// Cholesky engine (gpmp_tpu_torch/ops/mixed.py; its K4 and K4s, and K8s,
// the residual of its sampling root, are csrc/residual.cu); K8r, the
// residual of the refined panel factor (gpmp_tpu_torch/ops/refine.py);
// K10m and K10r, K3's kernel and the CUDA-core residual kernel on the
// streamed engine's sources of K (gpmp_tpu_torch/ops/streamed.py); for
// Hopper, sm_90a.  Plain C entry points, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.
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
// K10m streamed residual (replaces gpmp_tpu/parallel/streamed.py _matvec_ff
//    and the residual of _refined_solve_streamed):
//      R = B - (K32 + E32) X, and (sum R^2, sum B^2), with K held as the
//      float-float pair of the streamed engine (gpmp_tpu_torch/parallel/
//      streamed.py), X and B (n, k <= 8) in f64.
//    K3's kernel with a two-float source of K: each entry is promoted and
//    summed in f64 in registers (hi + lo is exact in f64).  Bound: reading
//    the pair once, 8 n^2 bytes (2.6 ms at n = 32768): memory-bound.
//
// The CUDA-core factorization residual (fact_residual_kernel): R = K - L L^T
//    in f64 on 32 x 32 lower-triangular tiles, the k loop stopping at the
//    tile's last column (L is lower triangular), L promoted to f64 while
//    staged in shared memory, each entry written at (i, j) and (j, i):
//    exactly symmetric.  Plain f64 FMAs on the vector units, about 1.25
//    shared loads per FMA: ~13% of the f64 tensor bound.  It was K4's
//    kernel until K4 moved to the f64 tensor cores (csrc/residual.cu), and
//    K8s's until K8s moved there too, as K4's kernel with an f64 output;
//    only K8r and K10r run it now.
//
// K8r refinement residual (replaces E = A - L L^T and the convergence
//    guard's sums of gpmp_tpu/ops/refine.py refined_cholesky): the CUDA-core
//    residual kernel with f64 L and an f64 output, on one (B, B) diagonal
//    panel of the blocked Cholesky, plus per-tile partial sums of E^2 and A^2 over the
//    symmetric matrix and the fixed-order second pass of K3.  Bound: B^3/6
//    f64 FMAs (2.2e7 at B = 512, 0.7 us at 67 TFLOP/s) against reading A and
//    L and writing E (6 MB, 1.9 us): memory-bound on paper, latency-bound in
//    practice (136 tiles of 32 x 32 at B = 512, one wave).
//
// Slab forms (the sharded mixed engine on a group mesh, gpmp_tpu_torch/
//    parallel/mixed.py; the JAX package's per-device shares of the same
//    programs): K3 and K7 take a rank's (rows, n) row slab (rows = n: the
//    square forms), K6 a slab of M and all of r, and gives that rank's part
//    of M^T (M r) (summed over the ranks by an all-reduce).  Bounds as the
//    square forms', per rank (K4s, K4's slab form, is csrc/residual.cu's).
//
// K10r streamed factorization residual (replaces gpmp_tpu/parallel/
//    streamed.py _streamed_residual_f32): the CUDA-core residual kernel,
//    with K read from a source given as a template parameter:
//      ff:        the float-float pair (K32 + E32), summed in f64 in
//                 registers, over every lower tile in one launch (the card
//                 never holds K in f64, so the JAX package's column panels,
//                 which only bounded XLA's temporaries, are not needed);
//      recompute: an f64 column panel (n - c0, width) of K at (c0, c0),
//                 one launch per panel, over the lower tiles of rows
//                 [c0, n) x columns [c0, c0 + width).
//    R is f32 and written at (i, j) and (j, i) from one value: exactly
//    symmetric, the diagonal sub-blocks of the panels included.  Bound:
//    ~n^3/6 f64 FMAs over all panels (1.17e13 at n = 32768: 0.35 s at the
//    67 TFLOP/s f64 tensor peak); the kernel's 22.6 ms at n = 8192 (as K8s,
//    before K8s left it) puts it near 1.35 s there.
//
// K6 preconditioner apply (replaces gpmp_tpu/ops/mixed.py _apply and
//    gpmp_tpu/parallel/streamed.py _apply_precond):
//      out = M^T (M r32), M (n, n) lower-triangular f32, r32 = f32(r) for
//      r (n, k) f64 (or f32), the products and sums in f32 (the JAX
//      package's rounding), out cast to r's type.
//    Bound: the lower triangle of M read once plus r and out, (n^2/2 +
//    2 n k) 4 bytes (0.64 ms at n = 32768): memory-bound for k <= 8.
//    Design for k <= 8: two passes over the lower triangle, as the
//    one-pass form needs the whole
//    row i of M twice (once for y_i = m_i r, once for m_i^T y_i) and a row
//    of 128 KB at n = 32768 does not stay on chip across many rows:
//      launch 1: y = M r32, one warp per row, reading columns j <= i with
//                consecutive lanes on consecutive words, r32 staged in
//                shared memory in 256-row tiles;
//      launch 2: per (32-column block, 512-row chunk) partial sums of
//                M^T y over the chunk's rows i >= j (a warp reads 32
//                consecutive words of a row; y_i is broadcast);
//      launch 3: the chunks of each column summed in a fixed order (no
//                atomics: bitwise reproducible) and cast to r's type.
//    Wider r (predict's right-hand sides, the LOO backward's [Xbar, I]):
//    two tiled triangular products, Y = M r32 then out = M^T Y, each a
//    64 x 64 output tile per block (4 x 4 per thread, 16-deep k steps
//    through shared memory) that visits only the k tiles of the lower
//    triangle: n^2 k f32 FMAs in all, compute-bound past k ~ 20.  The sums
//    run in one fixed order (bitwise reproducible).
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

// ------------------------------------------------- sources of K(i, j)
// K3 and the residual kernel read K through one of these (K10m/K10r are the
// same kernels on the streamed engine's sources); each returns the entry
// promoted to f64.
template <typename T>
struct DenseK {  // K (n, n) in T, row-major
  const T* __restrict__ K;
  long long ld;
  __device__ double operator()(long long i, long long j) const {
    return static_cast<double>(K[i * ld + j]);
  }
};

struct PairK {  // the float-float pair K = hi + lo, (n, n) each, row-major
  const float* __restrict__ hi;
  const float* __restrict__ lo;
  long long ld;
  __device__ double operator()(long long i, long long j) const {
    const long long t = i * ld + j;
    return static_cast<double>(hi[t]) + static_cast<double>(lo[t]);
  }
};

struct PanelK {  // an f64 column panel (n - c0, width) of K whose (0, 0) is K(c0, c0)
  const double* __restrict__ P;
  long long c0, width;
  __device__ double operator()(long long i, long long j) const {
    return P[(i - c0) * width + (j - c0)];
  }
};

// ---------------------------------------------------------------- K3
constexpr int RES_ROWS = 8;  // rows per block, one warp each
constexpr int RES_THREADS = 32 * RES_ROWS;
constexpr int RES_TILE = 256;  // rows of X staged per step
constexpr int RES_MAX_K = 8;

template <typename Src, typename T>
__global__ void __launch_bounds__(RES_THREADS)
residual_kernel(Src K, const T* __restrict__ X, const T* __restrict__ B,
                T* __restrict__ R, double* __restrict__ partial, long long nrows, long long n,
                int k) {
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
    if (row < nrows) {
      for (int j = lane; j < w; j += 32) {
        const double kv = K(row, c0 + j);
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
      if (lane == 0 && row < nrows) {
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

// rows of K (each n wide): n for the square K, n / R for a rank's row slab
template <typename Src, typename T>
int launch_residual(Src K, const void* X, const void* B, void* R, void* partial,
                    void* norms, long long rows, long long n, int k, void* stream) {
  if (rows <= 0 || n <= 0 || k < 1 || k > RES_MAX_K || residual_blocks(rows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = residual_blocks(rows);
  residual_kernel<Src, T><<<static_cast<unsigned>(nb), RES_THREADS, 0, s>>>(
      K, static_cast<const T*>(X), static_cast<const T*>(B),
      static_cast<T*>(R), static_cast<double*>(partial), rows, n, k);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(norms));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ the CUDA-core residual (K8r, K10r)
constexpr int FR_TILE = 32;
constexpr int FR_TY = 8;  // block (32, 8): each thread owns 4 rows of a column
constexpr int FR_ROWS = FR_TILE / FR_TY;

// R(i, j) = K(i, j) - sum_k L(i, k) L(j, k) for rows i in [c0, n), columns
// j in [c0, c0 + width), i >= j, written at (i, j) and (j, i).  L (TL, f32 or
// f64) and R have leading dimension n; k runs over [0, tile's last column],
// L being lower triangular.
// PANEL = false: blockIdx.x is the linear index of the lower tile (bi, bj) of
// the (width, width) block at (c0, c0); PANEL = true: blockIdx.x the row tile
// and blockIdx.y the column tile, both counted from c0, and the tiles above
// the diagonal return at once.  GUARD (K8r, PANEL = false only): the block's
// sums of R^2 and K^2 over the whole symmetric matrix (off-diagonal entries
// twice) go to partial[2 * blockIdx.x + {0, 1}].
template <typename Src, typename TL, typename TOut, bool PANEL, bool GUARD>
__global__ void __launch_bounds__(FR_TILE * FR_TY)
fact_residual_kernel(Src K, const TL* __restrict__ L, TOut* __restrict__ R, long long n,
                     long long c0, long long width, double* __restrict__ partial) {
  long long bi, bj;
  if (PANEL) {
    bi = blockIdx.x;
    bj = blockIdx.y;
    if (bi < bj) return;
  } else {
    const long long b = blockIdx.x;
    bi = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) / 2.0);
    while (bi * (bi + 1) / 2 > b) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
    bj = b - bi * (bi + 1) / 2;
  }

  __shared__ double As[FR_TILE][FR_TILE + 1];  // L[i0 + r, k0 + c]
  __shared__ double Bs[FR_TILE][FR_TILE + 1];  // L[j0 + r, k0 + c]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i0 = c0 + bi * FR_TILE, j0 = c0 + bj * FR_TILE;
  const long long jend = c0 + width;  // columns of this launch: [c0, jend)
  double acc[FR_ROWS];
#pragma unroll
  for (int q = 0; q < FR_ROWS; ++q) acc[q] = 0.0;

  // triangular L (L[j, k] = 0 for k > j): the sum stops at the tile's last column
  const long long kend = (j0 + FR_TILE < n) ? j0 + FR_TILE : n;
  for (long long k0 = 0; k0 < kend; k0 += FR_TILE) {
    const long long gk = k0 + tx;
    for (int r = ty; r < FR_TILE; r += FR_TY) {
      const long long gi = i0 + r, gj = j0 + r;
      As[r][tx] = (gi < n && gk < kend) ? static_cast<double>(L[gi * n + gk]) : 0.0;
      Bs[r][tx] = (gj < n && gk < kend) ? static_cast<double>(L[gj * n + gk]) : 0.0;
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

  double e2 = 0.0, a2 = 0.0;
#pragma unroll
  for (int q = 0; q < FR_ROWS; ++q) {
    const long long gi = i0 + ty + FR_TY * q, gj = j0 + tx;
    if (gi < n && gj < jend && gi >= gj) {
      const double kv = K(gi, gj);
      const double rv = kv - acc[q];
      const TOut v = static_cast<TOut>(rv);
      R[gi * n + gj] = v;
      R[gj * n + gi] = v;
      if (GUARD) {
        const double w = gi == gj ? 1.0 : 2.0;
        e2 += w * rv * rv;
        a2 += w * kv * kv;
      }
    }
  }
  if (GUARD) {  // the block's sums in a fixed order (tree over linear thread ids)
    __shared__ double g0[FR_TILE * FR_TY];
    __shared__ double g1[FR_TILE * FR_TY];
    const int t = ty * FR_TILE + tx;
    g0[t] = e2;
    g1[t] = a2;
    __syncthreads();
    for (int h = FR_TILE * FR_TY / 2; h > 0; h >>= 1) {
      if (t < h) {
        g0[t] += g0[t + h];
        g1[t] += g1[t + h];
      }
      __syncthreads();
    }
    if (t == 0) {
      partial[2 * blockIdx.x] = g0[0];
      partial[2 * blockIdx.x + 1] = g1[0];
    }
  }
}

long long lower_tiles(long long n) {
  const long long nt = (n + FR_TILE - 1) / FR_TILE;
  return nt * (nt + 1) / 2;
}

// every lower tile of the (n, n) residual, one launch
template <typename Src, typename TOut>
int launch_fact_residual(Src K, const void* L, void* R, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = lower_tiles(n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fact_residual_kernel<Src, float, TOut, false, false>
      <<<static_cast<unsigned>(tiles), dim3(FR_TILE, FR_TY), 0,
         static_cast<cudaStream_t>(stream)>>>(
          K, static_cast<const float*>(L), static_cast<TOut*>(R), n, 0, n, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// the lower tiles of rows [c0, n) x columns [c0, c0 + width), one launch
// per column panel (K10r, recompute mode)
int launch_fact_residual_panel(const void* P, const void* L, void* R, long long n, long long c0,
                               long long width, void* stream) {
  if (n <= 0 || c0 < 0 || width <= 0 || c0 + width > n) return static_cast<int>(cudaErrorInvalidValue);
  const long long rt = (n - c0 + FR_TILE - 1) / FR_TILE;
  const long long ct = (width + FR_TILE - 1) / FR_TILE;
  if (rt > 0x7fffffffLL || ct > 65535) return static_cast<int>(cudaErrorInvalidValue);
  fact_residual_kernel<PanelK, float, float, true, false>
      <<<dim3(static_cast<unsigned>(rt), static_cast<unsigned>(ct)), dim3(FR_TILE, FR_TY), 0,
         static_cast<cudaStream_t>(stream)>>>(
          PanelK{static_cast<const double*>(P), c0, width}, static_cast<const float*>(L),
          static_cast<float*>(R), n, c0, width, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K8r: E = A - L L^T for an f64 (n, n) panel and its factor, exactly
// symmetric, and (sum E^2, sum A^2) by per-tile partials and a fixed-order
// second pass
int launch_refine_residual(const void* A, const void* L, void* E, void* partial, void* sums,
                           long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = lower_tiles(n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fact_residual_kernel<DenseK<double>, double, double, false, true>
      <<<static_cast<unsigned>(tiles), dim3(FR_TILE, FR_TY), 0, s>>>(
          DenseK<double>{static_cast<const double*>(A), n}, static_cast<const double*>(L),
          static_cast<double*>(E), n, 0, n, static_cast<double*>(partial));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), tiles,
                                                static_cast<double*>(sums));
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

// blocks for a (rows, n) H: rows = n for the square H, n / R for a slab
long long trace_sums_blocks(long long rows, long long n) {
  const long long per_block = static_cast<long long>(RED_THREADS) * TS_PER_THREAD;
  long long b = (rows * n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return b < TS_MAX_BLOCKS ? b : TS_MAX_BLOCKS;
}

__global__ void __launch_bounds__(RED_THREADS)
trace_sums_kernel(const float* __restrict__ H, double* __restrict__ partial, long long rows,
                  long long n, long long off) {
  const long long stride = static_cast<long long>(gridDim.x) * RED_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  double tr = 0.0, sq = 0.0;
  for (long long t = first; t < rows * n; t += stride) {
    const double h = static_cast<double>(H[t]);
    sq += h * h;
  }
  // the diagonal of the rows [off, off + rows) of the (n, n) H
  for (long long i = first; i < rows; i += stride) tr += static_cast<double>(H[i * n + off + i]);
  block_pair_to_partial(tr, sq, partial);
}

__global__ void __launch_bounds__(RED_THREADS)
series_sums_kernel(const float* __restrict__ H, const float* __restrict__ H2,
                   double* __restrict__ partial, long long rows, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * RED_THREADS;
  double s3 = 0.0, s4 = 0.0;
  for (long long t = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
       t < rows * n; t += stride) {
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

// ---------------------------------------------------------------- K6
constexpr int PA_ROWS = 8;  // launch 1: rows per block, one warp each
constexpr int PA_THREADS = 32 * PA_ROWS;
constexpr int PA_TILE = 256;  // rows of r32 staged per step
constexpr int PA_MAX_K = 8;
constexpr int PA_COLS = 32;  // launch 2: columns per block
constexpr int PA_TY = 8;     // launch 2: rows in flight per block
constexpr long long PA_CHUNK = 512;  // launch 2: rows per chunk

long long precond_chunks(long long n) { return (n + PA_CHUNK - 1) / PA_CHUNK; }

// y = M r32 over the lower triangle: y_i = sum_{j <= i} M_ij f32(r_j), f32.
// SLAB: M is the rows [off, off + rows) of the (n, n) lower-triangular M; y
// has those rows, r all n.  Without SLAB, rows = n and off = 0 are constants
// (the square form's code, as fast as before the slab form existed).
template <typename T, bool SLAB>
__global__ void __launch_bounds__(PA_THREADS)
precond_rows_kernel(const float* __restrict__ M, const T* __restrict__ r,
                    float* __restrict__ y, long long rows_, long long n, long long off_,
                    int k) {
  const long long rows = SLAB ? rows_ : n;
  const long long off = SLAB ? off_ : 0;
  __shared__ float rs[PA_TILE * PA_MAX_K];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * PA_ROWS;
  const long long row = row0 + warp;
  long long last = row0 + PA_ROWS - 1;  // the block's last row: its columns end there
  if (last > rows - 1) last = rows - 1;
  last += off;  // as a global row
  float acc[PA_MAX_K];
#pragma unroll
  for (int c = 0; c < PA_MAX_K; ++c) acc[c] = 0.0f;

  for (long long c0 = 0; c0 <= last; c0 += PA_TILE) {
    const int w = static_cast<int>(last + 1 - c0 < PA_TILE ? last + 1 - c0 : PA_TILE);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < w * k; t += PA_THREADS)
      rs[t] = static_cast<float>(r[c0 * k + t]);  // r is row-major (n, k)
    __syncthreads();
    if (row < rows) {
      const float* Mrow = M + row * n + c0;
      const long long grow = off + row;
      const int wr = static_cast<int>(grow + 1 - c0 < w ? grow + 1 - c0 : w);  // j <= grow
#pragma unroll 4
      for (int j = lane; j < wr; j += 32) {
        const float mv = Mrow[j];
#pragma unroll
        for (int c = 0; c < PA_MAX_K; ++c)
          if (c < k) acc[c] = fmaf(mv, rs[j * k + c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < PA_MAX_K; ++c) {
    if (c < k) {
      float v = acc[c];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && row < rows) y[row * k + c] = v;
    }
  }
}

// partial[ch, j, c] = sum over the chunk's rows i (global off + i >= j) of
// M_ij y_ic, f32; the chunks cut the slab's rows (SLAB as above)
template <bool SLAB>
__global__ void __launch_bounds__(PA_COLS * PA_TY)
precond_cols_kernel(const float* __restrict__ M, const float* __restrict__ y,
                    float* __restrict__ partial, long long rows_, long long n, long long off_,
                    int k) {
  const long long rows = SLAB ? rows_ : n;
  const long long off = SLAB ? off_ : 0;
  __shared__ float red[PA_TY][PA_COLS][PA_MAX_K];
  const long long j0 = static_cast<long long>(blockIdx.x) * PA_COLS;
  const long long j = j0 + threadIdx.x;
  const long long ch = blockIdx.y;
  long long r0 = ch * PA_CHUNK;
  const long long r1 = r0 + PA_CHUNK < rows ? r0 + PA_CHUNK : rows;
  if (r0 < j0 - off) r0 = j0 - off;  // rows above the block's first column hold zeros of M
  float acc[PA_MAX_K];
#pragma unroll
  for (int c = 0; c < PA_MAX_K; ++c) acc[c] = 0.0f;
  if (j < n) {
    for (long long i = r0 + threadIdx.y; i < r1; i += PA_TY) {
      if (off + i < j) continue;  // M_ij = 0 above the diagonal
      const float mv = M[i * n + j];
#pragma unroll
      for (int c = 0; c < PA_MAX_K; ++c)
        if (c < k) acc[c] = fmaf(mv, y[i * k + c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < PA_MAX_K; ++c) red[threadIdx.y][threadIdx.x][c] = acc[c];
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    for (int c = 0; c < k; ++c) {
      float t = 0.0f;
      for (int q = 0; q < PA_TY; ++q) t += red[q][threadIdx.x][c];
      partial[(ch * n + j) * k + c] = t;
    }
  }
}

// out[j, c] = T(sum over the chunks in order of partial[ch, j, c])
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
precond_reduce_kernel(const float* __restrict__ partial, long long chunks, long long n, int k,
                      T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (t >= n * k) return;
  float s = 0.0f;
  for (long long ch = 0; ch < chunks; ++ch) s += partial[ch * n * k + t];
  out[t] = static_cast<T>(s);
}

// M^T (M r32) for M the rows [off, off + rows) of an (n, n) lower-triangular
// f32 M (rows = n, off = 0: the whole product); r (n, k) in T; out (n, k) in
// Tout: the whole M^T M r, or a rank's part of it, summed over the ranks by
// the caller
template <typename T, typename Tout, bool SLAB>
int launch_precond_apply(const void* M, const void* r, void* y, void* partial, void* out,
                         long long rows, long long n, long long off, int k, void* stream) {
  const long long row_blocks = (rows + PA_ROWS - 1) / PA_ROWS;
  const long long col_blocks = (n + PA_COLS - 1) / PA_COLS;
  const long long chunks = precond_chunks(rows);
  if (rows <= 0 || n <= 0 || off < 0 || off + rows > n || k < 1 || k > PA_MAX_K ||
      row_blocks > 0x7fffffffLL || col_blocks > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  precond_rows_kernel<T, SLAB><<<static_cast<unsigned>(row_blocks), PA_THREADS, 0, s>>>(
      static_cast<const float*>(M), static_cast<const T*>(r), static_cast<float*>(y), rows, n,
      off, k);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  precond_cols_kernel<SLAB>
      <<<dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(chunks)),
         dim3(PA_COLS, PA_TY), 0, s>>>(
      static_cast<const float*>(M), static_cast<const float*>(y),
      static_cast<float*>(partial), rows, n, off, k);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  precond_reduce_kernel<Tout><<<static_cast<unsigned>((n * k + RED_THREADS - 1) / RED_THREADS),
                                RED_THREADS, 0, s>>>(static_cast<const float*>(partial), chunks,
                                                     n, k, static_cast<Tout*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K6 for wide r: C = op(M) B, op(M) = M (lower, TRANS false) or M^T
// (TRANS true), B (n, k) read as f32, f32 FMAs, C written as Tout.
constexpr int PW_TILE = 64;  // output tile, rows and columns
constexpr int PW_K = 16;     // k step through shared memory
constexpr int PW_SIDE = 16;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PW_THREADS = PW_SIDE * PW_SIDE;
constexpr int PW_PER = PW_TILE / PW_SIDE;

template <bool TRANS, typename Tin, typename Tout>
__global__ void __launch_bounds__(PW_THREADS)
precond_wide_kernel(const float* __restrict__ M, const Tin* __restrict__ B,
                    Tout* __restrict__ C, long long n, long long k) {
  __shared__ float As[PW_K][PW_TILE + 4];  // As[kk][ii] = op(M)[i0 + ii, k0 + kk]
  __shared__ float Bs[PW_K][PW_TILE];
  const int tx = threadIdx.x % PW_SIDE;
  const int ty = threadIdx.x / PW_SIDE;
  const long long i0 = static_cast<long long>(blockIdx.y) * PW_TILE;
  const long long c0 = static_cast<long long>(blockIdx.x) * PW_TILE;
  // only the k tiles that meet the triangle: j <= i (M), j >= i (M^T)
  const long long kbeg = TRANS ? i0 : 0;
  const long long kend = TRANS ? n : (i0 + PW_TILE < n ? i0 + PW_TILE : n);
  float acc[PW_PER][PW_PER];
#pragma unroll
  for (int a = 0; a < PW_PER; ++a)
#pragma unroll
    for (int b = 0; b < PW_PER; ++b) acc[a][b] = 0.0f;

  for (long long k0 = kbeg; k0 < kend; k0 += PW_K) {
    for (int t = threadIdx.x; t < PW_TILE * PW_K; t += PW_THREADS) {
      float v = 0.0f;
      int ii, kk;
      if (TRANS) {  // M[j, i0 + ii]: consecutive threads on consecutive words of row j
        kk = t / PW_TILE;
        ii = t % PW_TILE;
        const long long i = i0 + ii, j = k0 + kk;
        if (j < n && i <= j) v = M[j * n + i];
      } else {      // M[i0 + ii, j]: 16 consecutive words of row i
        ii = t / PW_K;
        kk = t % PW_K;
        const long long i = i0 + ii, j = k0 + kk;
        if (i < n && j <= i) v = M[i * n + j];
      }
      As[kk][ii] = v;
    }
    for (int t = threadIdx.x; t < PW_TILE * PW_K; t += PW_THREADS) {
      const int kk = t / PW_TILE, cc = t % PW_TILE;
      const long long j = k0 + kk, c = c0 + cc;
      Bs[kk][cc] = (j < n && c < k) ? static_cast<float>(B[j * k + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PW_K; ++kk) {
      float a[PW_PER], b[PW_PER];
#pragma unroll
      for (int q = 0; q < PW_PER; ++q) {
        a[q] = As[kk][ty + PW_SIDE * q];
        b[q] = Bs[kk][tx + PW_SIDE * q];
      }
#pragma unroll
      for (int p = 0; p < PW_PER; ++p)
#pragma unroll
        for (int q = 0; q < PW_PER; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();  // the tiles are refilled next step
  }
#pragma unroll
  for (int p = 0; p < PW_PER; ++p) {
    const long long i = i0 + ty + PW_SIDE * p;
    if (i >= n) continue;
#pragma unroll
    for (int q = 0; q < PW_PER; ++q) {
      const long long c = c0 + tx + PW_SIDE * q;
      if (c < k) C[i * k + c] = static_cast<Tout>(acc[p][q]);
    }
  }
}

template <typename T>
int launch_precond_wide(const void* M, const void* r, void* y, void* out, long long n,
                        long long k, void* stream) {
  const long long row_tiles = (n + PW_TILE - 1) / PW_TILE;
  const long long col_tiles = (k + PW_TILE - 1) / PW_TILE;
  if (n <= 0 || k < 1 || row_tiles > 65535 || col_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  precond_wide_kernel<false, T, float><<<grid, PW_THREADS, 0, s>>>(
      static_cast<const float*>(M), static_cast<const T*>(r), static_cast<float*>(y), n, k);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  precond_wide_kernel<true, float, T><<<grid, PW_THREADS, 0, s>>>(
      static_cast<const float*>(M), static_cast<const float*>(y), static_cast<T*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long gpmp_residual_blocks(long long n) { return residual_blocks(n); }

int gpmp_residual_f64(const void* K, const void* X, const void* B, void* R, void* partial,
                      void* norms, long long rows, long long n, int k, void* stream) {
  return launch_residual<DenseK<double>, double>(
      DenseK<double>{static_cast<const double*>(K), n}, X, B, R, partial, norms, rows, n, k,
      stream);
}

int gpmp_residual_f32(const void* K, const void* X, const void* B, void* R, void* partial,
                      void* norms, long long rows, long long n, int k, void* stream) {
  return launch_residual<DenseK<float>, float>(
      DenseK<float>{static_cast<const float*>(K), n}, X, B, R, partial, norms, rows, n, k,
      stream);
}

int gpmp_ff_residual(const void* hi, const void* lo, const void* X, const void* B, void* R,
                     void* partial, void* norms, long long n, int k, void* stream) {
  return launch_residual<PairK, double>(
      PairK{static_cast<const float*>(hi), static_cast<const float*>(lo), n}, X, B, R, partial,
      norms, n, n, k, stream);
}

int gpmp_streamed_residual_ff(const void* hi, const void* lo, const void* L, void* R,
                              long long n, void* stream) {
  return launch_fact_residual<PairK, float>(
      PairK{static_cast<const float*>(hi), static_cast<const float*>(lo), n}, L, R, n, stream);
}

int gpmp_streamed_residual_panel(const void* P, const void* L, void* R, long long n,
                                 long long c0, long long width, void* stream) {
  return launch_fact_residual_panel(P, L, R, n, c0, width, stream);
}

long long gpmp_refine_residual_blocks(long long n) { return lower_tiles(n); }

int gpmp_refine_residual(const void* A, const void* L, void* E, void* partial, void* sums,
                         long long n, void* stream) {
  return launch_refine_residual(A, L, E, partial, sums, n, stream);
}

long long gpmp_precond_chunks(long long n) { return precond_chunks(n); }

int gpmp_precond_apply_f64(const void* M, const void* r, void* y, void* partial, void* out,
                           long long n, int k, void* stream) {
  return launch_precond_apply<double, double, false>(M, r, y, partial, out, n, n, 0, k, stream);
}

int gpmp_precond_apply_f32(const void* M, const void* r, void* y, void* partial, void* out,
                           long long n, int k, void* stream) {
  return launch_precond_apply<float, float, false>(M, r, y, partial, out, n, n, 0, k, stream);
}

// a rank's part of M^T (M r32), f32, from its row slab of M and all of r
int gpmp_precond_apply_slab_f64(const void* M, const void* r, void* y, void* partial,
                                void* out, long long rows, long long n, long long off, int k,
                                void* stream) {
  return launch_precond_apply<double, float, true>(M, r, y, partial, out, rows, n, off, k,
                                                   stream);
}

int gpmp_precond_apply_slab_f32(const void* M, const void* r, void* y, void* partial,
                                void* out, long long rows, long long n, long long off, int k,
                                void* stream) {
  return launch_precond_apply<float, float, true>(M, r, y, partial, out, rows, n, off, k,
                                                  stream);
}

int gpmp_precond_apply_wide_f64(const void* M, const void* r, void* y, void* out, long long n,
                                long long k, void* stream) {
  return launch_precond_wide<double>(M, r, y, out, n, k, stream);
}

int gpmp_precond_apply_wide_f32(const void* M, const void* r, void* y, void* out, long long n,
                                long long k, void* stream) {
  return launch_precond_wide<float>(M, r, y, out, n, k, stream);
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

long long gpmp_trace_sums_blocks(long long rows, long long n) {
  return trace_sums_blocks(rows, n);
}

// [tr, sum H^2] of the rows [off, off + rows) of an (n, n) f32 H (rows = n,
// off = 0: the whole H)
int gpmp_trace_sums(const void* H, void* partial, void* out, long long rows, long long n,
                    long long off, void* stream) {
  if (rows <= 0 || n <= 0 || off < 0 || off + rows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = trace_sums_blocks(rows, n);
  trace_sums_kernel<<<static_cast<unsigned>(nb), RED_THREADS, 0, s>>>(
      static_cast<const float*>(H), static_cast<double*>(partial), rows, n, off);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gpmp_series_sums(const void* H, const void* H2, void* partial, void* out, long long rows,
                     long long n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = trace_sums_blocks(rows, n);
  series_sums_kernel<<<static_cast<unsigned>(nb), RED_THREADS, 0, s>>>(
      static_cast<const float*>(H), static_cast<const float*>(H2),
      static_cast<double*>(partial), rows, n);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(static_cast<const double*>(partial), nb,
                                                static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
