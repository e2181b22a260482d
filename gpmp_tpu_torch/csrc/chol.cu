// gpmp_tpu_torch/csrc/chol.cu
//
// K8t and K9m (square and slab forms): the hand-written kernels of the
// blocked Cholesky with refined panels (gpmp_tpu_torch/parallel/chol.py;
// wrappers in gpmp_tpu_torch/ops/refine.py and gpmp_tpu_torch/ops/chol.py)
// for Hopper, sm_90a.  Plain C entry points, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.  The path's other kernels, K8r (the panel's
// refinement residual), K9u (the trailing update) and K9s (its slab form),
// are K4's kernel in csrc/mixed.cu.
//
// K8t triangular product (replaces the products of gpmp_tpu/ops/refine.py
//    newton_tri_inv, M (2I - L M), and the Ogita-Aishima update of
//    refined_cholesky, L + L Phi(X)):
//      C = beta A + alpha A f(B), A and B (b, b) f64, C lower triangular,
//      A read as lower triangular, f(B) = tril(B), or Phi(B) = tril(B) with
//      its diagonal halved (applied as B's tiles load), the upper triangle
//      of C written as exact zeros.  The Newton step is two launches,
//      P = L M (beta 0) then M' = 2 M - M P (beta 2, alpha -1); the update
//      one, L' = L + L Phi(X) (beta 1, alpha 1).  A product of lower
//      triangular matrices is exactly lower triangular, so the tiles above
//      the diagonal and the k tiles outside [j0, i0] are skipped: only the
//      summation order differs from the dense product.
//    Bound: b^3/6 f64 FMAs (2.2e7 at b = 512: 0.67 us at the 67 TFLOP/s f64
//    tensor peak) against reading A and B and writing C (6.3 MB, 1.9 us):
//    memory-bound on paper; in practice latency-bound (256 tiles at
//    b = 512, one wave, up to 16 k steps each).  Design: K4's 32 x 32
//    output tiles, 256 threads with 4 rows each, both operands staged in
//    shared memory in f64, plain f64 FMAs on the vector units.
//
// K9m Murray's elementwise passes (replace gpmp_tpu/parallel/chol.py
//    _sharded_chol_bwd's Phi(L^T Lbar) and 0.5 (S + S^T)), in place on an
//    (n, n) f64 matrix, one thread block per lower tile and its mirror:
//      phi:  P <- tril(P) - diag(P) / 2: the mirror tile above the diagonal
//            is zeroed, the diagonal tile halved on its diagonal and zeroed
//            above it (the lower tiles keep their values, no read);
//      sym:  S <- (S + S^T) / 2: the tile and its mirror are staged in
//            shared memory (padded rows), then both written from them, each
//            with consecutive threads on consecutive words; (i, j) and
//            (j, i) get the same sum, so the result is exactly symmetric.
//    Bound: sym reads and writes n^2 f64 (4.3 GB at n = 16384: 1.28 ms at
//    3.35 TB/s); phi writes n^2 / 2 and reads n (0.32 ms): memory-bound.
//    Slab form (Murray's backward on a row-sharded factor): on one rank's
//    (rows, n) slab of global rows [off, off + rows), phi zeroes j > i and
//    halves j = i in place; sym averages the slab with the slab of S^T
//    (brought by an all-to-all), X <- (X + Y) / 2.  One thread per entry,
//    consecutive threads on consecutive words; the same values as the
//    square passes, bitwise.  Bound: reading and writing the slab(s).
//
// Tensor cores, TMA and wgmma are not used: these kernels are simple and
// right first; making them fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int CT_TILE = 32;
constexpr int CT_TY = 8;  // block (32, 8): each thread owns 4 rows of a column
constexpr int CT_ROWS = CT_TILE / CT_TY;

// ---------------------------------------------------------------- K8t
__global__ void __launch_bounds__(CT_TILE * CT_TY)
tri_product_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   double* __restrict__ C, long long n, double beta, double alpha, int phi) {
  const long long bi = blockIdx.y, bj = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i0 = bi * CT_TILE, j0 = bj * CT_TILE;
  if (bi < bj) {  // above the diagonal: exact zeros
#pragma unroll
    for (int q = 0; q < CT_ROWS; ++q) {
      const long long gi = i0 + ty + CT_TY * q, gj = j0 + tx;
      if (gi < n && gj < n) C[gi * n + gj] = 0.0;
    }
    return;
  }

  __shared__ double As[CT_TILE][CT_TILE + 1];  // A[i0 + r, k0 + c], lower part
  __shared__ double Bs[CT_TILE][CT_TILE + 1];  // f(B)[k0 + r, j0 + c]
  double acc[CT_ROWS];
#pragma unroll
  for (int q = 0; q < CT_ROWS; ++q) acc[q] = 0.0;

  // A[i, k] = 0 for k > i and f(B)[k, j] = 0 for k < j: k runs over the
  // tiles j0 .. i0 only
  const long long kend = (i0 + CT_TILE < n) ? i0 + CT_TILE : n;
  for (long long k0 = j0; k0 < kend; k0 += CT_TILE) {
    for (int r = ty; r < CT_TILE; r += CT_TY) {
      const long long gi = i0 + r, gk = k0 + tx;
      As[r][tx] = (gi < n && gk <= gi) ? A[gi * n + gk] : 0.0;
      const long long gkr = k0 + r, gj = j0 + tx;
      double b = (gkr < n && gj < n && gkr >= gj) ? B[gkr * n + gj] : 0.0;
      if (phi && gkr == gj) b *= 0.5;
      Bs[r][tx] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < CT_TILE; ++kk) {
      const double bv = Bs[kk][tx];
#pragma unroll
      for (int q = 0; q < CT_ROWS; ++q) acc[q] += As[ty + CT_TY * q][kk] * bv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < CT_ROWS; ++q) {
    const long long gi = i0 + ty + CT_TY * q, gj = j0 + tx;
    if (gi < n && gj < n)
      C[gi * n + gj] = gi >= gj ? beta * A[gi * n + gj] + alpha * acc[q] : 0.0;
  }
}

// ---------------------------------------------------------------- K9m
__device__ void lower_tile(long long b, long long& bi, long long& bj) {
  bi = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) / 2.0);
  while (bi * (bi + 1) / 2 > b) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
  bj = b - bi * (bi + 1) / 2;
}

template <bool SYM>
__global__ void __launch_bounds__(CT_TILE * CT_TY)
murray_kernel(double* __restrict__ X, long long n) {
  long long bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long i0 = bi * CT_TILE, j0 = bj * CT_TILE;
  if (!SYM) {
    for (int r = ty; r < CT_TILE; r += CT_TY) {
      if (bi == bj) {
        const long long gi = i0 + r, gj = j0 + tx;
        if (gi < n && gj < n) {
          const double v = X[gi * n + gj];
          X[gi * n + gj] = gi > gj ? v : (gi == gj ? 0.5 * v : 0.0);
        }
      } else {  // the mirror tile (bj, bi), above the diagonal
        const long long gr = j0 + r, gc = i0 + tx;
        if (gr < n && gc < n) X[gr * n + gc] = 0.0;
      }
    }
    return;
  }
  __shared__ double T1[CT_TILE][CT_TILE + 1];  // X[i0 + r, j0 + c]
  __shared__ double T2[CT_TILE][CT_TILE + 1];  // X[j0 + r, i0 + c]
  for (int r = ty; r < CT_TILE; r += CT_TY) {
    const long long gi = i0 + r, gj = j0 + tx, gr = j0 + r, gc = i0 + tx;
    T1[r][tx] = (gi < n && gj < n) ? X[gi * n + gj] : 0.0;
    T2[r][tx] = (gr < n && gc < n) ? X[gr * n + gc] : 0.0;
  }
  __syncthreads();  // the diagonal tile is read whole before it is written
  for (int r = ty; r < CT_TILE; r += CT_TY) {
    const long long gi = i0 + r, gj = j0 + tx;
    if (gi < n && gj < n) X[gi * n + gj] = 0.5 * (T1[r][tx] + T2[tx][r]);
    const long long gr = j0 + r, gc = i0 + tx;
    if (bi != bj && gr < n && gc < n) X[gr * n + gc] = 0.5 * (T2[r][tx] + T1[tx][r]);
  }
}

template <bool SYM>
__global__ void murray_slab_kernel(double* __restrict__ X, const double* __restrict__ Y,
                                   long long rows, long long n, long long off) {
  const long long total = rows * n;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (SYM) {
      X[e] = 0.5 * (X[e] + Y[e]);
    } else {
      const long long gi = off + e / n, gj = e % n;
      const double v = X[e];
      X[e] = gi > gj ? v : (gi == gj ? 0.5 * v : 0.0);
    }
  }
}

}  // namespace

extern "C" {

int gpmp_murray_slab(void* X, const void* Y, long long rows, long long n, long long off,
                     int sym, void* stream) {
  if (rows <= 0 || n <= 0 || off < 0 || off + rows > n || (sym && Y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * n;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // a grid-stride loop past 32 blocks per SM
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sym)
    murray_slab_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<double*>(X), static_cast<const double*>(Y), rows, n, off);
  else
    murray_slab_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<double*>(X), nullptr, rows, n, off);
  return static_cast<int>(cudaGetLastError());
}

int gpmp_tri_product(const void* A, const void* B, void* C, long long n, double beta,
                     double alpha, int phi, void* stream) {
  const long long nt = (n + CT_TILE - 1) / CT_TILE;
  if (n <= 0 || nt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tri_product_kernel<<<dim3(static_cast<unsigned>(nt), static_cast<unsigned>(nt)),
                       dim3(CT_TILE, CT_TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(B), static_cast<double*>(C), n,
      beta, alpha, phi);
  return static_cast<int>(cudaGetLastError());
}

int gpmp_murray(void* X, long long n, int sym, void* stream) {
  const long long nt = (n + CT_TILE - 1) / CT_TILE;
  const long long tiles = nt * (nt + 1) / 2;
  if (n <= 0 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles)), block(CT_TILE, CT_TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sym)
    murray_kernel<true><<<grid, block, 0, s>>>(static_cast<double*>(X), n);
  else
    murray_kernel<false><<<grid, block, 0, s>>>(static_cast<double*>(X), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
