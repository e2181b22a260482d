// gpmp_tpu_torch/csrc/matern_gram.cu
//
// K1 (Matern gram forward), K2 (its parameter pullback), their population
// forms K1p and K2p (B parameter vectors at one x) and K1m (the Matern
// polynomial, elementwise) for Hopper, sm_90a, in float and double.
// Plain C entry points, loaded with ctypes by gpmp_tpu_torch/ops/_build.py
// and wrapped in gpmp_tpu_torch/ops/gram.py.
//
// What they replace (JAX package, fused there by XLA):
//   K1: gpmp_tpu/num/__init__.py  _safe_sqrt, _cdist_diff, cdist,
//       scaled_distance; gpmp_tpu/kernel/matern.py  maternp_kernel,
//       maternp_covariance_ii_or_tt, maternp_covariance_it.
//       K_ij = s2 * k_p(h_ij) (+ 10 * s2 * eps on the diagonal when x is y),
//       h_ij = || e^l * x_i - e^l * y_j ||, k_p(h) = e^{-ch} P(2ch),
//       c = 2 sqrt(p + 1/2), P the half-integer Matern polynomial.
//   K2: the autodiff pullback of K1 (explicit form in
//       gpmp_tpu/parallel/likelihood.py _chunked_gram_pullback and
//       gpmp_tpu/parallel/streamed.py _streamed_param_pullback):
//       g_0 = sum_ij Kbar_ij K_ij            (d/d log s2, nugget included)
//       g_k = sum_ij Kbar_ij s2 k_p'(h)/h (e^l_k x_ik - e^l_k y_jk)^2,
//       with the term 0 at h = 0 (the zero subgradient of _safe_sqrt).
//
// K1m (Matern polynomial, elementwise, forward and backward), for user
// covariances that compose gnp.scaled_distance (K1d, distance.cu) with
// kernel.maternp_kernel, as bench.py's noisy model does:
//   replaces gpmp_tpu/kernel/matern.py  maternp_kernel and its autodiff
//   pullback:  K = k_p(D) (0 at D = inf),  Dbar = Kbar * k_p'(D).
//   Bound: one pass over D (and Kbar) writing K (or Dbar): 16 (24) bytes
//   per f64 entry against an exp and 2(p+1) flops: memory traffic.  Design:
//   a grid-stride loop, one entry per thread per step, consecutive threads
//   on consecutive entries; the Horner coefficients come from a
//   host-computed coef array on the device.
//
// What bounds K1/K2 on the H100: each entry writes (K1) or reads (K2) 8
// bytes (f64) against ~2d f64 instructions for the distance, a square root
// (K2: a reciprocal one), an f64 exp and one (K1) or two (K2) Horner
// recurrences.  At n = 8192 the bytes (0.160 ms at 3.35 TB/s) lead the f64
// instructions (~40 (K1) and ~65 (K2) an entry in the built loops); at
// n = 1000 (2.4 us of bytes) the launch, the loads' latency and the
// instruction issue weigh as much.  Measured (PERF.md), the issue
// slots bind first: ~150-250 instructions an entry a lane, CUDA's f64 exp
// with its constants materialized at each call the largest part.  For x is
// y (the REML gram and its pullback) the gram is symmetric in (i, j)
// whatever Kbar is:
//   sum_ij Kbar_ij f(h_ij) = sum_{i<j} (Kbar_ij + Kbar_ji) f(h_ij)
//                            + sum_i Kbar_ii f(0),
// so each unordered pair's f64 work can be done once.
//
// What the design does about it (K1 and K2 share one geometry,
// ops/gram.py gram_plan):
// - a persistent grid of BLOCKS_PER_SM blocks an SM (128 threads, 128
//   registers a thread) walks items, square TILE x TILE output tiles
//   (I, J) in a fixed order: for x is y the pairs I <= J (item
//   t = J (J + 1) / 2 + I), else every (I, J) (t = I tj + J); block b takes
//   the items b, b + blocks, ... in order (n = 1000: 528 items, one a
//   block, four blocks an SM);
// - a thread owns C = 16 / sizeof(T) consecutive columns (one 16-byte
//   access) of S = TILE C / 128 rows of a tile, 8 entries an item: lane l
//   the columns C (l % LPR) .., rows RW warp + l / LPR + s 4 RW (LPR =
//   TILE / C lanes a row, RW = 32 / LPR rows a warp: f64 4 rows x 2
//   columns, f32 2 x 4); its shared-memory offsets are the same for every
//   item, computed once;
// - e^l and s2 are computed once per block; each item's x and y rows are
//   read into registers while the previous item computes (the first item's
//   before the block waits for e^l), then staged scaled by e^l in shared
//   memory, each product rounded on its own (__dmul_rn / __fmul_rn: never
//   contracted into the later subtraction), so coincident points give
//   h = 0 exactly and K(x, x) is exactly symmetric; a thread keeps its
//   columns' scaled y in registers (d <= 8);
// - x is y: an item I < J computes its tile once; K1 writes it to (I, J)
//   from registers and to (J, I) through a shared-memory transpose, both in
//   16-byte coalesced stores with default caching (the factorization reads
//   K next); K2 weighs each entry by Kbar_ij + Kbar_ji.  A diagonal item
//   computes i <= j only: K1 writes i > j from the transpose, K2 weighs
//   i < j by Kbar_ij + Kbar_ji and i = j by Kbar_ii (with the nugget in
//   K_ii).  Whole tiles off the diagonal take a path with no mask (the
//   diagonal and ragged ones the masked path);
// - K2's Kbar tiles (I, J) and, for x is y, (J, I) reach shared memory by
//   16-byte cp.async copies (the cross form's one tile too), the next
//   item's in flight while the current one computes (two buffers; one for
//   the d <= MAX_D instance, for the 48 KB of static shared memory); the
//   tiles are stored with their 16-byte chunks swizzled by row
//   (chunk ^ (row / C) % 8), so a thread's 16-byte row reads and the
//   transposed column reads meet no bank conflict (f32) or two-way ones
//   (f64);
// - arithmetic: K1 keeps the earlier kernel's per-entry arithmetic (a
//   correctly rounded sqrt, d2 summed by fused multiply-adds, Horner from
//   the same coefficients), so K stays bitwise the earlier K1's; K_ii is
//   (s2 k_p(0)) + nugget rounded as the plain version rounds it.  K2 in
//   f64 takes one reciprocal square root r = rsqrt(d2) for both h = d2 r
//   and 1/h (the term weight Kbar s2 k_p'(h) r), guarded by d2 > 0: CUDA's
//   rsqrt is within 1 ulp, where a square root and a division are two
//   iterated sequences; f32 keeps the correctly rounded sqrtf and division
//   (rsqrtf's drift, summed over 1e6 terms, nearly broke the f32 gate of
//   the K1d pullback);
// - Horner: p <= FIXED_P takes one instance with the coefficients of
//   degree FIXED_P zero-padded, passed by value (kernel parameters: no
//   device memory read): bitwise the degree-p recurrence, since 0 t + a = a
//   for finite t and h = inf is masked after; p > FIXED_P takes an instance
//   that loops on the run-time p over a device coefficient array;
// - d <= EXACT_MAX_D takes an instance for its d (the loops over k
//   unrolled with no guard), d <= MAX_D one reading d at run time (run-time
//   guards cost the K1d kernels 41-77%: PERF.md); p > FIXED_P takes
//   the run-time d instance whatever d is (half the instances to build);
// - K2 sums each thread's terms in f64 in a fixed order (its items, their
//   rows, each row's C columns; masked entries add nothing), then
//   csrc/fixed_sum.cuh's grid_sum: the block's sums, and the last block to
//   take the ticket sums the partials in block order, writes the 1 + d
//   results and resets the ticket.  One launch, no atomics on values:
//   bitwise reproducible for a shape on a card.  The partials and the
//   ticket are a workspace the wrapper caches per shape;
// - rows that are not 16-byte aligned (m not a multiple of C, or the
//   output's or Kbar's base) take C scalar stores (K1) or sizeof(T)-byte
//   copies (K2): the same arithmetic and order of sums.
// Tensor cores, TMA and wgmma are not used: there is no matrix product.
//
// K1p and K2p (the population forms of K1 and K2, for the SMC and SVGD
// samplers) replace gpmp_tpu/mcmc/param_posterior.py:399 and
// gpmp_tpu/mcmc/svgd.py:166: jax.vmap of the gram composition (and of its
// VJP) over B parameter vectors theta_b at one x, which XLA compiles as one
// batched program.  K1p writes B n m entries, K2p reads as many: bytes
// bound both (at the samplers' n = 8 a member is 64 entries, and a launch
// is a few microseconds of fixed cost against ~0.2 us of bytes).  Design:
// each entry takes K1's (K2's) per-entry arithmetic (gram_value, pull_entry,
// the scaled coordinates rounded on their own), so member b is bitwise
// K1(theta_b) and K2p's terms are K2's; many members share a block, since
// a member is far smaller than K1's 32 x 32 tile: K1p a thread an entry
// over chunks of whole members, e^l and s2 of the block's members in
// shared memory; K2p a warp a chunk of one member's entries (x is y: the
// pairs i <= j weighed by Kbar_ij + Kbar_ji, as K2), the warp's butterfly,
// then each member's chunks summed in order by its last warp (a ticket a
// member, as fixed_sum.cuh): bitwise reproducible.  One launch each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "syrk_f64.cuh"  // cp.async

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 4;  // K1's and K2's (ops/gram.py's plan): 128 registers a thread
constexpr int TILE = 32;          // output tile edge
constexpr int EXACT_MAX_D = 8;    // an instance for each d up to this one
constexpr int MAX_D = 32;         // largest input dimension d
constexpr int FIXED_P = 3;        // p <= FIXED_P: the zero-padded degree-FIXED_P Horner
constexpr int EW_THREADS = 256;   // K1m
constexpr long long EW_MAX_BLOCKS = 2112;  // 16 per SM of the H100

template <typename T> struct M;
template <> struct M<double> {
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double sqrt(double v) { return ::sqrt(v); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};
template <> struct M<float> {
  static __device__ __forceinline__ float exp(float v) { return ::expf(v); }
  static __device__ __forceinline__ float sqrt(float v) { return ::sqrtf(v); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return ::fmaf(a, b, c);
  }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// A thread's place in a tile: C columns of one 16-byte access, S rows.
template <typename T>
struct Geo {
  static constexpr int C = 16 / sizeof(T);  // columns a thread
  static constexpr int LPR = TILE / C;      // lanes a tile row
  static constexpr int RW = 32 / LPR;       // rows a warp at a step
  static constexpr int RB = WARPS * RW;     // rows the block at a step
  static constexpr int S = TILE / RB;       // rows a thread
  static_assert(S * RB == TILE, "whole steps");
};

// The Matern polynomials, coef layout [c, a_0..a_p, b_0..b_p]:
//   k_p(h)  = e^{-ch} sum_k a_k t^k,      t = 2ch
//   k_p'(h) = c e^{-ch} sum_k b_k t^k,    b_k = 2(k+1) a_{k+1} - a_k
// by value in the working type, a and b zero-padded to degree FIXED_P
// (for p > FIXED_P only c and 2c are used)
template <typename T>
struct Coef {
  T c, twoc, a[FIXED_P + 1], b[FIXED_P + 1];
};

// sum_k w_k t^k by Horner's rule: P3, degree FIXED_P on the padded w;
// else degree p on dev (a device array, rounded to T as read)
template <typename T, bool P3>
__device__ __forceinline__ T poly(const T (&w)[FIXED_P + 1], const double* __restrict__ dev,
                                  int p, T t) {
  if constexpr (P3) {
    T acc = w[FIXED_P];
#pragma unroll
    for (int k = FIXED_P - 1; k >= 0; --k) acc = M<T>::fma(acc, t, w[k]);
    return acc;
  } else {
    T acc = static_cast<T>(__ldg(dev + p));
    for (int k = p - 1; k >= 0; --k) acc = M<T>::fma(acc, t, static_cast<T>(__ldg(dev + k)));
    return acc;
  }
}

// Item t's tile (I, J): x is y, the pairs I <= J in the order
// t = J (J + 1) / 2 + I; else t = I tj + J.
__device__ __forceinline__ void tile_of(int t, int tj, bool same, int& I, int& J) {
  if (same) {
    // the root of j (j + 1) / 2 = t, one step from its floor at most (no
    // loop: the item loop stays the kernel's innermost)
    long long j = static_cast<long long>((::sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    j -= j * (j + 1) / 2 > t;
    j += (j + 1) * (j + 2) / 2 <= t;
    J = static_cast<int>(j);
    I = t - static_cast<int>(j * (j + 1) / 2);
  } else {
    I = t / tj;
    J = t - I * tj;
  }
}

// (row, col) of a TILE x TILE tile in shared memory: 16-byte chunks
// swizzled by row
template <typename T>
__device__ __forceinline__ int slot(int row, int col) {
  constexpr int C = Geo<T>::C;
  return row * TILE + (((col / C) ^ ((row / C) & 7)) * C) + col % C;
}

// A tile's rows of x or y as this thread stages them: element e = tid +
// u THREADS of the TILE x dd block (coordinate e / TILE of row e % TILE)
template <int D>
struct Steps {
  static constexpr int N = (D * TILE + THREADS - 1) / THREADS;
};

// rows [r0, r0 + TILE) of src (rows x dd, row-major), this thread's
// elements, into registers (0 past the rows): loaded an item ahead
template <typename T, int D>
__device__ __forceinline__ void load_rows(T (&v)[Steps<D>::N], const T* __restrict__ src,
                                          int r0, int rows, int dd) {
#pragma unroll
  for (int u = 0; u < Steps<D>::N; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int k = e / TILE, g = r0 + e % TILE;
    v[u] = e < dd * TILE && g < rows ? __ldg(src + static_cast<long long>(g) * dd + k) : T(0);
  }
}

// the loaded rows scaled by e^l, each product rounded on its own, into
// dst[k][r]
template <typename T, int D>
__device__ __forceinline__ void put_rows(T (*dst)[TILE], const T (&v)[Steps<D>::N],
                                         const T* el, int dd) {
#pragma unroll
  for (int u = 0; u < Steps<D>::N; ++u) {
    const int e = threadIdx.x + u * THREADS;
    if (e < dd * TILE) dst[e / TILE][e % TILE] = M<T>::mul(el[e / TILE], v[u]);
  }
}

// the next item's rows (x, and y off the diagonal), loaded ahead
template <typename T, int D>
struct Ahead {
  T x[Steps<D>::N], y[Steps<D>::N];
  bool diag;
  int i0, j0;
};

template <typename T, int D>
__device__ __forceinline__ void load_item(Ahead<T, D>& a, const T* __restrict__ x,
                                          const T* __restrict__ y, int t, int n, int m, int tj,
                                          bool same, int dd) {
  int I, J;
  tile_of(t, tj, same, I, J);
  a.diag = same && I == J;
  a.i0 = I * TILE;
  a.j0 = J * TILE;
  load_rows<T, D>(a.x, x, a.i0, n, dd);
  if (!a.diag) load_rows<T, D>(a.y, y, a.j0, m, dd);
}

// e^{l_k} (k < dd) and s2 = e^{theta_0}, once per block, into shared memory
template <typename T>
__device__ __forceinline__ void scales(T* el_s, T* s2_s, const T* __restrict__ theta, int dd) {
  if (threadIdx.x < dd) el_s[threadIdx.x] = M<T>::exp(theta[1 + threadIdx.x]);
  if (threadIdx.x == THREADS - 1) *s2_s = M<T>::exp(theta[0]);
  __syncthreads();
}

// the thread's columns' scaled y, into registers (D <= EXACT_MAX_D)
template <typename T, int D, int C>
__device__ __forceinline__ void cols_of(T (&yv)[C][D], const T (*sy)[TILE], int c0) {
#pragma unroll
  for (int q = 0; q < C; ++q)
#pragma unroll
    for (int k = 0; k < D; ++k) yv[q][k] = sy[k][c0 + q];
}

// row r's scaled x, into registers (D <= EXACT_MAX_D)
template <typename T, int D>
__device__ __forceinline__ void rows_of(T (&xr)[D], const T (*sx)[TILE], int r) {
#pragma unroll
  for (int k = 0; k < D; ++k) xr[k] = sx[k][r];
}

// coordinate k of e^l x_i - e^l y_j for the tile's (r, c): from registers
// (YREG), else from the staged rows
template <typename T, bool YREG, int DX, int DY>
__device__ __forceinline__ T coord_diff(const T (&xr)[DX], const T (&yq)[DY], const T (*sx)[TILE],
                                        const T (*sy)[TILE], int k, int r, int c) {
  if constexpr (YREG)
    return xr[k] - yq[k];
  else
    return sx[k][r] - sy[k][c];
}

// A thread's shared-memory offsets in a tile, the same for every item:
// row[s] = slot(r_s, c0) (its C columns of row r_s), col[s] = slot(c0, r_s)
// (column r_s of its rows c0 .. c0 + C - 1 at col[s] + q TILE: the rows
// c0 + q share the swizzle, since (c0 + q) / C = c0 / C)
template <typename T>
struct Offsets {
  int row[Geo<T>::S], col[Geo<T>::S];
};

template <typename T>
__device__ __forceinline__ Offsets<T> offsets_of(int r0, int c0) {
  Offsets<T> o;
#pragma unroll
  for (int s = 0; s < Geo<T>::S; ++s) {
    o.row[s] = slot<T>(r0 + s * Geo<T>::RB, c0);
    o.col[s] = slot<T>(c0, r0 + s * Geo<T>::RB);
  }
  return o;
}

// An item's kind: MASKED (a diagonal tile of x is y, or a tile past the
// last row or column: its entries masked), else a whole tile off the
// diagonal, x is y (FULL_SAME) or not (FULL_CROSS), with no mask
enum Kind { MASKED, FULL_SAME, FULL_CROSS };

// 16-byte shared-memory accesses of a tile chunk (slot(r, c) for c a
// multiple of C)
__device__ __forceinline__ void sts16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void sts16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void lds16(const double* p, double (&v)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void lds16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  __stwb(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// a thread's C entries of a row at p = row + col: one 16-byte store (vec),
// else scalar stores of those below m
template <typename T, int C>
__device__ __forceinline__ void store_row(T* p, const T (&v)[C], long long col, long long m,
                                          bool vec) {
  if (vec) {
    store16(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (col + q < m) p[q] = v[q];
  }
}

// K1's value of one entry from its d2 = sum_k diff_k^2 (fused
// multiply-adds in the order of k): s2 k_p(sqrt(d2)), 0 at h = inf; the
// diagonal of x is y adds the nugget after (K1 and K1p share it)
template <typename T, bool P3>
__device__ __forceinline__ T gram_value(T d2, T sigma2, const Coef<T>& cf,
                                        const double* __restrict__ coef, int p) {
  const T h = M<T>::sqrt(d2);
  T kv = M<T>::exp(-cf.c * h) * poly<T, P3>(cf.a, coef + 1, p, cf.twoc * h);
  if (isinf(h)) kv = T(0);
  return M<T>::mul(sigma2, kv);
}

// K1's entries of an item, v[s][q] = K(i0 + r_s, j0 + c0 + q) (0 where
// not computed); MASK: skip the entries past n or m and, on the diagonal
// (diag), those below it
template <typename T, int D, bool P3, bool MASK>
__device__ __forceinline__ void gram_item(T (&v)[Geo<T>::S][Geo<T>::C], const T (*sx)[TILE],
                                          const T (*syp)[TILE], int i0, int j0, int n, int m,
                                          bool diag, int r0, int c0, int dd, T sigma2, T nugget,
                                          const Coef<T>& cf, const double* __restrict__ coef,
                                          int p) {
  using G = Geo<T>;
  constexpr int C = G::C, S = G::S;
  constexpr bool YREG = D <= EXACT_MAX_D;
  T yv[C][YREG ? D : 1];
  if constexpr (YREG) cols_of<T, D, C>(yv, syp, c0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = r0 + s * G::RB;
    const bool row_in = !MASK || i0 + r < n;
    T xr[YREG ? D : 1];
    if constexpr (YREG) rows_of<T, D>(xr, sx, r);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = c0 + q;
      v[s][q] = T(0);
      if (MASK && (!row_in || j0 + c >= m || (diag && r > c))) continue;
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < dd) {
          const T diff = coord_diff<T, YREG>(xr, yv[q], sx, syp, k, r, c);
          d2 = M<T>::fma(diff, diff, d2);
        }
      }
      T val = gram_value<T, P3>(d2, sigma2, cf, coef, p);
      if (MASK && diag && r == c) val = M<T>::add(val, nugget);
      v[s][q] = val;
    }
  }
}

// K1.  D = EXACT ? the dimension : MAX_D (d at run time); P3: p <= FIXED_P.
// The first item's rows are read before the block waits for e^l, each
// next item's while the current one computes.
template <typename T, int D, bool P3>
__global__ void __launch_bounds__(THREADS, D <= EXACT_MAX_D ? BLOCKS_PER_SM : 2)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ theta,
            const Coef<T> cf, const double* __restrict__ coef, T* __restrict__ out, int n, int m,
            int d, int p, int same, T eps, int items, int vec) {
  using G = Geo<T>;
  constexpr int C = G::C, S = G::S;
  constexpr bool YREG = D <= EXACT_MAX_D;
  __shared__ T el_s[D];
  __shared__ T s2_s;
  __shared__ T sx[D][TILE];
  __shared__ T sy[D][TILE];
  __shared__ __align__(16) T tile[TILE * TILE];
  const int dd = YREG ? D : d;
  const int tj = (m + TILE - 1) / TILE;
  Ahead<T, D> next;
  load_item<T, D>(next, x, y, blockIdx.x, n, m, tj, same, dd);
  scales<T>(el_s, &s2_s, theta, dd);
  const T sigma2 = s2_s;
  const T nugget = T(10) * sigma2 * eps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = C * (lane % G::LPR), r0 = warp * G::RW + lane / G::LPR;
  const Offsets<T> off = offsets_of<T>(r0, c0);
#pragma unroll 1
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const bool diag = next.diag;
    const int i0 = next.i0, j0 = next.j0;
    __syncthreads();  // the previous item's reads of sx, sy and tile are done
    put_rows<T, D>(sx, next.x, el_s, dd);
    if (!diag) put_rows<T, D>(sy, next.y, el_s, dd);
    if (t + static_cast<int>(gridDim.x) < items)
      load_item<T, D>(next, x, y, t + gridDim.x, n, m, tj, same, dd);
    __syncthreads();
    const T(*syp)[TILE] = diag ? sx : sy;
    const bool cols_in = j0 + c0 < m;
    T v[S][C];
    if (!diag && i0 + TILE <= n && j0 + TILE <= m)
      gram_item<T, D, P3, false>(v, sx, syp, i0, j0, n, m, false, r0, c0, dd, sigma2, nugget, cf,
                                 coef, p);
    else
      gram_item<T, D, P3, true>(v, sx, syp, i0, j0, n, m, diag, r0, c0, dd, sigma2, nugget, cf,
                                coef, p);
    if (!same) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = i0 + r0 + s * G::RB;
        if (i < n && cols_in)
          store_row<T, C>(out + static_cast<long long>(i) * m + j0 + c0, v[s], j0 + c0, m, vec);
      }
      continue;
    }
    // x is y: the tile through shared memory, for its transpose
#pragma unroll
    for (int s = 0; s < S; ++s) sts16(tile + off.row[s], v[s]);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = r0 + s * G::RB;
      T w[C];
      if (diag) {
        // (r, c) for r <= c from registers, for r > c the computed (c, r)
#pragma unroll
        for (int q = 0; q < C; ++q) w[q] = r <= c0 + q ? v[s][q] : tile[off.col[s] + q * TILE];
        if (i0 + r < n && cols_in)
          store_row<T, C>(out + static_cast<long long>(i0 + r) * m + i0 + c0, w, i0 + c0, m, vec);
      } else {
        if (i0 + r < n && cols_in)
          store_row<T, C>(out + static_cast<long long>(i0 + r) * m + j0 + c0, v[s], j0 + c0, m,
                          vec);
        // row j0 + r of (J, I): the computed column r (tile I is whole: I < J)
#pragma unroll
        for (int q = 0; q < C; ++q) w[q] = tile[off.col[s] + q * TILE];
        if (j0 + r < n)
          store_row<T, C>(out + static_cast<long long>(j0 + r) * m + i0 + c0, w, i0 + c0, m, vec);
      }
    }
  }
}

// Kbar rows [r0, r0 + TILE) x columns [q0, q0 + TILE) into the swizzled
// tile dst by cp.async (entries past rows x cols zero-filled): 16-byte
// copies (vec: ld a multiple of C and the base 16-byte aligned), else one
// copy an entry
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, int r0, int q0,
                                          int rows, int cols, int ld, bool vec) {
  constexpr int C = Geo<T>::C, CH = TILE / C;
  if (vec) {
#pragma unroll
    for (int u = 0; u < TILE * CH / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS, a = e / CH, g = e % CH;
      const int gr = r0 + a, gc = q0 + g * C;
      const bool ok = gr < rows && gc < cols;
      syrk::cp_async<16>(dst + slot<T>(a, g * C),
                         ok ? src + static_cast<long long>(gr) * ld + gc : src, ok);
    }
  } else {
#pragma unroll
    for (int u = 0; u < TILE * TILE / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS, a = e / TILE, b = e % TILE;
      const int gr = r0 + a, gc = q0 + b;
      const bool ok = gr < rows && gc < cols;
      syrk::cp_async<static_cast<int>(sizeof(T))>(
          dst + slot<T>(a, b), ok ? src + static_cast<long long>(gr) * ld + gc : src, ok);
    }
  }
}

// an item's Kbar tiles into buf: (I, J) at (i0, j0), and with ``both``
// (x is y off the diagonal) (J, I)
template <typename T>
__device__ __forceinline__ void copy_item(T* buf, const T* __restrict__ kbar, int i0, int j0,
                                          int n, int m, bool both, bool vec) {
  copy_tile<T>(buf, kbar, i0, j0, n, m, m, vec);
  if (both) copy_tile<T>(buf + TILE * TILE, kbar, j0, i0, n, m, m, vec);
}

// acc[0] += wkb K_ij and, where h > 0, acc[1 + k] += w sq_k, w the term
// weight wkb s2 k_p'(h) / h (f64: one rsqrt; f32: sqrtf and a division)
template <typename T, bool P3, bool NUG, int D>
__device__ __forceinline__ void pull_entry(double (&acc)[1 + D], const T (&sq)[D], int dd, T d2,
                                           T wkb, T sigma2, T nug, const Coef<T>& cf,
                                           const double* __restrict__ coef, int p) {
  if constexpr (sizeof(T) == 8) {
    const bool pos = d2 > 0.0 && !isinf(d2);
    const double r = pos ? ::rsqrt(d2) : 0.0;
    const double h = d2 * r;
    const double e = ::exp(-cf.c * h), t = cf.twoc * h;
    const double kv = isinf(d2) ? 0.0 : e * poly<double, P3>(cf.a, coef + 1, p, t);
    acc[0] = ::fma(wkb, NUG ? sigma2 * kv + nug : sigma2 * kv, acc[0]);
    if (pos) {
      const double w = wkb * sigma2 * (cf.c * e * poly<double, P3>(cf.b, coef + 2 + p, p, t)) * r;
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (k < dd) acc[1 + k] = ::fma(w, sq[k], acc[1 + k]);
    }
  } else {
    const float h = ::sqrtf(d2);
    const float e = ::expf(-cf.c * h), t = cf.twoc * h;
    const bool fin = !isinf(h);
    const float kv = fin ? e * poly<float, P3>(cf.a, coef + 1, p, t) : 0.f;
    acc[0] += static_cast<double>(__fmul_rn(wkb, NUG ? sigma2 * kv + nug : sigma2 * kv));
    if (h > 0.f && fin) {
      const float w = wkb * sigma2 * (cf.c * e * poly<float, P3>(cf.b, coef + 2 + p, p, t)) / h;
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (k < dd) acc[1 + k] += static_cast<double>(__fmul_rn(w, sq[k]));
    }
  }
}

// K2's terms of an item, added to acc in the thread's order (rows, then
// columns); kd the item's Kbar tile (I, J), kt (J, I) (the same tile on
// the diagonal), both swizzled; KIND as Kind
template <typename T, int D, bool P3, int KIND>
__device__ __forceinline__ void pull_item(double (&acc)[1 + D], const T* kd, const T* kt,
                                          const T (*sx)[TILE], const T (*syp)[TILE],
                                          const Offsets<T>& off, int i0, int j0, int n, int m,
                                          bool same, bool diag, int r0, int c0, int dd, T sigma2,
                                          T nugget, const Coef<T>& cf,
                                          const double* __restrict__ coef, int p) {
  using G = Geo<T>;
  constexpr int C = G::C, S = G::S;
  constexpr bool YREG = D <= EXACT_MAX_D, MASK = KIND == MASKED;
  T yv[C][YREG ? D : 1];
  if constexpr (YREG) cols_of<T, D, C>(yv, syp, c0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = r0 + s * G::RB;
    const bool row_in = !MASK || i0 + r < n;
    const int orow = off.row[s], ocol = off.col[s];
    T kr[C];
    lds16(kd + orow, kr);
    T xr[YREG ? D : 1];
    if constexpr (YREG) rows_of<T, D>(xr, sx, r);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = c0 + q;
      if (MASK && (!row_in || j0 + c >= m || (diag && r > c))) continue;
      // the pair's weight: Kbar_ij (+ Kbar_ji for x is y, i != j)
      T wkb = kr[q];
      if (KIND == FULL_SAME || (MASK && same && !(diag && r == c)))
        wkb += kt[ocol + q * TILE];
      T sq[D];
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < dd) {
          const T diff = coord_diff<T, YREG>(xr, yv[q], sx, syp, k, r, c);
          sq[k] = M<T>::mul(diff, diff);
          d2 += sq[k];
        }
      }
      pull_entry<T, P3, MASK, D>(acc, sq, dd, d2, wkb, sigma2,
                                 MASK && diag && r == c ? nugget : T(0), cf, coef, p);
    }
  }
}

// K2.  D and P3 as K1's; NB Kbar buffers (2: the next item's copies in
// flight while the current one computes), its rows read ahead as K1's.
template <typename T, int D, bool P3>
__global__ void __launch_bounds__(THREADS, D <= EXACT_MAX_D ? BLOCKS_PER_SM : 2)
pullback_kernel(const T* __restrict__ kbar, const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ theta, const Coef<T> cf, const double* __restrict__ coef,
                double* __restrict__ partial, unsigned int* __restrict__ ticket,
                double* __restrict__ out, int n, int m, int d, int p, int same, T eps, int items,
                int vec) {
  using G = Geo<T>;
  constexpr int C = G::C, S = G::S, Q = 1 + D;
  constexpr bool YREG = D <= EXACT_MAX_D;
  constexpr int NB = YREG ? 2 : 1;
  __shared__ T el_s[D];
  __shared__ T s2_s;
  __shared__ T sx[D][TILE];
  __shared__ T sy[D][TILE];
  __shared__ __align__(16) T kbs[NB][2 * TILE * TILE];
  __shared__ fixed_sum::Smem<Q, THREADS> sm;
  const int dd = YREG ? D : d;
  const int tj = (m + TILE - 1) / TILE;
  Ahead<T, D> next;
  load_item<T, D>(next, x, y, blockIdx.x, n, m, tj, same, dd);
  if constexpr (NB == 2) {
    copy_item<T>(kbs[0], kbar, next.i0, next.j0, n, m, same && !next.diag, vec);
    syrk::cp_commit();
  }
  scales<T>(el_s, &s2_s, theta, dd);
  const T sigma2 = s2_s;
  const T nugget = T(10) * sigma2 * eps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = C * (lane % G::LPR), r0 = warp * G::RW + lane / G::LPR;
  const Offsets<T> off = offsets_of<T>(r0, c0);
  double acc[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) acc[k] = 0.0;
  int it = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < items; t += gridDim.x, ++it) {
    const int b = NB == 2 ? (it & 1) : 0;
    const bool diag = next.diag;
    const int i0 = next.i0, j0 = next.j0;
    __syncthreads();  // the previous item's reads of sx, sy and its buffer are done
    if constexpr (NB == 1) copy_item<T>(kbs[0], kbar, i0, j0, n, m, same && !diag, vec);
    put_rows<T, D>(sx, next.x, el_s, dd);
    if (!diag) put_rows<T, D>(sy, next.y, el_s, dd);
    if (t + static_cast<int>(gridDim.x) < items) {
      load_item<T, D>(next, x, y, t + gridDim.x, n, m, tj, same, dd);
      if constexpr (NB == 2)
        copy_item<T>(kbs[b ^ 1], kbar, next.i0, next.j0, n, m, same && !next.diag, vec);
    }
    syrk::cp_commit();
    syrk::cp_wait<NB - 1>();  // item t's copies (this thread's) have landed
    __syncthreads();          // ... every thread's, and the staged rows
    const T(*syp)[TILE] = diag ? sx : sy;
    const T* kd = kbs[b];
    const T* kt = diag ? kd : kbs[b] + TILE * TILE;
    if (diag || i0 + TILE > n || j0 + TILE > m)
      pull_item<T, D, P3, MASKED>(acc, kd, kt, sx, syp, off, i0, j0, n, m, same, diag, r0, c0,
                                  dd, sigma2, nugget, cf, coef, p);
    else if (same)
      pull_item<T, D, P3, FULL_SAME>(acc, kd, kt, sx, syp, off, i0, j0, n, m, true, false, r0,
                                     c0, dd, sigma2, nugget, cf, coef, p);
    else
      pull_item<T, D, P3, FULL_CROSS>(acc, kd, kt, sx, syp, off, i0, j0, n, m, false, false, r0,
                                      c0, dd, sigma2, nugget, cf, coef, p);
  }
  if (fixed_sum::grid_sum(sm, acc, partial, ticket)) {
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (k <= dd) out[k] = acc[k];
  }
}

// ----------------------------------------------------------------------------
// K1p and K2p: K1 and K2 for a population of B parameter vectors theta_b at
// one x and y (ops/gram.py population_plan).  Each entry takes K1's (K2's)
// arithmetic, so member b's gram is bitwise K1(theta_b) and member b's
// pullback terms are K2's, summed in another fixed order.  A member's
// entries are few on the samplers' path (n = 8: 64), so a block takes
// several members: K1p cuts the stack of B n m entries into POP_CHUNK-entry
// chunks of whole member groups, K2p gives a warp POP_WARP_ENTRIES entries
// of one member.  D: POP_EXACT_D (d up to it, the loops unrolled with a
// guard on k < d) or MAX_D; P3 as K1's.
// ----------------------------------------------------------------------------
constexpr int POP_THREADS = 256;         // a block (K1p, K2p)
constexpr int POP_CHUNK = 512;           // K1p: entries a block
constexpr int POP_MAX_MEMBERS = 64;      // K1p: members a block
constexpr int POP_WARP_ENTRIES = 1024;   // K2p: a member's entries a warp
constexpr int POP_EXACT_D = 8;

// K1p: out[b] = K(x, y; theta_b) (B, n, m).  Block g c takes members
// [g mb, g mb + mb) (whole members: mb n m <= POP_CHUNK unless mb = 1) and
// chunk c of their mb n m entries; e^l and s2 of its members in shared
// memory, then a thread an entry, consecutive threads on consecutive
// entries (coalesced scalar stores).
template <typename T, int D, bool P3>
__global__ void __launch_bounds__(POP_THREADS)
population_gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ theta, const Coef<T> cf,
                       const double* __restrict__ coef, T* __restrict__ out, int n, int m, int d,
                       int p, int same, T eps, int members, int mb, int chunks) {
  __shared__ T el_s[POP_MAX_MEMBERS][D];
  __shared__ T s2_s[POP_MAX_MEMBERS];
  const int g = blockIdx.x / chunks, c = blockIdx.x - g * chunks;
  const int b0 = g * mb, nb = min(mb, members - b0);
  for (int e = threadIdx.x; e < nb * (d + 1); e += POP_THREADS) {
    const int u = e / (d + 1), k = e - u * (d + 1);
    const T v = M<T>::exp(theta[static_cast<long long>(b0 + u) * (d + 1) + k]);
    if (k == 0)
      s2_s[u] = v;
    else
      el_s[u][k - 1] = v;
  }
  __syncthreads();
  const long long per = static_cast<long long>(n) * m;
  const long long end = nb * per;
  T* const base = out + b0 * per;
  for (long long e = static_cast<long long>(c) * POP_CHUNK + threadIdx.x;
       e < end && e < static_cast<long long>(c + 1) * POP_CHUNK; e += POP_THREADS) {
    const int u = static_cast<int>(e / per);
    const long long rem = e - u * per;
    const int i = static_cast<int>(rem / m), j = static_cast<int>(rem - static_cast<long long>(i) * m);
    const T* xi = x + static_cast<long long>(i) * d;
    const T* yj = y + static_cast<long long>(j) * d;
    T d2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < d) {
        const T diff = M<T>::mul(el_s[u][k], __ldg(xi + k)) - M<T>::mul(el_s[u][k], __ldg(yj + k));
        d2 = M<T>::fma(diff, diff, d2);
      }
    }
    const T sigma2 = s2_s[u];
    T val = gram_value<T, P3>(d2, sigma2, cf, coef, p);
    if (same && i == j) val = M<T>::add(val, T(10) * sigma2 * eps);
    base[e] = val;
  }
}

// K2p: out[b] = grad_theta_b <Kbar_b, K(x, y; theta_b)> (B, 1 + d) f64.
// Warp w takes member w / chunks and entries [c W, c W + W) of its n m
// (c = w % chunks, W = POP_WARP_ENTRIES), lane l the entries l, l + 32, ...
// of them: K2's terms (for x is y the pairs i <= j, weighed by Kbar_ij +
// Kbar_ji off the diagonal), summed per lane in that order, then by the
// butterfly of fixed_sum.cuh over the warp's lanes.  A member of one chunk
// is written by its warp; else the chunks' sums go to partial and the last
// warp of the member to take its ticket sums them in chunk order, writes
// the 1 + d results and resets the ticket: bitwise reproducible.
template <typename T, int D, bool P3>
__global__ void __launch_bounds__(POP_THREADS)
population_pullback_kernel(const T* __restrict__ kbar, const T* __restrict__ x,
                           const T* __restrict__ y, const T* __restrict__ theta,
                           const Coef<T> cf, const double* __restrict__ coef,
                           double* __restrict__ partial, unsigned int* __restrict__ ticket,
                           double* __restrict__ out, int n, int m, int d, int p, int same, T eps,
                           int members, int chunks) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * (POP_THREADS / 32) + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(members) * chunks) return;  // whole warps
  const int b = static_cast<int>(w / chunks), c = static_cast<int>(w - static_cast<long long>(b) * chunks);
  const T* th = theta + static_cast<long long>(b) * (d + 1);
  const T mine = lane < d ? M<T>::exp(th[1 + lane]) : T(0);
  T el[D];
#pragma unroll
  for (int k = 0; k < D; ++k) el[k] = __shfl_sync(FULL, mine, k);
  const T sigma2 = M<T>::exp(th[0]);
  const T nugget = T(10) * sigma2 * eps;
  const long long per = static_cast<long long>(n) * m;
  const T* kb = kbar + static_cast<long long>(b) * per;
  double acc[1 + D];
#pragma unroll
  for (int k = 0; k <= D; ++k) acc[k] = 0.0;
  const long long e1 = min(per, static_cast<long long>(c + 1) * POP_WARP_ENTRIES);
  for (long long e = static_cast<long long>(c) * POP_WARP_ENTRIES + lane; e < e1; e += 32) {
    const int i = static_cast<int>(e / m), j = static_cast<int>(e - static_cast<long long>(i) * m);
    if (same && i > j) continue;
    T wkb = kb[e];
    if (same && i != j) wkb += kb[static_cast<long long>(j) * m + i];
    const T* xi = x + static_cast<long long>(i) * d;
    const T* yj = y + static_cast<long long>(j) * d;
    T sq[D];
    T d2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < d) {
        const T diff = M<T>::mul(el[k], __ldg(xi + k)) - M<T>::mul(el[k], __ldg(yj + k));
        sq[k] = M<T>::mul(diff, diff);
        d2 += sq[k];
      }
    }
    pull_entry<T, P3, true, D>(acc, sq, d, d2, wkb, sigma2, same && i == j ? nugget : T(0), cf,
                               coef, p);
  }
#pragma unroll
  for (int q = 0; q <= D; ++q)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc[q] += __shfl_xor_sync(FULL, acc[q], s);
  double* const res = out + static_cast<long long>(b) * (d + 1);
  if (chunks == 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q <= D; ++q)
        if (q <= d) res[q] = acc[q];
    }
    return;
  }
  double* const part = partial + static_cast<long long>(b) * chunks * (d + 1);
  unsigned last = 0;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q <= D; ++q)
      if (q <= d) part[static_cast<long long>(c) * (d + 1) + q] = acc[q];
    __threadfence();  // the sums are visible before the ticket counts them
    last = atomicAdd(ticket + b, 1u) == static_cast<unsigned>(chunks - 1);
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  for (int q = lane; q <= d; q += 32) {
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) s += __ldcg(part + static_cast<long long>(k) * (d + 1) + q);
    res[q] = s;
  }
  if (lane == 0) ticket[b] = 0u;
}

// K1m's Horner: the device coefficients, the run-time degree p
template <typename T>
__device__ __forceinline__ T horner(const double* __restrict__ a, int p, T t) {
  T acc = static_cast<T>(a[p]);
  for (int k = p - 1; k >= 0; --k) acc = acc * t + static_cast<T>(a[k]);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
maternp_elem_kernel(const T* __restrict__ h_in, const double* __restrict__ coef,
                    T* __restrict__ out, long long count, int p) {
  const T c = static_cast<T>(coef[0]);
  const T twoc = static_cast<T>(2.0 * coef[0]);
  const double* a = coef + 1;
  for (long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * EW_THREADS) {
    const T h = h_in[i];
    const T kv = M<T>::exp(-c * h) * horner<T>(a, p, twoc * h);
    out[i] = isinf(h) ? T(0) : kv;
  }
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
maternp_elem_backward_kernel(const T* __restrict__ h_in, const T* __restrict__ kbar,
                             const double* __restrict__ coef, T* __restrict__ out,
                             long long count, int p) {
  const T c = static_cast<T>(coef[0]);
  const T twoc = static_cast<T>(2.0 * coef[0]);
  const double* b = coef + 2 + p;
  for (long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * EW_THREADS) {
    const T h = h_in[i];
    const T dk = c * M<T>::exp(-c * h) * horner<T>(b, p, twoc * h);  // k_p'(h)
    out[i] = isinf(h) ? T(0) : kbar[i] * dk;
  }
}

unsigned ew_blocks(long long count) {
  const long long b = (count + EW_THREADS - 1) / EW_THREADS;
  return static_cast<unsigned>(b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS);
}

template <typename T>
int launch_maternp(const void* h, const void* kbar, const void* coef, void* out,
                   long long count, int p, void* stream) {
  if (count <= 0 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kbar == nullptr)
    maternp_elem_kernel<T><<<ew_blocks(count), EW_THREADS, 0, s>>>(
        static_cast<const T*>(h), static_cast<const double*>(coef), static_cast<T*>(out),
        count, p);
  else
    maternp_elem_backward_kernel<T><<<ew_blocks(count), EW_THREADS, 0, s>>>(
        static_cast<const T*>(h), static_cast<const T*>(kbar),
        static_cast<const double*>(coef), static_cast<T*>(out), count, p);
  return static_cast<int>(cudaGetLastError());
}

// the plan of ops/gram.py gram_plan: TILE-wide tiles, the pairs I <= J for
// x is y (n = m), every (I, J) else, at most one block an item
bool bad_plan(long long n, long long m, int d, int p, int same, long long tile, long long items,
              long long blocks) {
  const long long ti = (n + TILE - 1) / TILE, tj = (m + TILE - 1) / TILE;
  return n <= 0 || m <= 0 || n > 0x7fffffffLL - TILE || m > 0x7fffffffLL - TILE || d < 1 ||
         d > MAX_D || p < 0 || (same && n != m) || tile != TILE ||
         items != (same ? ti * (ti + 1) / 2 : ti * tj) || items > 0x7fffffffLL || blocks <= 0 ||
         blocks > items;
}

// host coefficients [c, a_0..a_p, b_0..b_p] -> Coef<T> (a, b zero-padded
// for p <= FIXED_P)
template <typename T>
Coef<T> coef_of(const double* h, int p) {
  Coef<T> cf{};
  cf.c = static_cast<T>(h[0]);
  cf.twoc = static_cast<T>(2.0 * h[0]);
  for (int k = 0; k <= FIXED_P; ++k) {
    cf.a[k] = k <= p ? static_cast<T>(h[1 + k]) : T(0);
    cf.b[k] = k <= p ? static_cast<T>(h[2 + p + k]) : T(0);
  }
  return cf;
}

// F::run<D, P3>(args...) with D = d where d <= EXACT_MAX_D and p <= FIXED_P,
// else MAX_D (p > FIXED_P, off the main paths, reads d at run time too)
static_assert(EXACT_MAX_D == 8, "one case a d below");
template <typename F, bool P3, typename... A>
int by_d(int d, A... a) {
  if constexpr (!P3) {
    return F::template run<MAX_D, false>(a...);
  } else {
    switch (d) {
      case 1: return F::template run<1, true>(a...);
      case 2: return F::template run<2, true>(a...);
      case 3: return F::template run<3, true>(a...);
      case 4: return F::template run<4, true>(a...);
      case 5: return F::template run<5, true>(a...);
      case 6: return F::template run<6, true>(a...);
      case 7: return F::template run<7, true>(a...);
      case 8: return F::template run<8, true>(a...);
      default: return F::template run<MAX_D, true>(a...);
    }
  }
}

struct Gram {
  template <int D, bool P3, typename T>
  static int run(const T* x, const T* y, const T* theta, Coef<T> cf, const double* coef, T* out,
                 long long n, long long m, int d, int p, int same, T eps, long long items,
                 long long blocks, cudaStream_t s) {
    const int vec = m % Geo<T>::C == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    gram_kernel<T, D, P3><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        x, y, theta, cf, coef, out, static_cast<int>(n), static_cast<int>(m), d, p, same, eps,
        static_cast<int>(items), vec);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Pullback {
  template <int D, bool P3, typename T>
  static int run(const T* kbar, const T* x, const T* y, const T* theta, Coef<T> cf,
                 const double* coef, double* partial, unsigned int* ticket, double* out,
                 long long n, long long m, int d, int p, int same, T eps, long long items,
                 long long blocks, cudaStream_t s) {
    const int vec = m % Geo<T>::C == 0 && reinterpret_cast<uintptr_t>(kbar) % 16 == 0;
    pullback_kernel<T, D, P3><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        kbar, x, y, theta, cf, coef, partial, ticket, out, static_cast<int>(n),
        static_cast<int>(m), d, p, same, eps, static_cast<int>(items), vec);
    return static_cast<int>(cudaGetLastError());
  }
};

// K1p's and K2p's instances: D = POP_EXACT_D (d up to it, p <= FIXED_P),
// else MAX_D
template <typename F, typename... A>
int by_pop_d(int d, int p, A... a) {
  if (p > FIXED_P) return F::template run<MAX_D, false>(a...);
  return d <= POP_EXACT_D ? F::template run<POP_EXACT_D, true>(a...)
                          : F::template run<MAX_D, true>(a...);
}

// the plans of ops/gram.py population_plan
long long pop_gram_blocks(long long members, long long n, long long m, long long mb,
                          long long chunks) {
  if (n <= 0 || m <= 0 || n > 0x7fffffffLL || m > 0x7fffffffLL) return -1;
  const long long per = n * m, fit = POP_CHUNK / per;
  const long long want_mb = fit < 1 ? 1 : (fit < POP_MAX_MEMBERS ? fit : POP_MAX_MEMBERS);
  if (mb != want_mb || chunks != (mb * per + POP_CHUNK - 1) / POP_CHUNK) return -1;
  return (members + mb - 1) / mb * chunks;
}

long long pop_pullback_blocks(long long members, long long n, long long m, long long chunks) {
  if (n <= 0 || m <= 0 || n > 0x7fffffffLL || m > 0x7fffffffLL) return -1;
  const long long per = n * m;
  if (chunks != (per + POP_WARP_ENTRIES - 1) / POP_WARP_ENTRIES) return -1;
  return (members * chunks + POP_THREADS / 32 - 1) / (POP_THREADS / 32);
}

bool bad_population(long long members, long long n, long long m, int d, int p, int same,
                    long long blocks, long long want) {
  return members <= 0 || members > 0x7fffffffLL || n <= 0 || m <= 0 || n > 0x7fffffffLL ||
         m > 0x7fffffffLL || d < 1 ||
         d > MAX_D || p < 0 || (same && n != m) || want <= 0 || blocks != want ||
         blocks > 0x7fffffffLL;
}

struct PopGram {
  template <int D, bool P3, typename T>
  static int run(const T* x, const T* y, const T* theta, Coef<T> cf, const double* coef, T* out,
                 long long members, long long n, long long m, int d, int p, int same, T eps,
                 long long mb, long long chunks, long long blocks, cudaStream_t s) {
    population_gram_kernel<T, D, P3><<<static_cast<unsigned>(blocks), POP_THREADS, 0, s>>>(
        x, y, theta, cf, coef, out, static_cast<int>(n), static_cast<int>(m), d, p, same, eps,
        static_cast<int>(members), static_cast<int>(mb), static_cast<int>(chunks));
    return static_cast<int>(cudaGetLastError());
  }
};

struct PopPullback {
  template <int D, bool P3, typename T>
  static int run(const T* kbar, const T* x, const T* y, const T* theta, Coef<T> cf,
                 const double* coef, double* partial, unsigned int* ticket, double* out,
                 long long members, long long n, long long m, int d, int p, int same, T eps,
                 long long chunks, long long blocks, cudaStream_t s) {
    population_pullback_kernel<T, D, P3><<<static_cast<unsigned>(blocks), POP_THREADS, 0, s>>>(
        kbar, x, y, theta, cf, coef, partial, ticket, out, static_cast<int>(n),
        static_cast<int>(m), d, p, same, eps, static_cast<int>(members),
        static_cast<int>(chunks));
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch_population_gram(const void* x, const void* y, const void* theta, const void* hcoef,
                           const void* coef, void* out, long long members, long long n,
                           long long m, int d, int p, int same, double eps, long long mb,
                           long long chunks, long long blocks, void* stream) {
  if (bad_population(members, n, m, d, p, same, blocks,
                     pop_gram_blocks(members, n, m, mb, chunks)) ||
      !x || !y || !theta || !hcoef || !out || (p > FIXED_P && !coef))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_pop_d<PopGram>(d, p, static_cast<const T*>(x), static_cast<const T*>(y),
                           static_cast<const T*>(theta),
                           coef_of<T>(static_cast<const double*>(hcoef), p),
                           static_cast<const double*>(coef), static_cast<T*>(out), members, n, m,
                           d, p, same, static_cast<T>(eps), mb, chunks, blocks,
                           static_cast<cudaStream_t>(stream));
}

template <typename T>
int launch_population_pullback(const void* kbar, const void* x, const void* y, const void* theta,
                               const void* hcoef, const void* coef, void* partial, void* ticket,
                               void* out, long long members, long long n, long long m, int d,
                               int p, int same, double eps, long long chunks, long long blocks,
                               void* stream) {
  if (bad_population(members, n, m, d, p, same, blocks,
                     pop_pullback_blocks(members, n, m, chunks)) ||
      !kbar || !x || !y || !theta || !hcoef || !partial || !ticket || !out ||
      (p > FIXED_P && !coef))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_pop_d<PopPullback>(
      d, p, static_cast<const T*>(kbar), static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(theta), coef_of<T>(static_cast<const double*>(hcoef), p),
      static_cast<const double*>(coef), static_cast<double*>(partial),
      static_cast<unsigned int*>(ticket), static_cast<double*>(out), members, n, m, d, p, same,
      static_cast<T>(eps), chunks, blocks, static_cast<cudaStream_t>(stream));
}

template <typename T>
int launch_gram(const void* x, const void* y, const void* theta, const void* hcoef,
                const void* coef, void* out, long long n, long long m, int d, int p, int same,
                double eps, long long tile, long long items, long long blocks, void* stream) {
  if (bad_plan(n, m, d, p, same, tile, items, blocks) || !x || !y || !theta || !hcoef || !out ||
      (p > FIXED_P && !coef))
    return static_cast<int>(cudaErrorInvalidValue);
  const Coef<T> cf = coef_of<T>(static_cast<const double*>(hcoef), p);
  const T *xx = static_cast<const T*>(x), *yy = static_cast<const T*>(y),
          *th = static_cast<const T*>(theta);
  const double* dc = static_cast<const double*>(coef);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T e = static_cast<T>(eps);
  return p <= FIXED_P
             ? by_d<Gram, true>(d, xx, yy, th, cf, dc, o, n, m, d, p, same, e, items, blocks, s)
             : by_d<Gram, false>(d, xx, yy, th, cf, dc, o, n, m, d, p, same, e, items, blocks, s);
}

template <typename T>
int launch_pullback(const void* kbar, const void* x, const void* y, const void* theta,
                    const void* hcoef, const void* coef, void* partial, void* ticket, void* out,
                    long long n, long long m, int d, int p, int same, double eps, long long tile,
                    long long items, long long blocks, void* stream) {
  if (bad_plan(n, m, d, p, same, tile, items, blocks) || !kbar || !x || !y || !theta || !hcoef ||
      !partial || !ticket || !out || (p > FIXED_P && !coef))
    return static_cast<int>(cudaErrorInvalidValue);
  const Coef<T> cf = coef_of<T>(static_cast<const double*>(hcoef), p);
  const T *kb = static_cast<const T*>(kbar), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y), *th = static_cast<const T*>(theta);
  const double* dc = static_cast<const double*>(coef);
  double* part = static_cast<double*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T e = static_cast<T>(eps);
  return p <= FIXED_P ? by_d<Pullback, true>(d, kb, xx, yy, th, cf, dc, part, tk, o, n, m, d, p,
                                             same, e, items, blocks, s)
                      : by_d<Pullback, false>(d, kb, xx, yy, th, cf, dc, part, tk, o, n, m, d,
                                              p, same, e, items, blocks, s);
}

}  // namespace

extern "C" {

// the kernels' geometry (ops/gram.py checks it against its own once):
// threads a block, the tile edge, the largest d with its own instance,
// the largest d, the largest p of the fixed-degree Horner, the blocks an
// SM the d <= EXACT_MAX_D instances are built for
int gpmp_matern_geometry(int what) {
  switch (what) {
    case 0: return THREADS;
    case 1: return TILE;
    case 2: return EXACT_MAX_D;
    case 3: return MAX_D;
    case 4: return FIXED_P;
    case 5: return BLOCKS_PER_SM;
    default: return -1;
  }
}

// K1p's and K2p's geometry (ops/gram.py checks it once): threads a block,
// K1p's entries and members a block, K2p's entries a warp, the largest d
// of their unrolled instance
int gpmp_matern_population_geometry(int what) {
  switch (what) {
    case 0: return POP_THREADS;
    case 1: return POP_CHUNK;
    case 2: return POP_MAX_MEMBERS;
    case 3: return POP_WARP_ENTRIES;
    case 4: return POP_EXACT_D;
    default: return -1;
  }
}

// K (n, m) of x (n, d), y (m, d), theta (1 + d): one launch of ``blocks``
// blocks over the ``items`` tiles of ops/gram.py gram_plan; hcoef the host
// coefficients [c, a_0..a_p, b_0..b_p], coef the same on the device (read
// for p > 3 only)
int gpmp_matern_gram_f64(const void* x, const void* y, const void* theta, const void* hcoef,
                         const void* coef, void* out, long long n, long long m, int d, int p,
                         int same, double eps, long long tile, long long items, long long blocks,
                         void* stream) {
  return launch_gram<double>(x, y, theta, hcoef, coef, out, n, m, d, p, same, eps, tile, items,
                             blocks, stream);
}

int gpmp_matern_gram_f32(const void* x, const void* y, const void* theta, const void* hcoef,
                         const void* coef, void* out, long long n, long long m, int d, int p,
                         int same, double eps, long long tile, long long items, long long blocks,
                         void* stream) {
  return launch_gram<float>(x, y, theta, hcoef, coef, out, n, m, d, p, same, eps, tile, items,
                            blocks, stream);
}

// g (1 + d) f64 = grad_theta <Kbar, K(theta)>: one launch on the forward's
// plan, partial (blocks x (1 + MAX_D) f64) and ticket (zero between
// launches) its workspace
int gpmp_matern_pullback_f64(const void* kbar, const void* x, const void* y, const void* theta,
                             const void* hcoef, const void* coef, void* partial, void* ticket,
                             void* out, long long n, long long m, int d, int p, int same,
                             double eps, long long tile, long long items, long long blocks,
                             void* stream) {
  return launch_pullback<double>(kbar, x, y, theta, hcoef, coef, partial, ticket, out, n, m, d,
                                 p, same, eps, tile, items, blocks, stream);
}

int gpmp_matern_pullback_f32(const void* kbar, const void* x, const void* y, const void* theta,
                             const void* hcoef, const void* coef, void* partial, void* ticket,
                             void* out, long long n, long long m, int d, int p, int same,
                             double eps, long long tile, long long items, long long blocks,
                             void* stream) {
  return launch_pullback<float>(kbar, x, y, theta, hcoef, coef, partial, ticket, out, n, m, d, p,
                                same, eps, tile, items, blocks, stream);
}

// K1p: out (B, n, m) = K(x, y; theta_b) for theta (B, 1 + d), one launch of
// ``blocks`` blocks on ops/gram.py population_plan (mb members a block,
// chunks blocks a member group); coefficients as K1's
int gpmp_matern_gram_population_f64(const void* x, const void* y, const void* theta,
                                    const void* hcoef, const void* coef, void* out,
                                    long long members, long long n, long long m, int d, int p,
                                    int same, double eps, long long mb, long long chunks,
                                    long long blocks, void* stream) {
  return launch_population_gram<double>(x, y, theta, hcoef, coef, out, members, n, m, d, p, same,
                                        eps, mb, chunks, blocks, stream);
}

int gpmp_matern_gram_population_f32(const void* x, const void* y, const void* theta,
                                    const void* hcoef, const void* coef, void* out,
                                    long long members, long long n, long long m, int d, int p,
                                    int same, double eps, long long mb, long long chunks,
                                    long long blocks, void* stream) {
  return launch_population_gram<float>(x, y, theta, hcoef, coef, out, members, n, m, d, p, same,
                                       eps, mb, chunks, blocks, stream);
}

// K2p: out (B, 1 + d) f64 = grad_theta_b <Kbar_b, K(theta_b)> for Kbar (B, n,
// m); partial (B x chunks x (1 + d) f64) and ticket (B, zero between
// launches) its workspace
int gpmp_matern_pullback_population_f64(const void* kbar, const void* x, const void* y,
                                        const void* theta, const void* hcoef, const void* coef,
                                        void* partial, void* ticket, void* out, long long members,
                                        long long n, long long m, int d, int p, int same,
                                        double eps, long long chunks, long long blocks,
                                        void* stream) {
  return launch_population_pullback<double>(kbar, x, y, theta, hcoef, coef, partial, ticket, out,
                                            members, n, m, d, p, same, eps, chunks, blocks,
                                            stream);
}

int gpmp_matern_pullback_population_f32(const void* kbar, const void* x, const void* y,
                                        const void* theta, const void* hcoef, const void* coef,
                                        void* partial, void* ticket, void* out, long long members,
                                        long long n, long long m, int d, int p, int same,
                                        double eps, long long chunks, long long blocks,
                                        void* stream) {
  return launch_population_pullback<float>(kbar, x, y, theta, hcoef, coef, partial, ticket, out,
                                           members, n, m, d, p, same, eps, chunks, blocks, stream);
}

int gpmp_maternp_f64(const void* h, const void* coef, void* out, long long count, int p,
                     void* stream) {
  return launch_maternp<double>(h, nullptr, coef, out, count, p, stream);
}

int gpmp_maternp_f32(const void* h, const void* coef, void* out, long long count, int p,
                     void* stream) {
  return launch_maternp<float>(h, nullptr, coef, out, count, p, stream);
}

int gpmp_maternp_backward_f64(const void* h, const void* kbar, const void* coef, void* out,
                              long long count, int p, void* stream) {
  return launch_maternp<double>(h, kbar, coef, out, count, p, stream);
}

int gpmp_maternp_backward_f32(const void* h, const void* kbar, const void* coef, void* out,
                              long long count, int p, void* stream) {
  return launch_maternp<float>(h, kbar, coef, out, count, p, stream);
}

}  // extern "C"
