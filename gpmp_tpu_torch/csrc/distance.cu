// gpmp_tpu_torch/csrc/distance.cu
//
// K1d: the anisotropic scaled distance and its log-inverse-range pullback
// for Hopper, sm_90a, in float and double.  Plain C entry points, loaded
// with ctypes by gpmp_tpu_torch/ops/_build.py and wrapped in
// gpmp_tpu_torch/ops/distance.py.
//
// What it replaces (JAX package, fused there by XLA):
//   gpmp_tpu/num/__init__.py  _safe_sqrt, _cdist_diff, cdist,
//   scaled_distance, scaled_distance_elementwise, and their autodiff
//   pullback for loginvrho:
//     D_ij = || e^l * x_i - e^l * y_j ||                  (full, n x m)
//     D_i  = || e^l * (x_i - y_i) ||                      (elementwise, n)
//     g_k  = sum_ij Dbar_ij (e^l_k x_ik - e^l_k y_jk)^2 / D_ij,
//   with the term 0 where D_ij = 0 (the zero subgradient of _safe_sqrt).
//   User covariances (bench.py's noisy model, example 11) compose these with
//   the Matern polynomial (K1m, matern_gram.cu), so the gram of such a
//   model runs as K1d then K1m.
//
// What bounds them on the H100: the forward writes 8 bytes (f64) an entry
// for ~2d f64 instructions and a square root; the pullback reads 8 bytes of
// Dbar an entry for ~4d (the differences, their squares, D^2, the d
// weighted squares) and a reciprocal square root.  At n = m = 1000, d = 6
// that is 8 MB (2.4 us at 3.35 TB/s) against ~2 us of the f64 pipes for the
// pullback (37.5 f64 instructions an entry in the built loop); at
// n = 16384, d = 3, 2.1 GB (0.64 ms) against ~0.35 ms (22.5 an entry).
// Both are bound by memory traffic at large n; at n = 1000 the launch, the
// loads' latency and the instruction issue (60-80 instructions an entry a
// lane, the f64 ones among them) weigh as much as the stream.
//
// What the design does about it (the two full kernels share one geometry,
// ops/distance.py distance_plan):
// - a persistent grid of a few blocks an SM, 8 warps a block, walks items:
//   an item is a strip of 32 C columns (C = 16 / sizeof(T): 64 f64 columns,
//   128 f32) times a chunk of rows; block b takes the items b, b + blocks,
//   ... in order;
// - lane l of each warp owns the C consecutive columns [C l, C l + C) of the
//   strip and keeps their scaled y (e^l y_j) in registers, computed once an
//   item; warp w walks the rows r0 + w, r0 + w + 8, ... of the item in steps
//   of ROW_UNROLL rows (the pullback for d > 4: half, for registers), all
//   the step's loads issued before any is used: lane k reads coordinate k
//   of each of the step's rows (one coalesced read a row, one register a
//   row in flight), scales it, and each row's scaled x reaches every lane by
//   shuffles; the block's first step (its x, y and Dbar) is read before the
//   block waits for e^l;
// - e^l is computed once per block into shared memory, and x and y are
//   scaled by the same products, each rounded on its own (as the plain
//   version's e^l * x): for x is y, D is exactly symmetric and coincident
//   points give exact zeros, as the plain cdist does;
// - the forward writes a lane's C entries of a row in one 16-byte store,
//   with default caching (K1m reads D next; at n = 1000 it stays in L2); its
//   per-entry arithmetic is the plain version's, as the earlier kernel's;
// - the pullback reads Dbar in 16-byte streaming loads and keeps each
//   entry's squared differences in registers for both their uses; its
//   weight Dbar / D is one reciprocal square root in f64 (weight() below);
// - each thread sums its terms in f64 in a fixed order (its items, their
//   rows, each row's C columns; rows past the item and columns past m add
//   0), then csrc/fixed_sum.cuh's grid_sum: the block's sums (a butterfly
//   over the lanes, the warps in order), and the last block to take the
//   ticket sums the partials in block order, writes the d results and
//   resets the ticket.  One launch, no atomics on values: bitwise
//   reproducible for a shape on a card.  The partials and the ticket are a
//   workspace the wrapper caches per (device, n, m, d, dtype);
// - d <= EXACT_MAX_D takes an instance for its d (the loops over k unrolled
//   with no guard), d <= MAX_D one instance reading d at run time (one
//   d <= 8 instance reading d at run time took 1.4-1.8x the time at d = 3
//   and 6 on the H100: its guards branch, and at d <= 4 its pullback takes
//   4 rows a step, not 8; PERF.md); rows that are not 16-byte aligned (m
//   not a multiple of C, or Dbar's base) take the instance with scalar
//   accesses, which rounds and sums alike.
// The elementwise forms keep their geometry (a grid-stride loop, a thread a
// row); the elementwise pullback takes the same finish.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_sum.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_UNROLL = 8;     // rows a warp takes in one step (the pullback
                                  // for d > 4: half, for registers)
constexpr int EXACT_MAX_D = 8;    // an instance for each d up to this one
constexpr int MAX_D = 32;
constexpr int EW_THREADS = 256;   // elementwise variants
constexpr long long EW_MAX_BLOCKS = 264;  // the elementwise forward's grid: 2 an SM of the H100

// mul: a product rounded on its own, never contracted into a later
// subtraction (e^l x_i - e^l y_j as one FMA would leave x_i = y_j nonzero
// and D(x, x) asymmetric)
template <typename T> struct M;
template <> struct M<double> {
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double sqrt(double v) { return ::sqrt(v); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};
template <> struct M<float> {
  static __device__ __forceinline__ float exp(float v) { return ::expf(v); }
  static __device__ __forceinline__ float sqrt(float v) { return ::sqrtf(v); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

// the pullback's weight Dbar / D where D^2 > 0, else 0 (the zero
// subgradient).  f64: Dbar * rsqrt(D^2), one reciprocal square root in place
// of a square root and a division, each an iterated sequence on sm_90
// (CUDA's rsqrt is within 1 ulp: each term within a few ulps of the plain
// Dbar / sqrt(D^2)).  f32: the plain version's sqrt and division, correctly
// rounded (rsqrtf's approximation drifts by ~1e-9 a term, systematically,
// which the cancellation in a d = 1 sum of 1.7e7 terms magnified to 8.5e-6
// against the 1e-5 gate)
__device__ __forceinline__ double weight(double dbar, double d2) {
  return d2 > 0.0 ? dbar * ::rsqrt(d2) : 0.0;
}
__device__ __forceinline__ float weight(float dbar, float d2) {
  const float h = ::sqrtf(d2);
  return h > 0.f ? dbar / h : 0.f;
}

// acc += w sq in f64: one fused multiply-add (f64), the f32 product widened
// (f32, as the plain version); written out, so that every instance rounds
// alike
__device__ __forceinline__ void add_term(double& acc, double w, double sq) {
  acc = ::fma(w, sq, acc);
}
__device__ __forceinline__ void add_term(double& acc, float w, float sq) {
  acc += static_cast<double>(__fmul_rn(w, sq));
}

// a lane's C entries in one 16-byte store, default (write-back) caching
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  __stwb(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stwb(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void load16_cs(const double* p, double (&v)[2]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load16_cs(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// e^{l_k}, k < dd, computed once per block by threads 0 .. dd - 1 into
// shared memory
template <typename T>
__device__ __forceinline__ void scales(T* el_s, const T* __restrict__ l, int dd) {
  if (threadIdx.x < dd) el_s[threadIdx.x] = M<T>::exp(l[threadIdx.x]);
  __syncthreads();
}

// y of the lane's C columns j0 .. j0 + C - 1 (0 past m), as read
template <typename T, int D, int C>
__device__ __forceinline__ void load_cols(T (&yr)[C][D], const T* __restrict__ y, long long j0,
                                          long long m, int dd) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < D; ++k)
      yr[c][k] = k < dd && j0 + c < m ? __ldg(y + (j0 + c) * dd + k) : T(0);
}

// the step's rows i + u WARPS (u < U, those of the warp's rows
// left): lane k < dd reads their coordinate k (one coalesced read a row),
// 0 past the rows
template <typename T, int U>
__device__ __forceinline__ void load_step_x(T (&xr)[U], const T* __restrict__ x, long long i,
                                            long long left, int dd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u)
    xr[u] = u < left && lane < dd ? __ldg(x + (i + u * WARPS) * dd + lane) : T(0);
}

// the scaled x of a row, lane k's coordinate broadcast to every lane
template <typename T, int D>
__device__ __forceinline__ void row_of(T (&xs)[D], T xv, int dd) {
#pragma unroll
  for (int k = 0; k < D; ++k) xs[k] = k < dd ? __shfl_sync(0xffffffffu, xv, k) : T(0);
}

// the item's y scaled: ys = e^l y (rounded products)
template <typename T, int D, int C>
__device__ __forceinline__ void scale_cols(T (&ys)[C][D], const T (&yr)[C][D],
                                           const T* el_s, int dd) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < D; ++k) ys[c][k] = k < dd ? M<T>::mul(el_s[k], yr[c][k]) : T(0);
}

// Item t of the plan: this warp's first row i0 and its number of rows
// (i0, i0 + WARPS, ...), and this lane's first column j0.
struct Item {
  long long i0, rows, j0;
};

__device__ __forceinline__ Item item_of(long long t, long long strips, long long chunk_rows,
                                        long long n, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = t / strips * chunk_rows;
  const long long r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
  const long long i0 = r0 + warp;
  return {i0, i0 < r1 ? (r1 - i0 + WARPS - 1) / WARPS : 0,
          (t % strips) * (32 * cols) + lane * cols};
}

// a row of a lane's forward: its C distances, written at out_row + j0
template <typename T, int D, int C, bool VEC>
__device__ __forceinline__ void distance_row(const T (&xs)[D], const T (&ys)[C][D],
                                             T* __restrict__ p, long long j0, long long m,
                                             int dd) {
  T v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T d2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < dd) {
        const T diff = xs[k] - ys[c][k];
        d2 += diff * diff;
      }
    }
    v[c] = M<T>::sqrt(d2);
  }
  if constexpr (VEC) {
    store16(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (j0 + c < m) p[c] = v[c];
  }
}

// D = EXACT ? the dimension : MAX_D (d at run time); VEC: 16-byte stores.
// A warp's rows of an item go ROW_UNROLL at a step, all the step's x read
// before any is used (the first step's, and the first item's y, before the
// block waits for e^l); every lane computes (lanes past m hold y = 0), only
// the stores are guarded.
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS, D <= EXACT_MAX_D ? 2 : 1)
distance_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ l,
                T* __restrict__ out, long long n, long long m, int d, long long strips,
                long long chunk_rows) {
  constexpr int C = 16 / sizeof(T), U = ROW_UNROLL;
  __shared__ T el_s[D];
  const int dd = D <= EXACT_MAX_D ? D : d;
  const int lane = threadIdx.x & 31;
  const long long items = strips * ((n + chunk_rows - 1) / chunk_rows);
  long long t = blockIdx.x;
  Item it = item_of(t, strips, chunk_rows, n, C);
  T yr[C][D], xr[U];
  load_cols<T, D, C>(yr, y, it.j0, m, dd);
  load_step_x<T, U>(xr, x, it.i0, it.rows, dd);
  scales<T>(el_s, l, dd);
  const T el_lane = lane < dd ? el_s[lane] : T(0);
#pragma unroll 1
  for (; t < items; t += gridDim.x) {
    if (t != blockIdx.x) {
      it = item_of(t, strips, chunk_rows, n, C);
      load_cols<T, D, C>(yr, y, it.j0, m, dd);
      load_step_x<T, U>(xr, x, it.i0, it.rows, dd);
    }
    T ys[C][D];
    scale_cols<T, D, C>(ys, yr, el_s, dd);
#pragma unroll 1
    for (long long r = 0, i = it.i0; r < it.rows; r += U, i += WARPS * U) {
      if (r > 0) load_step_x<T, U>(xr, x, i, it.rows - r, dd);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T xs[D];
        row_of<T, D>(xs, M<T>::mul(el_lane, xr[u]), dd);
        if (r + u < it.rows && it.j0 < m)
          distance_row<T, D, C, VEC>(xs, ys, out + (i + u * WARPS) * m + it.j0, it.j0, m, dd);
      }
    }
  }
}

// a row of a lane's pullback: its C terms Dbar_ij (diff_k)^2 / D_ij added to
// acc in column order, each entry's squared differences kept for both their
// uses (D^2, summed in order over k, and the terms)
template <typename T, int D, int C>
__device__ __forceinline__ void pullback_row(double (&acc)[D], const T (&xs)[D],
                                             const T (&ys)[C][D], const T (&db)[C], int dd) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T sq[D];
    T d2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < dd) {
        const T diff = xs[k] - ys[c][k];
        sq[k] = M<T>::mul(diff, diff);
        d2 += sq[k];
      }
    }
    const T w = weight(db[c], d2);
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (k < dd) add_term(acc[k], w, sq[k]);
  }
}

// a row's C entries of Dbar at p (VEC: one 16-byte streaming load; else
// scalar ones, 0 past m)
template <typename T, int C, bool VEC>
__device__ __forceinline__ void load_dbar(T (&db)[C], const T* __restrict__ p, long long j0,
                                          long long m) {
  if constexpr (VEC) {
    load16_cs(p, db);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) db[c] = j0 + c < m ? __ldcs(p + c) : T(0);
  }
}

// the step's rows of Dbar (0 past the warp's rows): all in flight before
// any is used
template <typename T, int C, int U, bool VEC>
__device__ __forceinline__ void load_step_dbar(T (&db)[U][C], const T* __restrict__ dbar,
                                               long long i, long long left, long long j0,
                                               long long m) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < left && j0 < m) {
      load_dbar<T, C, VEC>(db[u], dbar + (i + u * WARPS) * m + j0, j0, m);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) db[u][c] = T(0);
    }
  }
}

// VEC: Dbar in 16-byte loads (m a multiple of C and Dbar's base 16-byte
// aligned); else scalar loads, the same order of sums.  The rows go as the
// forward's, the step's Dbar read with its x; rows past the warp's and
// columns past m read as 0 and add 0.
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS, D <= EXACT_MAX_D ? 2 : 1)
distance_pullback_kernel(const T* __restrict__ dbar, const T* __restrict__ x,
                         const T* __restrict__ y, const T* __restrict__ l,
                         double* __restrict__ partial, unsigned int* __restrict__ ticket,
                         double* __restrict__ out, long long n, long long m, int d,
                         long long strips, long long chunk_rows) {
  constexpr int C = 16 / sizeof(T), U = D <= 4 ? ROW_UNROLL : ROW_UNROLL / 2;
  __shared__ T el_s[D];
  __shared__ fixed_sum::Smem<D, THREADS> sm;
  const int dd = D <= EXACT_MAX_D ? D : d;
  const int lane = threadIdx.x & 31;
  const long long items = strips * ((n + chunk_rows - 1) / chunk_rows);
  long long t = blockIdx.x;
  Item it = item_of(t, strips, chunk_rows, n, C);
  T yr[C][D], xr[U], db[U][C];
  load_cols<T, D, C>(yr, y, it.j0, m, dd);
  load_step_x<T, U>(xr, x, it.i0, it.rows, dd);
  load_step_dbar<T, C, U, VEC>(db, dbar, it.i0, it.rows, it.j0, m);
  scales<T>(el_s, l, dd);
  const T el_lane = lane < dd ? el_s[lane] : T(0);
  double acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.0;
#pragma unroll 1
  for (; t < items; t += gridDim.x) {
    if (t != blockIdx.x) {
      it = item_of(t, strips, chunk_rows, n, C);
      load_cols<T, D, C>(yr, y, it.j0, m, dd);
      load_step_x<T, U>(xr, x, it.i0, it.rows, dd);
      load_step_dbar<T, C, U, VEC>(db, dbar, it.i0, it.rows, it.j0, m);
    }
    T ys[C][D];
    scale_cols<T, D, C>(ys, yr, el_s, dd);
#pragma unroll 1
    for (long long r = 0, i = it.i0; r < it.rows; r += U, i += WARPS * U) {
      if (r > 0) {
        load_step_x<T, U>(xr, x, i, it.rows - r, dd);
        load_step_dbar<T, C, U, VEC>(db, dbar, i, it.rows - r, it.j0, m);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T xs[D];
        row_of<T, D>(xs, M<T>::mul(el_lane, xr[u]), dd);
        pullback_row<T, D, C>(acc, xs, ys, db[u], dd);
      }
    }
  }
  if (fixed_sum::grid_sum(sm, acc, partial, ticket)) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (k < dd) out[k] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
distance_elementwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const T* __restrict__ l, T* __restrict__ out, long long n, int d) {
  __shared__ T el[MAX_D];
  if (threadIdx.x < d) el[threadIdx.x] = M<T>::exp(l[threadIdx.x]);
  __syncthreads();
  for (long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * EW_THREADS) {
    T d2 = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = el[k] * (x[i * d + k] - y[i * d + k]);
      d2 += diff * diff;
    }
    out[i] = M<T>::sqrt(d2);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(EW_THREADS)
distance_elementwise_pullback_kernel(const T* __restrict__ dbar, const T* __restrict__ x,
                                     const T* __restrict__ y, const T* __restrict__ l,
                                     double* __restrict__ partial,
                                     unsigned int* __restrict__ ticket, double* __restrict__ out,
                                     long long n, int d) {
  __shared__ fixed_sum::Smem<DMAX, EW_THREADS> sm;
  __shared__ T el[DMAX];
  if (threadIdx.x < d) el[threadIdx.x] = M<T>::exp(l[threadIdx.x]);
  __syncthreads();
  double acc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = 0.0;
  for (long long i = static_cast<long long>(blockIdx.x) * EW_THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * EW_THREADS) {
    T d2 = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = el[k] * (x[i * d + k] - y[i * d + k]);
      d2 += diff * diff;
    }
    const T h = M<T>::sqrt(d2);
    if (h > T(0)) {
      const T w = dbar[i] / h;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          const T diff = el[k] * (x[i * d + k] - y[i * d + k]);
          acc[k] += static_cast<double>(w * (diff * diff));
        }
      }
    }
  }
  if (fixed_sum::grid_sum(sm, acc, partial, ticket)) {
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) out[k] = acc[k];
  }
}

long long ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS;
}

// the plan of ops/distance.py distance_plan: strips of 32 C columns cover
// the m columns exactly, chunks of chunk_rows rows the n rows
bool bad_plan(long long n, long long m, int d, int cols, long long strips, long long chunk_rows,
              long long blocks) {
  const long long strip = 32LL * cols;
  return n <= 0 || m <= 0 || d < 1 || d > MAX_D || strips <= 0 || (strips - 1) * strip >= m ||
         strips * strip < m || chunk_rows <= 0 || blocks <= 0 || blocks > 0x7fffffffLL;
}

// F::run<D>(args...) with D = d where d <= EXACT_MAX_D, else MAX_D
static_assert(EXACT_MAX_D == 8, "one case a d below");
template <typename F, typename... A>
int by_d(int d, A... a) {
  switch (d) {
    case 1: return F::template run<1>(a...);
    case 2: return F::template run<2>(a...);
    case 3: return F::template run<3>(a...);
    case 4: return F::template run<4>(a...);
    case 5: return F::template run<5>(a...);
    case 6: return F::template run<6>(a...);
    case 7: return F::template run<7>(a...);
    case 8: return F::template run<8>(a...);
    default: return F::template run<MAX_D>(a...);
  }
}

struct Forward {
  template <int D, typename T>
  static int run(const T* x, const T* y, const T* l, T* out, long long n, long long m, int d,
                 long long strips, long long chunk_rows, long long blocks, cudaStream_t s) {
    constexpr int C = 16 / sizeof(T);
    const unsigned nb = static_cast<unsigned>(blocks);
    if (m % C == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
      distance_kernel<T, D, true><<<nb, THREADS, 0, s>>>(x, y, l, out, n, m, d, strips,
                                                          chunk_rows);
    else
      distance_kernel<T, D, false><<<nb, THREADS, 0, s>>>(x, y, l, out, n, m, d, strips,
                                                           chunk_rows);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Pullback {
  template <int D, typename T>
  static int run(const T* dbar, const T* x, const T* y, const T* l, double* partial,
                 unsigned int* ticket, double* out, long long n, long long m, int d,
                 long long strips, long long chunk_rows, long long blocks, cudaStream_t s) {
    constexpr int C = 16 / sizeof(T);
    const unsigned nb = static_cast<unsigned>(blocks);
    if (m % C == 0 && reinterpret_cast<uintptr_t>(dbar) % 16 == 0)
      distance_pullback_kernel<T, D, true><<<nb, THREADS, 0, s>>>(
          dbar, x, y, l, partial, ticket, out, n, m, d, strips, chunk_rows);
    else
      distance_pullback_kernel<T, D, false><<<nb, THREADS, 0, s>>>(
          dbar, x, y, l, partial, ticket, out, n, m, d, strips, chunk_rows);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch_distance(const void* x, const void* y, const void* l, void* out, long long n,
                    long long m, int d, long long strips, long long chunk_rows, long long blocks,
                    void* stream) {
  if (bad_plan(n, m, d, 16 / sizeof(T), strips, chunk_rows, blocks) || !x || !y || !l || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_d<Forward>(d, static_cast<const T*>(x), static_cast<const T*>(y),
                       static_cast<const T*>(l), static_cast<T*>(out), n, m, d, strips,
                       chunk_rows, blocks, static_cast<cudaStream_t>(stream));
}

template <typename T>
int launch_pullback(const void* dbar, const void* x, const void* y, const void* l,
                    void* partial, void* ticket, void* out, long long n, long long m, int d,
                    long long strips, long long chunk_rows, long long blocks, void* stream) {
  if (bad_plan(n, m, d, 16 / sizeof(T), strips, chunk_rows, blocks) || !dbar || !x || !y ||
      !l || !partial || !ticket || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_d<Pullback>(d, static_cast<const T*>(dbar), static_cast<const T*>(x),
                        static_cast<const T*>(y), static_cast<const T*>(l),
                        static_cast<double*>(partial), static_cast<unsigned int*>(ticket),
                        static_cast<double*>(out), n, m, d, strips, chunk_rows, blocks,
                        static_cast<cudaStream_t>(stream));
}

template <typename T>
int launch_elementwise(const void* x, const void* y, const void* l, void* out, long long n,
                       int d, void* stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  distance_elementwise_kernel<T><<<static_cast<unsigned>(ew_blocks(n)), EW_THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(l),
      static_cast<T*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_elementwise_pullback(const void* dbar, const void* x, const void* y, const void* l,
                                void* partial, void* ticket, void* out, long long n, int d,
                                long long blocks, void* stream) {
  if (n <= 0 || d < 1 || d > MAX_D || blocks <= 0 || blocks > 0x7fffffffLL || !dbar ||
      !partial || !ticket || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const T *db = static_cast<const T*>(dbar), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y), *ll = static_cast<const T*>(l);
  double* part = static_cast<double*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  double* o = static_cast<double*>(out);
  if (d <= 8)
    distance_elementwise_pullback_kernel<T, 8><<<nb, EW_THREADS, 0, s>>>(db, xx, yy, ll, part,
                                                                          tk, o, n, d);
  else
    distance_elementwise_pullback_kernel<T, MAX_D><<<nb, EW_THREADS, 0, s>>>(db, xx, yy, ll,
                                                                              part, tk, o, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the kernels' geometry (ops/distance.py checks it against its own once):
// threads a block, rows a warp takes a step, the largest d with its own
// instance, the largest d, the elementwise pullback's threads a block
int gpmp_distance_geometry(int what) {
  switch (what) {
    case 0: return THREADS;
    case 1: return ROW_UNROLL;
    case 2: return EXACT_MAX_D;
    case 3: return MAX_D;
    case 4: return EW_THREADS;
    default: return -1;
  }
}

// D (n, m) of x (n, d), y (m, d): one launch of ``blocks`` blocks over
// ``strips`` column strips times row chunks of ``chunk_rows`` rows
// (ops/distance.py distance_plan)
int gpmp_distance_f64(const void* x, const void* y, const void* l, void* out, long long n,
                      long long m, int d, long long strips, long long chunk_rows, long long blocks,
                      void* stream) {
  return launch_distance<double>(x, y, l, out, n, m, d, strips, chunk_rows, blocks, stream);
}

int gpmp_distance_f32(const void* x, const void* y, const void* l, void* out, long long n,
                      long long m, int d, long long strips, long long chunk_rows, long long blocks,
                      void* stream) {
  return launch_distance<float>(x, y, l, out, n, m, d, strips, chunk_rows, blocks, stream);
}

// g (d,) f64 = grad_l <Dbar, D(l)>: one launch on the forward's plan,
// partial (blocks x MAX_D f64) and ticket (zero between launches) its
// workspace
int gpmp_distance_pullback_f64(const void* dbar, const void* x, const void* y, const void* l,
                               void* partial, void* ticket, void* out, long long n, long long m,
                               int d, long long strips, long long chunk_rows, long long blocks,
                               void* stream) {
  return launch_pullback<double>(dbar, x, y, l, partial, ticket, out, n, m, d, strips,
                                 chunk_rows, blocks, stream);
}

int gpmp_distance_pullback_f32(const void* dbar, const void* x, const void* y, const void* l,
                               void* partial, void* ticket, void* out, long long n, long long m,
                               int d, long long strips, long long chunk_rows, long long blocks,
                               void* stream) {
  return launch_pullback<float>(dbar, x, y, l, partial, ticket, out, n, m, d, strips,
                                chunk_rows, blocks, stream);
}

int gpmp_distance_elementwise_f64(const void* x, const void* y, const void* l, void* out,
                                  long long n, int d, void* stream) {
  return launch_elementwise<double>(x, y, l, out, n, d, stream);
}

int gpmp_distance_elementwise_f32(const void* x, const void* y, const void* l, void* out,
                                  long long n, int d, void* stream) {
  return launch_elementwise<float>(x, y, l, out, n, d, stream);
}

// the elementwise pullback: one launch of ``blocks`` blocks
// (ops/distance.py elementwise_plan), its workspace as the full one's
int gpmp_distance_elementwise_pullback_f64(const void* dbar, const void* x, const void* y,
                                           const void* l, void* partial, void* ticket, void* out,
                                           long long n, int d, long long blocks, void* stream) {
  return launch_elementwise_pullback<double>(dbar, x, y, l, partial, ticket, out, n, d, blocks,
                                             stream);
}

int gpmp_distance_elementwise_pullback_f32(const void* dbar, const void* x, const void* y,
                                           const void* l, void* partial, void* ticket, void* out,
                                           long long n, int d, long long blocks, void* stream) {
  return launch_elementwise_pullback<float>(dbar, x, y, l, partial, ticket, out, n, d, blocks,
                                            stream);
}

}  // extern "C"
