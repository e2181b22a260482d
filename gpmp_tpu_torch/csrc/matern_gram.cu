// gpmp_tpu_torch/csrc/matern_gram.cu
//
// K1 (Matern gram forward), K2 (its parameter pullback) and K1m (the
// Matern polynomial, elementwise) for Hopper, sm_90a, in float and double.
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
//   on consecutive entries; the Horner coefficients come from the same
//   host-computed coef array as K1/K2.
//
// What bounds K1/K2 on the H100: at the main path's n = 1000, d = 6 each
// output costs ~2d flops for the distance plus an exp, a sqrt and two
// Horner recurrences, all in f64, against 8 bytes written (K1) or read
// (K2) per element.  That is ~10-20x more f64 operations per byte than
// the card's f64-ALU/bandwidth balance, so both kernels are bound by f64
// ALU throughput and, at n = 1000 (one 8 MB matrix, a few microseconds of
// work), by launch latency; not by memory bandwidth.
//
// What the design does about it: each block owns a 32 x 32 output tile and
// stages its 32 x-rows and 32 y-rows, already scaled by e^l, in shared
// memory (transposed so a warp reads consecutive words), so the d-loop
// reads no device memory and x, y are read once per tile.  K2 recomputes
// h, k_p and k_p' from x and y instead of reading a stored distance
// matrix, accumulates in f64 in registers (one accumulator per parameter,
// d <= DMAX templated so they stay in registers), reduces each block with
// warp shuffles, writes a (nblocks, 1 + d) partial buffer, and a second
// launch reduces that buffer in a fixed order.  No atomics: the gradient
// is bitwise reproducible from run to run.  Tensor cores, TMA and wgmma
// are not used: there is no matrix product in these kernels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;                    // output tile edge
constexpr int THREADS_X = 32;               // one warp along the columns
constexpr int THREADS_Y = 8;                // 8 warps along the rows
constexpr int NTHREADS = THREADS_X * THREADS_Y;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS_PER_THREAD = TILE / THREADS_Y;
constexpr int MAX_D = 32;                   // largest input dimension d
constexpr int PULLBACK_COL_GROUPS = 32;     // K2 column-tile groups per row tile
constexpr int REDUCE_THREADS = 256;
constexpr int EW_THREADS = 256;            // K1m
constexpr long long EW_MAX_BLOCKS = 2112;  // 16 per SM of the H100

template <typename T> struct M;
template <> struct M<double> {
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double sqrt(double v) { return ::sqrt(v); }
};
template <> struct M<float> {
  static __device__ __forceinline__ float exp(float v) { return ::expf(v); }
  static __device__ __forceinline__ float sqrt(float v) { return ::sqrtf(v); }
};

// coef layout (double, host-computed): [c, a_0..a_p, b_0..b_p]
//   k_p(h)  = e^{-ch} sum_k a_k t^k,      t = 2ch
//   k_p'(h) = c e^{-ch} sum_k b_k t^k,    b_k = 2(k+1) a_{k+1} - a_k
template <typename T>
__device__ __forceinline__ T horner(const double* __restrict__ a, int p, T t) {
  T acc = static_cast<T>(a[p]);
  for (int k = p - 1; k >= 0; --k) acc = acc * t + static_cast<T>(a[k]);
  return acc;
}

// Stage rows [r0, r0 + TILE) of src (rows x d, row-major), scaled by
// e^{theta[1 + k]}, into dst[k][r] (transposed); rows past the end are 0.
template <typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[TILE], const T* __restrict__ src,
                                           const T* __restrict__ theta, long long r0,
                                           long long rows, int d, int tid) {
  for (int e = tid; e < TILE * d; e += NTHREADS) {
    const int r = e / d, k = e - r * d;
    const long long g = r0 + r;
    dst[k][r] = g < rows ? M<T>::exp(theta[1 + k]) * src[g * d + k] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
matern_gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ theta, const double* __restrict__ coef,
                   T* __restrict__ out, long long n, long long m, int d, int p,
                   int same, T eps) {
  __shared__ T sx[MAX_D][TILE];
  __shared__ T sy[MAX_D][TILE];
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * TILE;
  const long long j0 = static_cast<long long>(blockIdx.x) * TILE;
  stage_rows<T>(sx, x, theta, i0, n, d, tid);
  stage_rows<T>(sy, y, theta, j0, m, d, tid);
  __syncthreads();

  const T sigma2 = M<T>::exp(theta[0]);
  const T nugget = T(10) * sigma2 * eps;
  const T c = static_cast<T>(coef[0]);
  const T twoc = static_cast<T>(2.0 * coef[0]);
  const double* a = coef + 1;
  const int tx = threadIdx.x;
  const long long gj = j0 + tx;
  if (gj >= m) return;
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_THREAD; ++rr) {
    const int r = threadIdx.y + rr * THREADS_Y;
    const long long gi = i0 + r;
    if (gi >= n) break;
    T d2 = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = sx[k][r] - sy[k][tx];
      d2 += diff * diff;
    }
    const T h = M<T>::sqrt(d2);
    T kv = M<T>::exp(-c * h) * horner<T>(a, p, twoc * h);
    if (isinf(h)) kv = T(0);
    T v = sigma2 * kv;
    if (same && gi == gj) v += nugget;
    out[gi * m + gj] = v;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
matern_pullback_kernel(const T* __restrict__ kbar, const T* __restrict__ x,
                       const T* __restrict__ y, const T* __restrict__ theta,
                       const double* __restrict__ coef, double* __restrict__ partial,
                       long long n, long long m, int d, int p, int same, T eps) {
  __shared__ T sx[DMAX][TILE];
  __shared__ T sy[DMAX][TILE];
  __shared__ double red[NWARPS][DMAX + 1];
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const int tx = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * TILE;

  const T sigma2 = M<T>::exp(theta[0]);
  const T nugget = T(10) * sigma2 * eps;
  const T c = static_cast<T>(coef[0]);
  const T twoc = static_cast<T>(2.0 * coef[0]);
  const double* a = coef + 1;
  const double* b = coef + 2 + p;

  double acc[DMAX + 1];
#pragma unroll
  for (int k = 0; k <= DMAX; ++k) acc[k] = 0.0;

  stage_rows<T>(sx, x, theta, i0, n, d, tid);
  for (long long j0 = static_cast<long long>(blockIdx.x) * TILE; j0 < m;
       j0 += static_cast<long long>(gridDim.x) * TILE) {
    __syncthreads();  // previous tile's reads of sy are done
    stage_rows<T>(sy, y, theta, j0, m, d, tid);
    __syncthreads();
    const long long gj = j0 + tx;
    if (gj >= m) continue;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_THREAD; ++rr) {
      const int r = threadIdx.y + rr * THREADS_Y;
      const long long gi = i0 + r;
      if (gi >= n) break;
      T d2 = T(0);
      for (int k = 0; k < d; ++k) {
        const T diff = sx[k][r] - sy[k][tx];
        d2 += diff * diff;
      }
      const T h = M<T>::sqrt(d2);
      const T e = M<T>::exp(-c * h);
      const T t = twoc * h;
      const bool finite_h = !isinf(h);
      const T kv = finite_h ? e * horner<T>(a, p, t) : T(0);
      T kij = sigma2 * kv;
      if (same && gi == gj) kij += nugget;
      const T kb = kbar[gi * m + gj];
      acc[0] += static_cast<double>(kb * kij);
      if (h > T(0) && finite_h) {
        const T dk = c * e * horner<T>(b, p, t);  // k_p'(h)
        const T w = kb * sigma2 * dk / h;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const T diff = sx[k][r] - sy[k][tx];
            acc[1 + k] += static_cast<double>(w * diff * diff);
          }
        }
      }
    }
  }

  // block reduction in a fixed order: warp shuffles, then warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k <= DMAX; ++k) {
    if (k <= d) {
      double v = acc[k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][k] = v;
    }
  }
  __syncthreads();
  if (tid <= d) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += red[w][tid];
    const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    partial[blk * (d + 1) + tid] = s;
  }
}

// out[k] = sum_b partial[b, k], one block per component, fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials_kernel(const double* __restrict__ partial, double* __restrict__ out,
                       long long nblocks, int width) {
  __shared__ double red[REDUCE_THREADS / 32];
  const int k = blockIdx.x;
  double s = 0.0;
  for (long long bi = threadIdx.x; bi < nblocks; bi += REDUCE_THREADS)
    s += partial[bi * width + k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < REDUCE_THREADS / 32; ++w) tot += red[w];
    out[k] = tot;
  }
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

dim3 gram_grid(long long n, long long m) {
  return dim3(static_cast<unsigned>((m + TILE - 1) / TILE),
              static_cast<unsigned>((n + TILE - 1) / TILE));
}

dim3 pullback_grid(long long n, long long m) {
  long long cols = (m + TILE - 1) / TILE;
  if (cols > PULLBACK_COL_GROUPS) cols = PULLBACK_COL_GROUPS;
  return dim3(static_cast<unsigned>(cols), static_cast<unsigned>((n + TILE - 1) / TILE));
}

bool bad_shape(long long n, long long m, int d) {
  return n <= 0 || m <= 0 || d < 1 || d > MAX_D || (n + TILE - 1) / TILE > 65535 ||
         (m + TILE - 1) / TILE > 0x7fffffffLL;
}

template <typename T>
int launch_gram(const void* x, const void* y, const void* theta, const void* coef,
                void* out, long long n, long long m, int d, int p, int same,
                double eps, void* stream) {
  if (bad_shape(n, m, d) || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  matern_gram_kernel<T><<<gram_grid(n, m), dim3(THREADS_X, THREADS_Y), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(theta),
      static_cast<const double*>(coef), static_cast<T*>(out), n, m, d, p, same,
      static_cast<T>(eps));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
void launch_pullback_main(const void* kbar, const void* x, const void* y,
                          const void* theta, const void* coef, void* partial,
                          long long n, long long m, int d, int p, int same, double eps,
                          cudaStream_t s) {
  matern_pullback_kernel<T, DMAX><<<pullback_grid(n, m), dim3(THREADS_X, THREADS_Y), 0, s>>>(
      static_cast<const T*>(kbar), static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(theta), static_cast<const double*>(coef),
      static_cast<double*>(partial), n, m, d, p, same, static_cast<T>(eps));
}

template <typename T>
int launch_pullback(const void* kbar, const void* x, const void* y, const void* theta,
                    const void* coef, void* partial, void* out, long long n, long long m,
                    int d, int p, int same, double eps, void* stream) {
  if (bad_shape(n, m, d) || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 8)
    launch_pullback_main<T, 8>(kbar, x, y, theta, coef, partial, n, m, d, p, same, eps, s);
  else
    launch_pullback_main<T, MAX_D>(kbar, x, y, theta, coef, partial, n, m, d, p, same, eps, s);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 g = pullback_grid(n, m);
  const long long nblocks = static_cast<long long>(g.x) * g.y;
  reduce_partials_kernel<<<d + 1, REDUCE_THREADS, 0, s>>>(
      static_cast<const double*>(partial), static_cast<double*>(out), nblocks, d + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gpmp_matern_max_d() { return MAX_D; }

long long gpmp_matern_pullback_blocks(long long n, long long m) {
  const dim3 g = pullback_grid(n, m);
  return static_cast<long long>(g.x) * g.y;
}

int gpmp_matern_gram_f64(const void* x, const void* y, const void* theta,
                         const void* coef, void* out, long long n, long long m, int d,
                         int p, int same, double eps, void* stream) {
  return launch_gram<double>(x, y, theta, coef, out, n, m, d, p, same, eps, stream);
}

int gpmp_matern_gram_f32(const void* x, const void* y, const void* theta,
                         const void* coef, void* out, long long n, long long m, int d,
                         int p, int same, double eps, void* stream) {
  return launch_gram<float>(x, y, theta, coef, out, n, m, d, p, same, eps, stream);
}

int gpmp_matern_pullback_f64(const void* kbar, const void* x, const void* y,
                             const void* theta, const void* coef, void* partial, void* out,
                             long long n, long long m, int d, int p, int same, double eps,
                             void* stream) {
  return launch_pullback<double>(kbar, x, y, theta, coef, partial, out, n, m, d, p, same,
                                 eps, stream);
}

int gpmp_matern_pullback_f32(const void* kbar, const void* x, const void* y,
                             const void* theta, const void* coef, void* partial, void* out,
                             long long n, long long m, int d, int p, int same, double eps,
                             void* stream) {
  return launch_pullback<float>(kbar, x, y, theta, coef, partial, out, n, m, d, p, same,
                                eps, stream);
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
