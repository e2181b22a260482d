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
// What bounds them on the H100: the forward writes 8 bytes (f64) per entry
// for ~3d flops and a sqrt; the pullback reads 8 bytes of Dbar per entry
// for ~4d flops, a sqrt and a division.  At d = 6 that is ~3 f64 flops per
// byte against the card's ~10 (34 TFLOP/s over 3.35 TB/s): both are bound
// by memory traffic (8 MB, ~2.4 us at n = m = 1000), and at that size by
// launch latency.
//
// What the design does about it: each block owns a 32 x 32 tile of D and
// stages its 32 x-rows and 32 y-rows, scaled by e^l, in shared memory
// (transposed, so a warp reads consecutive words); a warp writes (forward)
// or reads (pullback) 32 consecutive entries of a row.  The pullback
// recomputes the differences from x and y instead of saving an (n, m, d)
// tensor or reading D, accumulates in f64 in registers (d <= DMAX
// templated), reduces each block with warp shuffles, writes a
// (nblocks, d) partial buffer, and a second launch reduces that buffer in
// a fixed order: no atomics, the gradient is bitwise reproducible.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int NTHREADS = THREADS_X * THREADS_Y;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS_PER_THREAD = TILE / THREADS_Y;
constexpr int MAX_D = 32;
constexpr int PULLBACK_COL_GROUPS = 32;  // column-tile groups per row tile
constexpr int EW_THREADS = 256;          // elementwise variant
constexpr long long EW_MAX_BLOCKS = 264;  // two per SM of the H100
constexpr int REDUCE_THREADS = 256;

template <typename T> struct M;
template <> struct M<double> {
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double sqrt(double v) { return ::sqrt(v); }
};
template <> struct M<float> {
  static __device__ __forceinline__ float exp(float v) { return ::expf(v); }
  static __device__ __forceinline__ float sqrt(float v) { return ::sqrtf(v); }
};

// Stage rows [r0, r0 + TILE) of src (rows x d, row-major), scaled by
// e^{l[k]}, into dst[k][r] (transposed); rows past the end are 0.
template <typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[TILE], const T* __restrict__ src,
                                           const T* __restrict__ l, long long r0,
                                           long long rows, int d, int tid) {
  for (int e = tid; e < TILE * d; e += NTHREADS) {
    const int r = e / d, k = e - r * d;
    const long long g = r0 + r;
    dst[k][r] = g < rows ? M<T>::exp(l[k]) * src[g * d + k] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
distance_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ l,
                T* __restrict__ out, long long n, long long m, int d) {
  __shared__ T sx[MAX_D][TILE];
  __shared__ T sy[MAX_D][TILE];
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * TILE;
  const long long j0 = static_cast<long long>(blockIdx.x) * TILE;
  stage_rows<T>(sx, x, l, i0, n, d, tid);
  stage_rows<T>(sy, y, l, j0, m, d, tid);
  __syncthreads();
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
    out[gi * m + gj] = M<T>::sqrt(d2);
  }
}

// sum of acc[0..d) over the block in a fixed order (warp shuffles, then
// warps in order), written by threads 0..d-1 to partial[blk * d + k]
template <int DMAX>
__device__ __forceinline__ void block_to_partial(double (&acc)[DMAX],
                                                 double (*red)[DMAX], int d, int tid,
                                                 long long blk, double* __restrict__ partial) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    if (k < d) {
      double v = acc[k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][k] = v;
    }
  }
  __syncthreads();
  if (tid < d) {
    double s = 0.0;
    for (int w = 0; w < NWARPS; ++w) s += red[w][tid];
    partial[blk * d + tid] = s;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NTHREADS)
distance_pullback_kernel(const T* __restrict__ dbar, const T* __restrict__ x,
                         const T* __restrict__ y, const T* __restrict__ l,
                         double* __restrict__ partial, long long n, long long m, int d) {
  __shared__ T sx[DMAX][TILE];
  __shared__ T sy[DMAX][TILE];
  __shared__ double red[NWARPS][DMAX];
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const int tx = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * TILE;
  double acc[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = 0.0;

  stage_rows<T>(sx, x, l, i0, n, d, tid);
  for (long long j0 = static_cast<long long>(blockIdx.x) * TILE; j0 < m;
       j0 += static_cast<long long>(gridDim.x) * TILE) {
    __syncthreads();  // the previous tile's reads of sy are done
    stage_rows<T>(sy, y, l, j0, m, d, tid);
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
      if (h > T(0)) {
        const T w = dbar[gi * m + gj] / h;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const T diff = sx[k][r] - sy[k][tx];
            acc[k] += static_cast<double>(w * (diff * diff));
          }
        }
      }
    }
  }
  const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  block_to_partial<DMAX>(acc, red, d, tid, blk, partial);
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
                                     double* __restrict__ partial, long long n, int d) {
  __shared__ double red[EW_THREADS / 32][DMAX];
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
  static_assert(EW_THREADS == NTHREADS, "block_to_partial assumes NTHREADS threads");
  block_to_partial<DMAX>(acc, red, d, threadIdx.x, blockIdx.x, partial);
}

// out[k] = sum_b partial[b * width + k], one block per component, fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
distance_reduce_kernel(const double* __restrict__ partial, double* __restrict__ out,
                       long long nblocks, int width) {
  __shared__ double red[REDUCE_THREADS / 32];
  const int k = blockIdx.x;
  double s = 0.0;
  for (long long b = threadIdx.x; b < nblocks; b += REDUCE_THREADS) s += partial[b * width + k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < REDUCE_THREADS / 32; ++w) tot += red[w];
    out[k] = tot;
  }
}

dim3 tile_grid(long long n, long long m) {
  return dim3(static_cast<unsigned>((m + TILE - 1) / TILE),
              static_cast<unsigned>((n + TILE - 1) / TILE));
}

dim3 pullback_grid(long long n, long long m) {
  long long cols = (m + TILE - 1) / TILE;
  if (cols > PULLBACK_COL_GROUPS) cols = PULLBACK_COL_GROUPS;
  return dim3(static_cast<unsigned>(cols), static_cast<unsigned>((n + TILE - 1) / TILE));
}

long long ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return b < EW_MAX_BLOCKS ? b : EW_MAX_BLOCKS;
}

bool bad_shape(long long n, long long m, int d) {
  return n <= 0 || m <= 0 || d < 1 || d > MAX_D || (n + TILE - 1) / TILE > 65535 ||
         (m + TILE - 1) / TILE > 0x7fffffffLL;
}

template <typename T>
int launch_distance(const void* x, const void* y, const void* l, void* out, long long n,
                    long long m, int d, void* stream) {
  if (bad_shape(n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  distance_kernel<T><<<tile_grid(n, m), dim3(THREADS_X, THREADS_Y), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(l),
      static_cast<T*>(out), n, m, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pullback(const void* dbar, const void* x, const void* y, const void* l,
                    void* partial, void* out, long long n, long long m, int d, void* stream) {
  if (bad_shape(n, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = pullback_grid(n, m), b(THREADS_X, THREADS_Y);
  const T *db = static_cast<const T*>(dbar), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y), *ll = static_cast<const T*>(l);
  double* part = static_cast<double*>(partial);
  if (d <= 8)
    distance_pullback_kernel<T, 8><<<g, b, 0, s>>>(db, xx, yy, ll, part, n, m, d);
  else
    distance_pullback_kernel<T, MAX_D><<<g, b, 0, s>>>(db, xx, yy, ll, part, n, m, d);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  distance_reduce_kernel<<<d, REDUCE_THREADS, 0, s>>>(
      part, static_cast<double*>(out), static_cast<long long>(g.x) * g.y, d);
  return static_cast<int>(cudaGetLastError());
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
                                void* partial, void* out, long long n, int d, void* stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = ew_blocks(n);
  const T *db = static_cast<const T*>(dbar), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y), *ll = static_cast<const T*>(l);
  double* part = static_cast<double*>(partial);
  if (d <= 8)
    distance_elementwise_pullback_kernel<T, 8><<<static_cast<unsigned>(nb), EW_THREADS, 0, s>>>(
        db, xx, yy, ll, part, n, d);
  else
    distance_elementwise_pullback_kernel<T, MAX_D>
        <<<static_cast<unsigned>(nb), EW_THREADS, 0, s>>>(db, xx, yy, ll, part, n, d);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  distance_reduce_kernel<<<d, REDUCE_THREADS, 0, s>>>(part, static_cast<double*>(out), nb, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gpmp_distance_max_d() { return MAX_D; }

long long gpmp_distance_pullback_blocks(long long n, long long m) {
  const dim3 g = pullback_grid(n, m);
  return static_cast<long long>(g.x) * g.y;
}

long long gpmp_distance_elementwise_blocks(long long n) { return ew_blocks(n); }

int gpmp_distance_f64(const void* x, const void* y, const void* l, void* out, long long n,
                      long long m, int d, void* stream) {
  return launch_distance<double>(x, y, l, out, n, m, d, stream);
}

int gpmp_distance_f32(const void* x, const void* y, const void* l, void* out, long long n,
                      long long m, int d, void* stream) {
  return launch_distance<float>(x, y, l, out, n, m, d, stream);
}

int gpmp_distance_pullback_f64(const void* dbar, const void* x, const void* y, const void* l,
                               void* partial, void* out, long long n, long long m, int d,
                               void* stream) {
  return launch_pullback<double>(dbar, x, y, l, partial, out, n, m, d, stream);
}

int gpmp_distance_pullback_f32(const void* dbar, const void* x, const void* y, const void* l,
                               void* partial, void* out, long long n, long long m, int d,
                               void* stream) {
  return launch_pullback<float>(dbar, x, y, l, partial, out, n, m, d, stream);
}

int gpmp_distance_elementwise_f64(const void* x, const void* y, const void* l, void* out,
                                  long long n, int d, void* stream) {
  return launch_elementwise<double>(x, y, l, out, n, d, stream);
}

int gpmp_distance_elementwise_f32(const void* x, const void* y, const void* l, void* out,
                                  long long n, int d, void* stream) {
  return launch_elementwise<float>(x, y, l, out, n, d, stream);
}

int gpmp_distance_elementwise_pullback_f64(const void* dbar, const void* x, const void* y,
                                           const void* l, void* partial, void* out,
                                           long long n, int d, void* stream) {
  return launch_elementwise_pullback<double>(dbar, x, y, l, partial, out, n, d, stream);
}

int gpmp_distance_elementwise_pullback_f32(const void* dbar, const void* x, const void* y,
                                           const void* l, void* partial, void* out,
                                           long long n, int d, void* stream) {
  return launch_elementwise_pullback<float>(dbar, x, y, l, partial, out, n, d, stream);
}

}  // extern "C"
