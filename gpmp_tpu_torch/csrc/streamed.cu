// gpmp_tpu_torch/csrc/streamed.cu
//
// K10b and K10t: the hand-written kernels of the streamed large-n engine
// (gpmp_tpu_torch/parallel/streamed.py, wrappers in
// gpmp_tpu_torch/ops/streamed.py) for Hopper, sm_90a.  Plain C entry
// points, loaded with ctypes by gpmp_tpu_torch/ops/_build.py.  The engine's
// other kernels are K3's and K4's on its sources of K (K10m, K10r in
// csrc/mixed.cu), K5, and K6.
//
// K10b row-chunk split (replaces gpmp_tpu/parallel/streamed.py _build_ff and
//    _build_k32, with the diagonal term of _gram_rows):
//      for an f64 row chunk k64 (c, n) of the cross-covariance at rows
//      [r0, r0 + c), v = k64 + corr on the global diagonal, then
//        ff:        hi = f32(v), lo = f32(v - hi), written in place into
//                   rows [r0, r0 + c) of the (n, n) pair;
//        recompute: hi = f32(v), plus the f32 ridge on the diagonal, into
//                   K32.
//    Bound: 8 bytes read and 8 written per entry (ff; 4 written for
//    recompute): memory-bound, 8.6 GB over the n = 32768 build (2.6 ms).
//    Design: one row of blocks per chunk row, the blocks striding over its
//    columns with consecutive threads on consecutive entries (coalesced
//    8-byte reads and 4-byte writes); the f64 chunk never leaves its one
//    buffer.
//
// K10t chunked trace sums (replaces _h_traces):
//      for the row chunk r0 .. r0 + c of H (n, n) f32 and H2r = H[r0:r0+c] H
//      (c, n) f32 (a torch.matmul), adds to acc[0..3]
//        tr H (the chunk's diagonal), sum Hr o Hc^T, sum H2r o Hc^T,
//        sum H2r o H2r,
//      with Hr = H[r0:r0+c, :], Hc = H[:, r0:r0+c]: the JAX package's
//      definitions (with Hc^T, not Hr again: H is symmetric only to f32
//      roundoff), products and sums in f64 (exact products of f32 values).
//    Bound: reading Hr, H2r and Hc once, 12 c n bytes per chunk (~0.2 ms
//    for c = 512, n = 32768): memory-bound.  Design: 32 x 32 tiles of
//    (a, m); the Hc tile H[m0 + mm, r0 + a0 + aa] is staged in shared
//    memory with consecutive threads on consecutive aa (coalesced), then
//    read transposed (padded rows: no bank conflicts) beside Hr and H2r
//    read with consecutive threads on consecutive m; a fixed grid of at
//    most two blocks per SM walks the tiles, block sums in a fixed order,
//    per-block partials, and a second launch adds them to acc in a fixed
//    order (no atomics: bitwise reproducible).
//
// Tensor cores, TMA and wgmma are not used: these kernels are simple and
// right first; making them fast is later work.

#include <cuda_runtime.h>

namespace {

constexpr int SP_THREADS = 256;
constexpr long long SP_MAX_X_BLOCKS = 32;  // per row: up to 8192 columns a pass

// ---------------------------------------------------------------- K10b
template <bool PAIR>
__global__ void __launch_bounds__(SP_THREADS)
split_rows_kernel(const double* __restrict__ k64, const double* __restrict__ corr,
                  float* __restrict__ hi, float* __restrict__ lo, long long r0, long long c,
                  long long n, float ridge) {
  // blockIdx.y: the chunk's row a; the x blocks stride over its columns
  const long long a = blockIdx.y;
  const long long diag_j = r0 + a;
  const double* src = k64 + a * n;
  float* hi_row = hi + (r0 + a) * n;
  float* lo_row = PAIR ? lo + (r0 + a) * n : nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * SP_THREADS;
  for (long long j = static_cast<long long>(blockIdx.x) * SP_THREADS + threadIdx.x; j < n;
       j += stride) {
    const bool diag = (j == diag_j);
    double v = src[j];
    if (diag) v += corr[a];
    float h = static_cast<float>(v);
    if (PAIR) {
      lo_row[j] = static_cast<float>(v - static_cast<double>(h));
    } else if (diag) {
      h = h + ridge;
    }
    hi_row[j] = h;
  }
}

int launch_split_rows(const void* k64, const void* corr, void* hi, void* lo, long long r0,
                      long long c, long long n, float ridge, void* stream) {
  if (n <= 0 || c <= 0 || c > 65535 || r0 < 0 || r0 + c > n)
    return static_cast<int>(cudaErrorInvalidValue);
  long long xb = (n + SP_THREADS - 1) / SP_THREADS;
  if (xb > SP_MAX_X_BLOCKS) xb = SP_MAX_X_BLOCKS;
  const dim3 grid(static_cast<unsigned>(xb), static_cast<unsigned>(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* k = static_cast<const double*>(k64);
  const double* cr = static_cast<const double*>(corr);
  if (lo) {
    split_rows_kernel<true><<<grid, SP_THREADS, 0, s>>>(
        k, cr, static_cast<float*>(hi), static_cast<float*>(lo), r0, c, n, ridge);
  } else {
    split_rows_kernel<false><<<grid, SP_THREADS, 0, s>>>(
        k, cr, static_cast<float*>(hi), nullptr, r0, c, n, ridge);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K10t
constexpr int HT_TILE = 32;
constexpr int HT_TY = 8;  // block (32, 8): each thread owns 4 rows a of a tile
constexpr int HT_THREADS = HT_TILE * HT_TY;
constexpr long long HT_MAX_BLOCKS = 264;  // two per SM of the H100

long long h_traces_blocks(long long c, long long n) {
  const long long tiles = ((c + HT_TILE - 1) / HT_TILE) * ((n + HT_TILE - 1) / HT_TILE);
  return tiles < HT_MAX_BLOCKS ? tiles : HT_MAX_BLOCKS;
}

__global__ void __launch_bounds__(HT_THREADS)
h_traces_kernel(const float* __restrict__ H, const float* __restrict__ H2r,
                double* __restrict__ partial, long long r0, long long c, long long n) {
  __shared__ float hc[HT_TILE][HT_TILE + 1];  // hc[mm][aa] = H[m0 + mm, r0 + a0 + aa]
  __shared__ double red[4][HT_THREADS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long ta = (c + HT_TILE - 1) / HT_TILE;
  const long long tiles = ta * ((n + HT_TILE - 1) / HT_TILE);
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long a0 = (t % ta) * HT_TILE, m0 = (t / ta) * HT_TILE;
    __syncthreads();  // the previous tile is no longer read
    for (int mm = ty; mm < HT_TILE; mm += HT_TY) {
      const long long m = m0 + mm, a = a0 + tx;
      hc[mm][tx] = (m < n && a < c) ? H[m * n + r0 + a] : 0.0f;
    }
    __syncthreads();
    const long long m = m0 + tx;
    if (m < n) {
      for (int aa = ty; aa < HT_TILE; aa += HT_TY) {
        const long long a = a0 + aa;
        if (a >= c) break;
        const double hr = static_cast<double>(H[(r0 + a) * n + m]);
        const double h2 = static_cast<double>(H2r[a * n + m]);
        const double hcv = static_cast<double>(hc[tx][aa]);
        if (m == r0 + a) s0 += hr;
        s1 += hr * hcv;
        s2 += h2 * hcv;
        s3 += h2 * h2;
      }
    }
  }
  const int tid = ty * HT_TILE + tx;
  red[0][tid] = s0;
  red[1][tid] = s1;
  red[2][tid] = s2;
  red[3][tid] = s3;
  __syncthreads();
  for (int h = HT_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) red[q][tid] += red[q][tid + h];
    }
    __syncthreads();
  }
  if (tid < 4) partial[4 * blockIdx.x + tid] = red[tid][0];
}

// acc[q] += sum_b partial[4 b + q], in a fixed order
__global__ void h_traces_reduce_kernel(const double* __restrict__ partial, long long blocks,
                                       double* __restrict__ acc) {
  const int q = threadIdx.x;
  if (q >= 4) return;
  double s = 0.0;
  for (long long b = 0; b < blocks; ++b) s += partial[4 * b + q];
  acc[q] += s;
}

}  // namespace

extern "C" {

int gpmp_split_rows(const void* k64, const void* corr, void* hi, void* lo, long long r0,
                    long long c, long long n, float ridge, void* stream) {
  return launch_split_rows(k64, corr, hi, lo, r0, c, n, ridge, stream);
}

long long gpmp_h_traces_blocks(long long c, long long n) { return h_traces_blocks(c, n); }

int gpmp_h_traces(const void* H, const void* H2r, void* partial, void* acc, long long r0,
                  long long c, long long n, void* stream) {
  if (n <= 0 || c <= 0 || r0 < 0 || r0 + c > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = h_traces_blocks(c, n);
  h_traces_kernel<<<static_cast<unsigned>(nb), dim3(HT_TILE, HT_TY), 0, s>>>(
      static_cast<const float*>(H), static_cast<const float*>(H2r),
      static_cast<double*>(partial), r0, c, n);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  h_traces_reduce_kernel<<<1, 32, 0, s>>>(static_cast<const double*>(partial), nb,
                                          static_cast<double*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
