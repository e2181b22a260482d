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
//    Bound: reading Hr, H2r and Hc once, 12 c n bytes per chunk (0.060 ms
//    for c = 512, n = 32768 at 3.35 TB/s): memory-bound.  It replaces a
//    kernel of 32 x 32 tiles with 4-byte loads, a few KB in flight an SM,
//    and a second launch whose one thread summed the 264 block partials in
//    a chain (0.209 ms device, 29% of the bound).  Design: one launch a
//    chunk; a persistent grid (ops/streamed.py h_traces_plan: two blocks an
//    SM) walks tiles of 32 chunk rows x 128 columns; a warp owns 4 rows, a
//    lane 4 consecutive columns of each, read from Hr and H2r with 16-byte
//    streaming loads; the tile's Hc block H[m0 .. + 127, r0 + a0 .. + 31]
//    (128-byte row segments) comes into shared memory by 16-byte cp.async
//    copies, double-buffered, read back transposed as one 16-byte load a
//    lane and column from rows whose units are swizzled (no bank
//    conflicts); the next tile's copies and loads are in flight while this
//    tile is summed (about 48 KB a block).  Rows not 16-byte aligned (n or
//    r0 not a multiple of 4) take the same kernel with 4-byte loads and
//    copies.  Each thread sums its entries in a fixed order, then
//    csrc/fixed_sum.cuh's grid_sum: the block's sums, and the last block
//    to take the ticket sums the partials and adds them to acc (bitwise
//    reproducible; partials and ticket in a workspace cached by the
//    wrapper per (device, c, n)).
//
// Tensor cores, TMA and wgmma are not used: these kernels are simple and
// right first; making them fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "syrk_f64.cuh"  // cp.async

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
constexpr int HT_ROWS = 32;     // chunk rows a tile: 8 warps of 4
constexpr int HT_COLS = 128;    // columns a tile: 4 a lane
constexpr int HT_WARPS = 8;
constexpr int HT_THREADS = 32 * HT_WARPS;
constexpr int HT_UNITS = HT_ROWS / 4;  // 16-byte units of a staged Hc row
static_assert(HT_WARPS * 4 == HT_ROWS && 32 * 4 == HT_COLS, "a warp 4 rows, a lane 4 columns");

// The Hc tile in shared memory: hc[mm][.] = H[m0 + mm, r0 + a0 .. + 31], its
// 16-byte unit u stored at unit u ^ ((mm >> 2) & 7), so that the 8 lanes of
// a quarter warp, reading rows mm = 4 t + e (t = 0..7) at one unit, hit 8
// distinct bank groups
__device__ __forceinline__ int ht_slot(int mm, int u) { return 4 * (u ^ ((mm >> 2) & 7)); }

// the Hc tile (a0, m0) into buf by cp.async: 16-byte copies (VEC: every row
// of H 16-byte aligned and r0 % 4 == 0), else 4-byte ones; zeros past n and
// past the chunk's c rows
template <bool VEC>
__device__ __forceinline__ void ht_stage(float (*buf)[HT_ROWS], const float* __restrict__ H,
                                         long long r0, long long c, long long n, long long a0,
                                         long long m0, int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < HT_COLS * HT_UNITS / HT_THREADS; ++i) {
      const int q = tid + i * HT_THREADS, mm = q / HT_UNITS, u = q % HT_UNITS;
      const bool ok = m0 + mm < n && a0 + 4 * u < c;
      const float* src = ok ? H + (m0 + mm) * n + r0 + a0 + 4 * u : H;
      syrk::cp_async<16>(&buf[mm][ht_slot(mm, u)], src, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < HT_COLS * HT_ROWS / HT_THREADS; ++i) {
      const int q = tid + i * HT_THREADS, mm = q / HT_ROWS, aa = q % HT_ROWS;
      const bool ok = m0 + mm < n && a0 + aa < c;
      const float* src = ok ? H + (m0 + mm) * n + r0 + a0 + aa : H;
      syrk::cp_async<4>(&buf[mm][ht_slot(mm, aa / 4) + aa % 4], src, ok);
    }
  }
  syrk::cp_commit();
}

// a lane's 4 columns m .. m + 3 of the warp's 4 rows a0w .. a0w + 3 of Hr
// and H2r (rows past c and columns past n read as zeros), streaming loads:
// 16-byte ones (VEC: every row 16-byte aligned), else 4-byte ones
template <bool VEC>
__device__ __forceinline__ void ht_load(const float* __restrict__ H, const float* __restrict__ H2r,
                                        long long r0, long long c, long long n, long long a0w,
                                        long long m, float4 (&hr)[4], float4 (&h2)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long a = a0w + r;
    hr[r] = h2[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a >= c || m >= n) continue;
    const float* ph = H + (r0 + a) * n + m;
    const float* p2 = H2r + a * n + m;
    if (VEC) {
      hr[r] = __ldcs(reinterpret_cast<const float4*>(ph));
      h2[r] = __ldcs(reinterpret_cast<const float4*>(p2));
    } else {
      hr[r] = make_float4(__ldcs(ph), m + 1 < n ? __ldcs(ph + 1) : 0.f,
                          m + 2 < n ? __ldcs(ph + 2) : 0.f, m + 3 < n ? __ldcs(ph + 3) : 0.f);
      h2[r] = make_float4(__ldcs(p2), m + 1 < n ? __ldcs(p2 + 1) : 0.f,
                          m + 2 < n ? __ldcs(p2 + 2) : 0.f, m + 3 < n ? __ldcs(p2 + 3) : 0.f);
    }
  }
}

__device__ __forceinline__ float ht_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// block b walks the tiles t = b, b + blocks, ... (tile t: chunk rows
// a0 = (t % ta) 32, columns m0 = (t / ta) 128); the next tile's Hc copies
// and its Hr, H2r loads are issued before this tile's sums.  A thread sums
// its entries in a fixed order (tiles, its 4 rows, its 4 columns), then
// fixed_sum::grid_sum, and the last block adds the totals to acc.
template <bool VEC>
__global__ void __launch_bounds__(HT_THREADS, 2)
h_traces_kernel(const float* __restrict__ H, const float* __restrict__ H2r,
                double* __restrict__ partial, unsigned int* __restrict__ ticket,
                double* __restrict__ acc, long long r0, long long c, long long n) {
  __shared__ __align__(16) float hc[2][HT_COLS][HT_ROWS];
  __shared__ fixed_sum::Smem<4, HT_THREADS> sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ta = (c + HT_ROWS - 1) / HT_ROWS;
  const long long tiles = ta * ((n + HT_COLS - 1) / HT_COLS);
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  long long t = blockIdx.x;
  float4 hr[4], h2[4];
  if (t < tiles) {
    const long long a0 = (t % ta) * HT_ROWS, m0 = (t / ta) * HT_COLS;
    ht_stage<VEC>(hc[0], H, r0, c, n, a0, m0, tid);
    ht_load<VEC>(H, H2r, r0, c, n, a0 + 4 * warp, m0 + 4 * lane, hr, h2);
  }
  for (int k = 0; t < tiles; ++k, t += gridDim.x) {
    const long long a0 = (t % ta) * HT_ROWS, m0 = (t / ta) * HT_COLS;
    const long long tn = t + gridDim.x;
    const bool more = tn < tiles;
    float4 hrn[4], h2n[4];
    if (more) {
      const long long a0n = (tn % ta) * HT_ROWS, m0n = (tn / ta) * HT_COLS;
      ht_stage<VEC>(hc[(k + 1) & 1], H, r0, c, n, a0n, m0n, tid);
      ht_load<VEC>(H, H2r, r0, c, n, a0n + 4 * warp, m0n + 4 * lane, hrn, h2n);
      syrk::cp_wait<1>();  // this tile's copies (all but the newest group)
    } else {
      syrk::cp_wait<0>();
    }
    __syncthreads();
    const long long a0w = a0 + 4 * warp, m = m0 + 4 * lane;
    // the tile holds diagonal entries (m == r0 + a) only where its columns
    // meet r0 + a0 .. r0 + a0 + 31
    const bool diag = r0 + a0 < m0 + HT_COLS && m0 < r0 + a0 + HT_ROWS;
    float4 hv[4];  // hv[e] = Hc[m + e, a0w .. a0w + 3] (components: r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = 4 * lane + e;
      hv[e] = *reinterpret_cast<const float4*>(&hc[k & 1][mm][ht_slot(mm, warp)]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (a0w + r >= c) break;  // the warp's rows past the chunk (their Hc is not read)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double x = static_cast<double>(ht_at(hr[r], e));
        const double y = static_cast<double>(ht_at(h2[r], e));
        const double z = static_cast<double>(ht_at(hv[e], r));
        if (diag && m + e == r0 + a0w + r) s[0] += x;
        s[1] += x * z;
        s[2] += y * z;
        s[3] += y * y;
      }
    }
    __syncthreads();  // the next step refills this buffer
    if (more) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hr[r] = hrn[r];
        h2[r] = h2n[r];
      }
    }
  }
  if (fixed_sum::grid_sum(sm, s, partial, ticket)) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += s[q];
  }
}

}  // namespace

extern "C" {

int gpmp_split_rows(const void* k64, const void* corr, void* hi, void* lo, long long r0,
                    long long c, long long n, float ridge, void* stream) {
  return launch_split_rows(k64, corr, hi, lo, r0, c, n, ridge, stream);
}

// K10t's geometry: chunk rows a tile, columns a tile, threads a block
// (ops/streamed.py checks them)
int gpmp_h_traces_geometry(int what) {
  switch (what) {
    case 0: return HT_ROWS;
    case 1: return HT_COLS;
    case 2: return HT_THREADS;
    default: return -1;
  }
}

// acc[0..3] += the four sums of the row chunk [r0, r0 + c) of the (n, n) f32
// H, H2r = H[r0:r0+c] H (c, n): one launch of ``blocks`` blocks (ops/
// streamed.py h_traces_plan), partial (4 blocks f64) and ticket (zero) its
// workspace
int gpmp_h_traces(const void* H, const void* H2r, void* partial, void* ticket, void* acc,
                  long long r0, long long c, long long n, long long blocks, void* stream) {
  if (n <= 0 || c <= 0 || r0 < 0 || r0 + c > n || blocks <= 0 || !H || !H2r || !partial ||
      !ticket || !acc)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((c + HT_ROWS - 1) / HT_ROWS) * ((n + HT_COLS - 1) / HT_COLS);
  if (blocks > tiles || blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(H);
  const float* h2 = static_cast<const float*>(H2r);
  const bool vec = n % 4 == 0 && r0 % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h2) % 16 == 0;
  double* pt = static_cast<double*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  double* a = static_cast<double*>(acc);
  if (vec)
    h_traces_kernel<true><<<static_cast<unsigned>(blocks), HT_THREADS, 0, s>>>(h, h2, pt, tk, a,
                                                                               r0, c, n);
  else
    h_traces_kernel<false><<<static_cast<unsigned>(blocks), HT_THREADS, 0, s>>>(h, h2, pt, tk, a,
                                                                                r0, c, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
