// gpmp_tpu_torch/csrc/mixed.cu
//
// K3, K5, K6, K7 and K7b: the hand-written kernels of the mixed-precision
// Cholesky engine (gpmp_tpu_torch/ops/mixed.py; its K4 and K4s, and K8s,
// the residual of its sampling root, are csrc/residual.cu); K10m, the
// streamed engine's residual against its f32 pair
// (gpmp_tpu_torch/ops/streamed.py; its K10r is csrc/residual.cu's); for
// Hopper, sm_90a.  Plain C entry points, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.
//
// K3 residual (replaces gpmp_tpu/ops/mixed.py _f64_matvec and the residual
//    norms of refined_cholesky_solve):
//      R = B - K X, and (sum R^2, sum B^2) in f64, K (rows <= n, n) (the
//      square K, or a rank's row slab), X (n, k <= 8), B and R (rows, k);
//      K, X, B and R f64, or all f32 with the products and sums in f64.
//    Bound on the H100: reading K once (8 n^2 bytes in f64) against 2 k
//    flops per entry: memory-bound (8 MB, 2.4 us at 3.35 TB/s at n = 1000;
//    at that n K stays in the 50 MB L2 between a refinement's sweeps, so
//    the device time may go below it).  It replaces a kernel of one warp a
//    row with a barrier every 256 columns to stage X in shared memory,
//    and a second launch for the norms: 17% of its bound at n = 1000, 125
//    blocks on 132 SMs with few bytes in flight.  Design, K10m's lines:
//    - a warp owns 4 rows and reads them with 16-byte streaming loads (4
//      consecutive entries a lane: one float4, or two double2), the next
//      128 columns' loads issued before this step's products; X through
//      the read-only path, a lane's 4 rows of X in 16-byte loads (scalar
//      loads where a row of K is not 16-byte aligned, or past n); no
//      barrier in the stream; 8 warps (32 rows) a block;
//    - the columns of each row cut into a fixed number of chunks, whole
//      128-column steps each, chosen by the wrapper from (rows, n, the
//      card's SMs) so that small n fills the card (gpmp_tpu_torch/ops/
//      mixed.py residual_column_chunks: 8 chunks of 128 at n = 1000, one
//      from n = 8448 up); block (row block, chunk) writes its rows' partial
//      sums of that chunk;
//    - the combine and the norms in the same launch, by atomic tickets
//      after a __threadfence: the last chunk of a row block to finish sums
//      its rows' partials in chunk order, writes R and the row block's
//      (sum R^2, sum B^2) over a fixed tree of its 256 threads; the last row
//      block to finish sums those pairs in index order with
//      reduce_pairs_kernel's arithmetic and resets the tickets.  Each sum
//      runs in one fixed order (a lane's columns, a butterfly over the
//      lanes, the chunks, the tree, the row blocks): bitwise reproducible.
//      The partials, the pairs and the tickets sit in a workspace the
//      wrapper caches per (device, rows, n, k).
//
// K10m streamed residual (replaces gpmp_tpu/parallel/streamed.py _matvec_ff
//    and the residual of _refined_solve_streamed):
//      R = B - (K32 + E32) X, and (sum R^2, sum B^2), with K held as the
//      float-float pair of the streamed engine (gpmp_tpu_torch/parallel/
//      streamed.py), X and B (n, k <= 8) in f64.
//    Bound: reading the pair once, 8 n^2 bytes (2.56 ms at n = 32768),
//    against 2 k + 1 f64 operations per entry: memory-bound for k <= 8.
//    It was K3's kernel on a two-float source, at 56% of that bound: a
//    barrier every 256 columns to stage X in shared memory, 4-byte loads, X
//    read from L2 once per 8 rows.  Design: a warp owns 4 rows and reads
//    them with 16-byte streaming loads (4 consecutive entries of hi and of
//    lo a lane; 4-byte ones where n % 4 != 0), the next 128 columns' loads
//    issued before this step's products; X through the read-only path, a
//    lane's 4 rows of X in 16-byte loads, shared by the warp's 4 rows;
//    no barrier until the epilogue; 8 warps (32 rows) a block, so X is read
//    from L2 a quarter as often.  Sums in f64 on hi + lo (exact in f64)
//    times x, in one fixed order: each lane's columns, a butterfly over the
//    lanes, the block's warps, then a fixed-order second launch
//    (reduce_pairs_kernel).
//
// Slab forms (the sharded mixed engine on a group mesh, gpmp_tpu_torch/
//    parallel/mixed.py; the JAX package's per-device shares of the same
//    programs): K3 and K7 take a rank's (rows, n) row slab (rows = n: the
//    square forms), K6 a slab of M and all of r, and gives that rank's part
//    of M^T (M r) (summed over the ranks by an all-reduce).  Bounds as the
//    square forms', per rank (K4s, K4's slab form, is csrc/residual.cu's).
//
// K6 preconditioner apply (replaces gpmp_tpu/ops/mixed.py _apply and
//    gpmp_tpu/parallel/streamed.py _apply_precond):
//      out = M^T (M r32), M (n, n) lower-triangular f32, r32 = f32(r) for
//      r (n, k) f64 (or f32), the products and sums in f32 (the JAX
//      package's rounding), out cast to r's type.
//    Bound: the lower triangle of M read once plus r and out, (n^2/2 +
//    2 n k) 4 bytes (0.64 ms at n = 32768): memory-bound for k <= 8.
//    Design for k <= 8: two passes over the lower triangle (the one-pass
//    form needs row i of M twice, for y_i = m_i r and for m_i^T y_i, and a
//    band of rows tall enough to keep the partial sums few does not stay
//    in the 50 MB L2 at n = 32768), each near bandwidth, in two launches.
//    It replaces three launches (a warp a row with 4-byte loads and r
//    staged through shared memory behind two barriers a 256-row tile; a
//    thread a column with one 4-byte load in flight; a third launch for
//    the sum of 64 chunks' partials, 16.8 MB written and read back at
//    n = 32768): 2.41 ms device, half of each pass's bandwidth.
//      pass 1: y = M r32, K10m's geometry: a warp owns 4 rows, 16-byte
//              loads along them (masked at the triangle and the ragged
//              end), the next 128 columns' loads issued before this step's
//              products, r32 through the read-only path, no shared memory,
//              no barrier; the block of the longest rows first;
//      pass 2: M^T y by (128-column band, row chunk) blocks, whole rows of
//              the triangle only (the rows and chunks above a band are
//              skipped), a lane 16 bytes of a row, a warp 4 rows a step,
//              the next step's loads issued before this step's products,
//              4 columns x k sums a lane; the chunk's y in shared memory
//              (one barrier before the rows: y in registers cost 16-64 of
//              them and an SM's third block); the band's chunk partials (a
//              chunk up to 1024 rows: 4 MB at n = 32768, k = 2) summed in
//              chunk order by its last block to finish, by a ticket after
//              a fence (K3's way).  The geometry is ops/mixed.py
//              precond_plan's (chunks enough for two blocks an SM).
//    Every sum runs in one fixed order: bitwise reproducible.
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
//    Bound: under 1 MB of traffic at n = 1000 (~0.2 us); in practice
//    latency-bound by the longest chain of dependent steps.  It replaces a
//    thread a column substituting down the 128 rows, a chain of 8128
//    dependent shared-memory multiply-adds in warp 0 (0.126 ms at n =
//    1000).  Design: one thread block of 256 threads a diagonal block, the
//    block (its lower triangle, completed with the identity to P = 8 2^m >=
//    base) in place in dynamic shared memory (P (P + 4) floats: 66 KB at
//    base = 128, above the 48 KB default, set once per device), loaded by
//    cp.async with all of a thread's copies in flight (16 bytes where the
//    rows are 16-byte aligned), then blocked inversion with a short chain:
//      the 8 x 8 diagonal leaves by substitution, a thread a column (28
//      multiply-adds and 8 divisions deep);
//      log2(P / 8) doubling levels s = 8 .. P / 2: each pair of inverted
//      s-blocks gives its 2s-block, T = A21 X11 then X21 = -(X22 T) (the
//      2 x 2 identity of _block_tri_inv), every thread on a register tile of
//      each product (4 x 4 at s = 64, 16-byte shared-memory reads), its
//      sums in order over k (s deep), written over A21 after a barrier;
//    the chain is 28 + 2 (8 + 16 + 32 + 64) = 268 multiply-adds deep at
//    base = 128.  f32 FMAs on the CUDA cores (TF32 would lose the f32
//    accuracy the levels above and the refinement rely on).  Measured, the
//    top level's products are bound by shared-memory wavefronts, the load
//    by its latency.  ops/mixed.py diag_block_inv_plain follows the same
//    order.
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
#include <stdint.h>

#include <atomic>

#include "syrk_f64.cuh"  // cp.async

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
constexpr int RES_WARPS = 8;                        // warps a block
constexpr int RES_ROWS = 4;                         // rows a warp
constexpr int RES_BLOCK_ROWS = RES_WARPS * RES_ROWS;
constexpr int RES_THREADS = 32 * RES_WARPS;
constexpr int RES_STEP = 128;                       // columns a warp step: 4 a lane
constexpr int RES_MAX_K = 8;
static_assert(RES_THREADS == RED_THREADS, "the last block sums as reduce_pairs_kernel does");
static_assert(RES_BLOCK_ROWS * RES_MAX_K <= RES_THREADS, "one combined entry a thread");

// a lane's 4 consecutive entries c .. c + 3 of a row, 16 bytes a load (VEC:
// the row 16-byte aligned; f64 needs n even, f32 n % 4 == 0), else scalar
// loads; entries past n read as zeros; streaming (__ldcs): K is read once
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  float4 v;
  template <bool VEC>
  __device__ __forceinline__ void load(const float* p, long long c, long long n) {
    if (VEC) {
      v = __ldcs(reinterpret_cast<const float4*>(p));
    } else {
      v = make_float4(__ldcs(p), c + 1 < n ? __ldcs(p + 1) : 0.f, c + 2 < n ? __ldcs(p + 2) : 0.f,
                      c + 3 < n ? __ldcs(p + 3) : 0.f);
    }
  }
  __device__ __forceinline__ double at(int e) const {
    return static_cast<double>(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  }
};
template <>
struct Quad<double> {
  double2 a, b;
  template <bool VEC>
  __device__ __forceinline__ void load(const double* p, long long c, long long n) {
    if (VEC) {  // n even: c + 1 < n, and c + 2 < n iff c + 3 < n
      a = __ldcs(reinterpret_cast<const double2*>(p));
      b = c + 2 < n ? __ldcs(reinterpret_cast<const double2*>(p + 2)) : make_double2(0.0, 0.0);
    } else {
      a = make_double2(__ldcs(p), c + 1 < n ? __ldcs(p + 1) : 0.0);
      b = make_double2(c + 2 < n ? __ldcs(p + 2) : 0.0, c + 3 < n ? __ldcs(p + 3) : 0.0);
    }
  }
  __device__ __forceinline__ double at(int e) const {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? b.x : b.y;
  }
};

// rows c .. c + 3 of X (n, KC) row-major, promoted to f64, past n zeros; a
// lane's 4 KC consecutive entries in 16-byte loads where X is 16-byte
// aligned and all 4 rows lie inside (c is a multiple of 4)
template <typename T, int KC>
__device__ __forceinline__ void load_x(const T* __restrict__ X, long long c, long long n,
                                       bool xvec, double (&x)[4][KC]) {
  if (xvec && c + 3 < n) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));  // entries a load
    const T* base = X + c * KC;
#pragma unroll
    for (int q = 0; q < 4 * KC / PER; ++q) {
      if constexpr (sizeof(T) == 8) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(base) + q);
        x[(2 * q) / KC][(2 * q) % KC] = v.x;
        x[(2 * q + 1) / KC][(2 * q + 1) % KC] = v.y;
      } else {
        const float4 v = __ldg(reinterpret_cast<const float4*>(base) + q);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) x[(4 * q + u) / KC][(4 * q + u) % KC] = e[u];
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < KC; ++q)
        x[e][q] = c + e < n ? static_cast<double>(__ldg(X + (c + e) * KC + q)) : 0.0;
  }
}

// a fixed tree over the block's RES_THREADS threads: s0[0], s1[0] hold the sums
__device__ __forceinline__ void res_tree(double* s0, double* s1, int tid) {
  __syncthreads();
#pragma unroll
  for (int h = RES_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s0[tid] += s0[tid + h];
      s1[tid] += s1[tid + h];
    }
    __syncthreads();
  }
}

// block (blockIdx.x, blockIdx.y) = (row block, column chunk): the partial
// sums of K X over the chunk's columns [y cw, min((y + 1) cw, n)) of the
// block's 32 rows into part[(y rows + i) KC + q]; then the tickets (see the
// header).  tickets: gridDim.x row blocks' counters and the grid's, zero
// between launches.  Rows past the slab read its last row; their sums are
// dropped.
// two blocks an SM (128 registers a thread) where that spills nothing: f32
// K up to k = 4, f64 K (twice the registers a step's loads hold) up to k = 2
template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(RES_THREADS, KC <= (sizeof(T) == 4 ? 4 : 2) ? 2 : 1)
residual_kernel(const T* __restrict__ K, const T* __restrict__ X, const T* __restrict__ B,
                T* __restrict__ R, double* __restrict__ part, double* __restrict__ pairs,
                unsigned int* __restrict__ tickets, double* __restrict__ norms, long long rows,
                long long n, long long cw, bool xvec) {
  __shared__ double s0[RES_THREADS], s1[RES_THREADS];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rb = blockIdx.x;
  const long long r0 = (rb * RES_WARPS + warp) * RES_ROWS;
  const T* row[RES_ROWS];
#pragma unroll
  for (int r = 0; r < RES_ROWS; ++r) row[r] = K + (r0 + r < rows ? r0 + r : rows - 1) * n;
  double acc[RES_ROWS][KC];
#pragma unroll
  for (int r = 0; r < RES_ROWS; ++r)
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[r][q] = 0.0;

  const long long cb = static_cast<long long>(blockIdx.y) * cw;
  const long long ce = cb + cw < n ? cb + cw : n;
  long long c = cb + 4 * lane;
  Quad<T> h[RES_ROWS];
  if (c < ce) {
#pragma unroll
    for (int r = 0; r < RES_ROWS; ++r) h[r].template load<VEC>(row[r] + c, c, n);
  }
  while (c < ce) {
    const long long cn = c + RES_STEP;
    Quad<T> hn[RES_ROWS];
    if (cn < ce) {
#pragma unroll
      for (int r = 0; r < RES_ROWS; ++r) hn[r].template load<VEC>(row[r] + cn, cn, n);
    }
    double x[4][KC];
    load_x<T, KC>(X, c, n, xvec, x);
#pragma unroll
    for (int r = 0; r < RES_ROWS; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double kv = h[r].at(e);
#pragma unroll
        for (int q = 0; q < KC; ++q) acc[r][q] = fma(kv, x[e][q], acc[r][q]);
      }
#pragma unroll
    for (int r = 0; r < RES_ROWS; ++r) h[r] = hn[r];
    c = cn;
  }
#pragma unroll
  for (int r = 0; r < RES_ROWS; ++r)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      double v = acc[r][q];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0 && r0 + r < rows) part[(blockIdx.y * rows + r0 + r) * KC + q] = v;
    }
  __threadfence();  // the partials are visible before the ticket counts them
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + rb, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // the row block's last chunk: its rows' chunks summed in chunk order
  __threadfence();
  double rr = 0.0, bb = 0.0;
  const long long i = rb * RES_BLOCK_ROWS + tid / KC;
  const int q = tid % KC;
  if (tid < RES_BLOCK_ROWS * KC && i < rows) {
    double v = 0.0;
    for (unsigned y = 0; y < gridDim.y; ++y) v += __ldcg(part + (y * rows + i) * KC + q);
    const T b = B[i * KC + q];
    const T r = static_cast<T>(static_cast<double>(b) - v);
    R[i * KC + q] = r;
    rr = static_cast<double>(r) * static_cast<double>(r);
    bb = static_cast<double>(b) * static_cast<double>(b);
  }
  s0[tid] = rr;
  s1[tid] = bb;
  res_tree(s0, s1, tid);
  if (tid == 0) {
    pairs[2 * rb] = s0[0];
    pairs[2 * rb + 1] = s1[0];
    tickets[rb] = 0u;
    __threadfence();
    last = atomicAdd(tickets + gridDim.x, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last row block: the pairs in index order, reduce_pairs_kernel's sums
  __threadfence();
  double a = 0.0, b = 0.0;
  for (long long t = tid; t < gridDim.x; t += RES_THREADS) {
    a += __ldcg(pairs + 2 * t);
    b += __ldcg(pairs + 2 * t + 1);
  }
  s0[tid] = a;
  s1[tid] = b;
  res_tree(s0, s1, tid);
  if (tid == 0) {
    norms[0] = s0[0];
    norms[1] = s1[0];
    tickets[gridDim.x] = 0u;
  }
}

long long residual_row_blocks(long long rows) {
  return (rows + RES_BLOCK_ROWS - 1) / RES_BLOCK_ROWS;
}

template <typename T, int KC>
int launch_residual_k(const T* K, const T* X, const T* B, T* R, double* part, double* pairs,
                      unsigned int* tickets, double* norms, long long rows, long long n,
                      long long cw, dim3 grid, bool vec, bool xvec, cudaStream_t s) {
  if (vec)
    residual_kernel<T, KC, true><<<grid, RES_THREADS, 0, s>>>(K, X, B, R, part, pairs, tickets,
                                                              norms, rows, n, cw, xvec);
  else
    residual_kernel<T, KC, false><<<grid, RES_THREADS, 0, s>>>(K, X, B, R, part, pairs, tickets,
                                                               norms, rows, n, cw, xvec);
  return static_cast<int>(cudaGetLastError());
}

// K3: one launch over (row blocks, column chunks of cw columns)
template <typename T>
int launch_residual(const void* K_, const void* X_, const void* B_, void* R_, void* part,
                    void* pairs, void* tickets, void* norms, long long rows, long long n, int k,
                    long long cw, void* stream) {
  if (rows <= 0 || n <= 0 || k < 1 || k > RES_MAX_K || cw <= 0 || cw % RES_STEP ||
      residual_row_blocks(rows) > 0x7fffffffLL || (n + cw - 1) / cw > 65535 || !K_ || !X_ ||
      !B_ || !R_ || !part || !pairs || !tickets || !norms)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* K = static_cast<const T*>(K_);
  const T* X = static_cast<const T*>(X_);
  const T* B = static_cast<const T*>(B_);
  T* R = static_cast<T*>(R_);
  double* pt = static_cast<double*>(part);
  double* pp = static_cast<double*>(pairs);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  double* nr = static_cast<double*>(norms);
  const dim3 grid(static_cast<unsigned>(residual_row_blocks(rows)),
                  static_cast<unsigned>((n + cw - 1) / cw));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads of K: every row 16-byte aligned; of X: X 16-byte aligned
  constexpr long long W = 16 / sizeof(T);
  const bool vec = n % W == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0;
  const bool xvec = reinterpret_cast<uintptr_t>(X) % 16 == 0;
  switch (k) {
    case 1: return launch_residual_k<T, 1>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 2: return launch_residual_k<T, 2>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 3: return launch_residual_k<T, 3>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 4: return launch_residual_k<T, 4>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 5: return launch_residual_k<T, 5>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 6: return launch_residual_k<T, 6>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    case 7: return launch_residual_k<T, 7>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
    default: return launch_residual_k<T, 8>(K, X, B, R, pt, pp, tk, nr, rows, n, cw, grid, vec, xvec, s);
  }
}

// ---------------------------------------------------------------- K10m
constexpr int FF_WARPS = 8;                      // warps a block
constexpr int FF_ROWS = 4;                       // rows a warp
constexpr int FF_BLOCK_ROWS = FF_WARPS * FF_ROWS;
constexpr int FF_THREADS = 32 * FF_WARPS;
constexpr int FF_STEP = 128;                     // columns a warp step: 4 a lane

// a lane's 4 consecutive columns c .. c + 3 of FF_ROWS rows of the pair,
// 16-byte streaming loads (VEC: rows 16-byte aligned, c + 3 < n), else
// 4-byte ones with the columns past n read as zeros
template <bool VEC>
__device__ __forceinline__ void ff_load(const float* __restrict__ hi, const float* __restrict__ lo,
                                        const long long (&row)[FF_ROWS], long long c, long long n,
                                        float4 (&h)[FF_ROWS], float4 (&l)[FF_ROWS]) {
#pragma unroll
  for (int r = 0; r < FF_ROWS; ++r) {
    if (VEC) {
      h[r] = __ldcs(reinterpret_cast<const float4*>(hi + row[r] + c));
      l[r] = __ldcs(reinterpret_cast<const float4*>(lo + row[r] + c));
    } else {
      const float* ph = hi + row[r] + c;
      const float* pl = lo + row[r] + c;
      h[r] = make_float4(__ldcs(ph), c + 1 < n ? __ldcs(ph + 1) : 0.f,
                         c + 2 < n ? __ldcs(ph + 2) : 0.f, c + 3 < n ? __ldcs(ph + 3) : 0.f);
      l[r] = make_float4(__ldcs(pl), c + 1 < n ? __ldcs(pl + 1) : 0.f,
                         c + 2 < n ? __ldcs(pl + 2) : 0.f, c + 3 < n ? __ldcs(pl + 3) : 0.f);
    }
  }
}

// R = B - (hi + lo) X and the block's (sum R^2, sum B^2), X, B, R (n, KC)
// row-major f64.  A warp owns FF_ROWS rows; lane t reads the columns
// 128 s + 4 t .. 128 s + 4 t + 3 of each at step s, the next step's loads
// issued before this step's products; X comes through the read-only path
// (a lane's 4 rows of X are 4 KC consecutive doubles).  No barrier before
// the epilogue.  Each sum runs in one fixed order: a lane's columns in
// order, then a butterfly over the lanes, then the block's warps in order
// (per-block partials; a second launch sums the blocks in a fixed order),
// whatever the path (VEC or not): bitwise reproducible.
template <int KC, bool VEC>
__global__ void __launch_bounds__(FF_THREADS, KC <= 4 ? 2 : 1)
ff_residual_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                   const double* __restrict__ X, const double* __restrict__ B,
                   double* __restrict__ R, double* __restrict__ partial, long long n) {
  __shared__ double wsum[FF_WARPS][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (static_cast<long long>(blockIdx.x) * FF_WARPS + warp) * FF_ROWS;
  long long row[FF_ROWS];  // row offsets; rows past n read row n - 1, their sums dropped
#pragma unroll
  for (int r = 0; r < FF_ROWS; ++r) row[r] = (r0 + r < n ? r0 + r : n - 1) * n;
  double acc[FF_ROWS][KC];
#pragma unroll
  for (int r = 0; r < FF_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = 0.0;

  long long c = 4 * lane;
  float4 h[FF_ROWS], l[FF_ROWS];
  if (c < n) ff_load<VEC>(hi, lo, row, c, n, h, l);
  while (c < n) {
    const long long cn = c + FF_STEP;
    float4 hn[FF_ROWS], ln[FF_ROWS];
    if (cn < n) ff_load<VEC>(hi, lo, row, cn, n, hn, ln);
    double x[4][KC];
    if (VEC) {
      const double2* xv = reinterpret_cast<const double2*>(X + c * KC);
#pragma unroll
      for (int q = 0; q < 2 * KC; ++q) {
        const double2 v = __ldg(xv + q);
        x[(2 * q) / KC][(2 * q) % KC] = v.x;
        x[(2 * q + 1) / KC][(2 * q + 1) % KC] = v.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < KC; ++q) x[e][q] = c + e < n ? __ldg(X + (c + e) * KC + q) : 0.0;
    }
#pragma unroll
    for (int r = 0; r < FF_ROWS; ++r) {
      const double kv[4] = {static_cast<double>(h[r].x) + static_cast<double>(l[r].x),
                            static_cast<double>(h[r].y) + static_cast<double>(l[r].y),
                            static_cast<double>(h[r].z) + static_cast<double>(l[r].z),
                            static_cast<double>(h[r].w) + static_cast<double>(l[r].w)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < KC; ++q) acc[r][q] = fma(kv[e], x[e][q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < FF_ROWS; ++r) {
      h[r] = hn[r];
      l[r] = ln[r];
    }
    c = cn;
  }

  double rr = 0.0, bb = 0.0;
#pragma unroll
  for (int r = 0; r < FF_ROWS; ++r)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      double v = acc[r][q];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0 && r0 + r < n) {
        const long long t = (r0 + r) * KC + q;
        const double b = B[t];
        const double rv = b - v;
        R[t] = rv;
        rr += rv * rv;
        bb += b * b;
      }
    }
  if (lane == 0) {
    wsum[warp][0] = rr;
    wsum[warp][1] = bb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < FF_WARPS; ++w) {
      a += wsum[w][0];
      b += wsum[w][1];
    }
    partial[2 * blockIdx.x] = a;
    partial[2 * blockIdx.x + 1] = b;
  }
}

long long ff_residual_blocks(long long n) { return (n + FF_BLOCK_ROWS - 1) / FF_BLOCK_ROWS; }

template <int KC>
int launch_ff_residual_k(const float* hi, const float* lo, const double* X, const double* B,
                         double* R, double* partial, long long n, bool vec, cudaStream_t s) {
  const unsigned nb = static_cast<unsigned>(ff_residual_blocks(n));
  if (vec)
    ff_residual_kernel<KC, true><<<nb, FF_THREADS, 0, s>>>(hi, lo, X, B, R, partial, n);
  else
    ff_residual_kernel<KC, false><<<nb, FF_THREADS, 0, s>>>(hi, lo, X, B, R, partial, n);
  return static_cast<int>(cudaGetLastError());
}

// K10m: R = B - (hi + lo) X and (sum R^2, sum B^2), two launches
int launch_ff_residual(const void* hi_, const void* lo_, const void* X_, const void* B_, void* R_,
                       void* partial, void* norms, long long n, int k, void* stream) {
  if (n <= 0 || k < 1 || k > RES_MAX_K || ff_residual_blocks(n) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* hi = static_cast<const float*>(hi_);
  const float* lo = static_cast<const float*>(lo_);
  const double* X = static_cast<const double*>(X_);
  const double* B = static_cast<const double*>(B_);
  double* R = static_cast<double*>(R_);
  double* part = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads: every row of the pair 16-byte aligned, X too (a lane's 4
  // rows of X start at a multiple of 32 k bytes)
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(hi) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0;
  int err;
  switch (k) {
    case 1: err = launch_ff_residual_k<1>(hi, lo, X, B, R, part, n, vec, s); break;
    case 2: err = launch_ff_residual_k<2>(hi, lo, X, B, R, part, n, vec, s); break;
    case 3: err = launch_ff_residual_k<3>(hi, lo, X, B, R, part, n, vec, s); break;
    case 4: err = launch_ff_residual_k<4>(hi, lo, X, B, R, part, n, vec, s); break;
    case 5: err = launch_ff_residual_k<5>(hi, lo, X, B, R, part, n, vec, s); break;
    case 6: err = launch_ff_residual_k<6>(hi, lo, X, B, R, part, n, vec, s); break;
    case 7: err = launch_ff_residual_k<7>(hi, lo, X, B, R, part, n, vec, s); break;
    default: err = launch_ff_residual_k<8>(hi, lo, X, B, R, part, n, vec, s); break;
  }
  if (err) return err;
  reduce_pairs_kernel<<<1, RED_THREADS, 0, s>>>(part, ff_residual_blocks(n),
                                                static_cast<double*>(norms));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K5
constexpr int TI_MAX_BASE = 128;
constexpr int TI_LEAF = 8;     // leaves inverted by substitution
constexpr int TI_WARPS = 8;
constexpr int TI_THREADS = 32 * TI_WARPS;

// the working size: the smallest TI_LEAF * 2^m >= base (ops/mixed.py tri_inv_size)
int tri_inv_size(int base) {
  int p = TI_LEAF;
  while (p < base) p <<= 1;
  return p;
}

// The TI_LEAF-wide diagonal leaves of the (P, P) block in shared memory (row
// stride ld), inverted in place: thread t takes column t % TI_LEAF of leaf
// t / TI_LEAF and substitutes down it, X[c][c] = 1 / A[c][c], X[i][c] =
// -(sum_{k < i} A[i][k] X[k][c]) / A[i][i] (X[k][c] = 0 for k < c), in
// registers; written after the block's barrier.
__device__ __forceinline__ void ti_leaves(float* A, int P, int ld) {
  const int t = threadIdx.x;
  const bool active = t < P;
  const int o = t - t % TI_LEAF, c = t % TI_LEAF;
  float x[TI_LEAF];
  if (active) {
    const float* a = A + o * ld + o;
#pragma unroll
    for (int i = 0; i < TI_LEAF; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) s = fmaf(a[i * ld + k], x[k], s);
      const float d = a[i * ld + i];
      x[i] = i < c ? 0.0f : i == c ? 1.0f / d : -s / d;
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < TI_LEAF; ++i) A[(o + i) * ld + o + c] = x[i];
  }
  __syncthreads();
}

// TC consecutive floats of shared memory (16-, 8- or 4-byte aligned)
template <int TC>
__device__ __forceinline__ void ti_row(const float* p, float (&r)[TC]) {
  if constexpr (TC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (TC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

// acc = Lm Rm over S-deep sums in order, Lm at a, Rm at b (row stride ld, a
// multiple of 4; a and b 16-byte aligned), a thread's TR x TC outputs at
// rows rt TR + u, columns ct TC + v: each step of 4 k reads 4 consecutive
// k of each of its rows of Lm (16-byte loads) and TC consecutive columns of
// 4 rows of Rm.  (The zeros of the triangular factors are multiplied as
// they are: a warp spans all the columns and two row groups, so skipping
// them would not shorten any warp's chain.)
template <int S, int TR, int TC>
__device__ __forceinline__ void ti_product(const float* a, const float* b, int ld, int rt,
                                           int ct, float (&acc)[TR][TC]) {
#pragma unroll
  for (int u = 0; u < TR; ++u)
#pragma unroll
    for (int v = 0; v < TC; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < S; k += 4) {
    float l[TR][4];
#pragma unroll
    for (int u = 0; u < TR; ++u) ti_row<4>(a + (rt * TR + u) * ld + k, l[u]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float r[TC];
      ti_row<TC>(b + (k + kk) * ld + ct * TC, r);
#pragma unroll
      for (int u = 0; u < TR; ++u)
#pragma unroll
        for (int v = 0; v < TC; ++v) acc[u][v] = fmaf(l[u][kk], r[v], acc[u][v]);
    }
  }
}

// One doubling level: each pair of inverted S-blocks [[X11, 0], [A21, X22]]
// on the diagonal becomes the inverse of its 2S-block, in place: T = A21 X11,
// then X21 = -(X22 T), each product summed over k in order in registers,
// written over A21 after a barrier.  P / (2 S) pairs, S^2 / (TR TC) threads
// a pair: with P = TI_MAX_BASE all TI_THREADS threads at every level.
template <int S, int TR, int TC>
__device__ __forceinline__ void ti_level(float* A, int P, int ld) {
  constexpr int RT = S / TR, CT = S / TC, PER_PAIR = RT * CT;
  static_assert(TI_MAX_BASE / (2 * S) * PER_PAIR == TI_THREADS, "one tile a thread");
  const int t = threadIdx.x;
  const bool active = t < P / (2 * S) * PER_PAIR;
  const int o = (t / PER_PAIR) * 2 * S;
  const int rt = t % PER_PAIR / CT, ct = t % CT;
  float* a21 = A + (o + S) * ld + o;
  float acc[TR][TC];
  if (active) ti_product<S, TR, TC>(a21, A + o * ld + o, ld, rt, ct, acc);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int u = 0; u < TR; ++u)
#pragma unroll
      for (int v = 0; v < TC; ++v) a21[(rt * TR + u) * ld + ct * TC + v] = acc[u][v];
  }
  __syncthreads();
  if (active) ti_product<S, TR, TC>(a21 + S, a21, ld, rt, ct, acc);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int u = 0; u < TR; ++u)
#pragma unroll
      for (int v = 0; v < TC; ++v) a21[(rt * TR + u) * ld + ct * TC + v] = -acc[u][v];
  }
  __syncthreads();
}

// One thread block a diagonal block: its lower triangle (identity past the
// matrix, and up to the working size P) into shared memory, the leaves,
// the levels up to P, then its base x base corner out, zeros above the
// diagonal.
__global__ void __launch_bounds__(TI_THREADS)
diag_block_inv_kernel(const float* __restrict__ L, float* __restrict__ out, long long n,
                      int base, int P) {
  extern __shared__ __align__(16) float A[];
  // row stride: a multiple of 4 (16-byte rows), 4 banks apart, so that the
  // rows a warp reads at one k do not share banks
  const int ld = P + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * base;
  const int bsz = static_cast<int>(n - r0 < base ? n - r0 : base);
  // the lower triangle by cp.async, all of a thread's copies in flight at
  // once: 16 bytes where 4 columns lie on or below the diagonal and the
  // rows are 16-byte aligned (vec), else 4 a copy; the rest (the upper
  // triangle, the identity past the matrix) stored
  const bool vec = n % 4 == 0 && base % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  for (int i = warp; i < P; i += TI_WARPS)
    for (int j = 4 * lane; j < P; j += 128) {
      float* dst = A + i * ld + j;
      const float* src = L + (r0 + i) * n + r0 + j;
      if (vec && j + 3 <= i && i < bsz) {
        syrk::cp_async<16>(dst, src, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e <= i && i < bsz)
            syrk::cp_async<4>(dst + e, src + e, true);
          else
            dst[e] = j + e == i ? 1.0f : 0.0f;
        }
      }
    }
  syrk::cp_commit();
  syrk::cp_wait<0>();
  __syncthreads();
  ti_leaves(A, P, ld);
  if (P > 8) ti_level<8, 2, 1>(A, P, ld);
  if (P > 16) ti_level<16, 2, 2>(A, P, ld);
  if (P > 32) ti_level<32, 4, 2>(A, P, ld);
  if (P > 64) ti_level<64, 4, 4>(A, P, ld);
  float* o = out + static_cast<long long>(blockIdx.x) * base * base;
  if (base % 4 == 0) {  // 16-byte rows in and out
    for (int i = warp; i < base; i += TI_WARPS)
      for (int j = 4 * lane; j < base; j += 128) {
        float4 v = *reinterpret_cast<const float4*>(A + i * ld + j);
        if (j + 3 > i) {
          v.w = 0.0f;
          if (j + 2 > i) v.z = 0.0f;
          if (j + 1 > i) v.y = 0.0f;
          if (j > i) v.x = 0.0f;
        }
        *reinterpret_cast<float4*>(o + i * base + j) = v;
      }
  } else {
    for (int i = warp; i < base; i += TI_WARPS)
      for (int j = lane; j < base; j += 32) o[i * base + j] = j > i ? 0.0f : A[i * ld + j];
  }
}

int launch_diag_block_inv(const void* L, void* out, long long n, int base, void* stream) {
  if (n <= 0 || base < 1 || base > TI_MAX_BASE || !L || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + base - 1) / base;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int P = tri_inv_size(base);
  const int smem = P * (P + 4) * static_cast<int>(sizeof(float));
  // the largest block's shared memory, above the 48 KB default: set once
  // per device (a bit of ti_smem_set per device), not on every launch
  static std::atomic<unsigned long long> ti_smem_set{0};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ti_smem_set.load(std::memory_order_relaxed) & bit)) {
    err = static_cast<int>(cudaFuncSetAttribute(
        diag_block_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TI_MAX_BASE * (TI_MAX_BASE + 4) * static_cast<int>(sizeof(float))));
    if (err) return err;
    ti_smem_set.fetch_or(bit, std::memory_order_relaxed);
  }
  diag_block_inv_kernel<<<static_cast<unsigned>(nb), TI_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<float*>(out), n, base, P);
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
constexpr int PA_MAX_K = 8;
constexpr int PA_ROWS = 4;                 // rows a warp (pass 1), a warp step (pass 2)
constexpr int PA_STEP = 128;               // columns a warp covers: 4 a lane
constexpr int PA_WARPS = 8;                // warps a block (pass 1: at most)
constexpr int PA_THREADS = 32 * PA_WARPS;
constexpr int PA_BAND = PA_STEP;           // pass 2: columns a block
constexpr long long PA_MAX_HEIGHT = 1024;  // pass 2: rows a chunk at most
static_assert(PA_MAX_HEIGHT <= PA_WARPS * PA_STEP, "a chunk's y fits the warps' sums' space");

// rows c .. c + 3 of r (n, KC) row-major as f32 (r32), past n zeros; a
// lane's 4 KC consecutive entries in 16-byte loads where r is 16-byte
// aligned and all 4 rows lie inside (c is a multiple of 4); read-only path
template <typename T, int KC>
__device__ __forceinline__ void load_r32(const T* __restrict__ r, long long c, long long n,
                                         bool rvec, float (&x)[4][KC]) {
  if (rvec && c + 3 < n) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
    const T* base = r + c * KC;
#pragma unroll
    for (int q = 0; q < 4 * KC / PER; ++q) {
      if constexpr (sizeof(T) == 8) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(base) + q);
        x[(2 * q) / KC][(2 * q) % KC] = static_cast<float>(v.x);
        x[(2 * q + 1) / KC][(2 * q + 1) % KC] = static_cast<float>(v.y);
      } else {
        const float4 v = __ldg(reinterpret_cast<const float4*>(base) + q);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) x[(4 * q + u) / KC][(4 * q + u) % KC] = e[u];
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < KC; ++q)
        x[e][q] = c + e < n ? static_cast<float>(__ldg(r + (c + e) * KC + q)) : 0.0f;
  }
}

// a lane's entries c .. c + 3 of one row of M (p = the row's column c),
// those past the row's last column ``last`` (its global row: the triangle)
// read as zeros; 16-byte streaming loads (VEC: rows 16-byte aligned, n %
// 4 == 0, so c <= last < n keeps c + 3 < n), else 4-byte ones
template <bool VEC>
__device__ __forceinline__ float4 load_m(const float* __restrict__ p, long long c,
                                         long long last) {
  if (c > last) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    if (c + 3 > last) {
      v.w = 0.f;
      if (c + 2 > last) v.z = 0.f;
      if (c + 1 > last) v.y = 0.f;
    }
    return v;
  }
  return make_float4(__ldcs(p), c + 1 <= last ? __ldcs(p + 1) : 0.f,
                     c + 2 <= last ? __ldcs(p + 2) : 0.f, c + 3 <= last ? __ldcs(p + 3) : 0.f);
}

// Pass 1, y = M r32 over the lower triangle: y_i = sum_{j <= off + i} M_ij
// f32(r_j) in f32, M the rows [off, off + rows) of the (n, n) M (the square
// M: rows = n, off = 0).  K10m's geometry: a warp owns PA_ROWS rows, lane t
// reads the columns 128 s + 4 t .. + 3 of each at step s in 16-byte
// streaming loads, the next step's loads issued before this step's
// products; r32 through the read-only path, shared by the warp's rows; no
// shared memory and no barrier.  blockDim.x / 32 warps a block; the block
// of the longest rows first.  Sums: a lane's columns in order, then a
// butterfly over the lanes (bitwise reproducible).  k > 4: registers
// capped for two blocks an SM (2.6 against 3.3 ms at n = 32768, k = 8, on
// the H100).
template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(PA_THREADS, KC <= 4 ? 1 : 2)
precond_rows_kernel(const float* __restrict__ M, const T* __restrict__ r, float* __restrict__ y,
                    long long rows, long long n, long long off, bool rvec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rb = gridDim.x - 1 - blockIdx.x;
  const long long r0 = (rb * (blockDim.x >> 5) + warp) * PA_ROWS;
  if (r0 >= rows) return;
  const float* row[PA_ROWS];
  long long last[PA_ROWS];  // a row's last column; rows past the slab have none
#pragma unroll
  for (int u = 0; u < PA_ROWS; ++u) {
    row[u] = M + (r0 + u < rows ? r0 + u : rows - 1) * n;
    last[u] = r0 + u < rows ? off + r0 + u : -1;
  }
  const long long cend = off + (r0 + PA_ROWS < rows ? r0 + PA_ROWS : rows) - 1;
  float acc[PA_ROWS][KC];
#pragma unroll
  for (int u = 0; u < PA_ROWS; ++u)
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[u][q] = 0.0f;

  long long c = 4 * lane;
  float4 h[PA_ROWS];
  if (c <= cend) {
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) h[u] = load_m<VEC>(row[u] + c, c, last[u]);
  }
  while (c <= cend) {
    const long long cn = c + PA_STEP;
    float4 hn[PA_ROWS];
    if (cn <= cend) {
#pragma unroll
      for (int u = 0; u < PA_ROWS; ++u) hn[u] = load_m<VEC>(row[u] + cn, cn, last[u]);
    }
    float x[4][KC];
    load_r32<T, KC>(r, c, n, rvec, x);
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) {
      const float m[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < KC; ++q) acc[u][q] = fmaf(m[e], x[e][q], acc[u][q]);
    }
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) h[u] = hn[u];
    c = cn;
  }
#pragma unroll
  for (int u = 0; u < PA_ROWS; ++u)
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float v = acc[u][q];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0 && r0 + u < rows) y[(r0 + u) * KC + q] = v;
    }
}

// Pass 2, out = M^T y, and its chunk sum.  Block (band, chunk) owns the
// columns [128 band, + 128) and the slab rows [chunk h, (chunk + 1) h),
// from the band's first row of the triangle on (the rows above it, and the
// chunks wholly above it, are skipped: those chunks' blocks return at
// once).  The chunk's rows of y go to shared memory first (one barrier
// before the rows, none in them).  Lane t reads 16 bytes, the columns
// 128 band + 4 t .. + 3, of a row; warp w takes the rows rbeg + 4 w + u +
// 32 s, the next step's loads issued before this step's products;
// a lane sums 4 columns x KC over its rows in order.  The block's warps are
// summed in order through shared memory; a band with one nonempty chunk
// writes out there, else the chunk's partial sums go to part[chunk, j, q]
// and the last of the band's nonempty blocks to finish (a ticket after a
// fence) sums them in chunk order, writes out in Tout and resets the
// ticket.  Bands no slab row reaches (columns past off + rows - 1) get
// zeros from their chunk-0 block.  Bitwise reproducible.
template <typename Tout, int KC, bool VEC>
__global__ void __launch_bounds__(PA_THREADS)
precond_cols_kernel(const float* __restrict__ M, const float* __restrict__ y,
                    float* __restrict__ part, unsigned int* __restrict__ tickets,
                    Tout* __restrict__ out, long long rows, long long n, long long off,
                    long long height) {
  constexpr int BR = PA_WARPS * PA_ROWS;  // rows a block step
  // the chunk's rows of y, then the block's warps' sums
  __shared__ float sm[PA_WARPS * PA_STEP * KC];
  __shared__ int last_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long band = blockIdx.x, ch = blockIdx.y, chunks = gridDim.y;
  const long long j0 = band * PA_BAND;
  const long long rstar = j0 - off;  // the slab row of global row j0: the band's first
  if (rstar >= rows) {
    if (ch == 0) {
      for (int t = tid; t < PA_BAND * KC; t += PA_THREADS)
        if (j0 + t / KC < n) out[j0 * KC + t] = Tout(0);
    }
    return;
  }
  const long long ch0 = rstar > 0 ? rstar / height : 0;  // the band's first nonempty chunk
  if (ch < ch0) return;
  const long long rbeg = ch * height > rstar ? ch * height : rstar;
  const long long rend = (ch + 1) * height < rows ? (ch + 1) * height : rows;
  for (long long t = tid; t < (rend - rbeg) * KC; t += PA_THREADS)
    sm[t] = __ldg(y + rbeg * KC + t);
  __syncthreads();
  const long long c = j0 + 4 * lane;
  float acc[4][KC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[e][q] = 0.0f;
  auto load = [&](long long i0, float4 (&hh)[PA_ROWS]) {
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) {
      const long long ii = i0 + u;
      hh[u] = ii < rend ? load_m<VEC>(M + ii * n + c, c, off + ii)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  long long i = rbeg + PA_ROWS * warp;
  float4 h[PA_ROWS];
  load(i, h);
  while (i < rend) {
    float4 hn[PA_ROWS];
    load(i + BR, hn);
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) {
      const float m[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
      const bool in = i + u < rend;
      const float* yr = sm + (i + u - rbeg) * KC;
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        const float yq = in ? yr[q] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e][q] = fmaf(m[e], yq, acc[e][q]);
      }
    }
#pragma unroll
    for (int u = 0; u < PA_ROWS; ++u) h[u] = hn[u];
    i += BR;
  }
  __syncthreads();  // y is no longer read: sm takes the warps' sums
  float* red = sm + warp * PA_STEP * KC;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int q = 0; q < KC; ++q) red[(4 * lane + e) * KC + q] = acc[e][q];
  __syncthreads();
  // entry t of the band: column j0 + t / KC, right-hand side t % KC
  const long long nonempty = chunks - ch0;
  for (int t = tid; t < PA_BAND * KC; t += PA_THREADS) {
    if (j0 + t / KC >= n) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) v += sm[w * PA_STEP * KC + t];
    if (nonempty == 1) out[j0 * KC + t] = static_cast<Tout>(v);
    else part[(ch * n + j0) * KC + t] = v;
  }
  if (nonempty == 1) return;
  __threadfence();  // the partials are visible before the ticket counts them
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + band, 1u) == nonempty - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int t = tid; t < PA_BAND * KC; t += PA_THREADS) {
    if (j0 + t / KC >= n) continue;
    float v = 0.0f;
#pragma unroll 8
    for (long long k = ch0; k < chunks; ++k) v += __ldcg(part + (k * n + j0) * KC + t);
    out[j0 * KC + t] = static_cast<Tout>(v);
  }
  if (tid == 0) tickets[band] = 0u;
}

template <typename T, typename Tout, int KC>
int launch_precond_k(const float* M, const T* r, float* y, float* part, unsigned int* tickets,
                     Tout* out, long long rows, long long n, long long off, int warps,
                     long long height, bool vec, bool rvec, cudaStream_t s) {
  const long long row_warps = (rows + PA_ROWS - 1) / PA_ROWS;
  const unsigned row_blocks = static_cast<unsigned>((row_warps + warps - 1) / warps);
  if (vec)
    precond_rows_kernel<T, KC, true><<<row_blocks, 32 * warps, 0, s>>>(M, r, y, rows, n, off,
                                                                        rvec);
  else
    precond_rows_kernel<T, KC, false><<<row_blocks, 32 * warps, 0, s>>>(M, r, y, rows, n, off,
                                                                         rvec);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((n + PA_BAND - 1) / PA_BAND),
                  static_cast<unsigned>((rows + height - 1) / height));
  if (vec)
    precond_cols_kernel<Tout, KC, true><<<grid, PA_THREADS, 0, s>>>(M, y, part, tickets, out,
                                                                    rows, n, off, height);
  else
    precond_cols_kernel<Tout, KC, false><<<grid, PA_THREADS, 0, s>>>(M, y, part, tickets, out,
                                                                     rows, n, off, height);
  return static_cast<int>(cudaGetLastError());
}

// M^T (M r32) for M the rows [off, off + rows) of an (n, n) lower-triangular
// f32 M (rows = n, off = 0: the whole product); r (n, k) in T; out (n, k) in
// Tout: the whole M^T M r, or a rank's part of it, summed over the ranks by
// the caller.  Two launches; the geometry (pass 1's warps a block, pass
// 2's chunk height) is ops/mixed.py precond_plan's; y (rows, k) f32, part
// (chunks, n, k) f32 and tickets (one a band, zero between launches) are
// the caller's workspace.
template <typename T, typename Tout>
int launch_precond_apply(const void* M_, const void* r_, void* y, void* part, void* tickets,
                         void* out, long long rows, long long n, long long off, int k,
                         int warps, long long height, void* stream) {
  const long long chunks = height > 0 ? (rows + height - 1) / height : 0;
  if (rows <= 0 || n <= 0 || off < 0 || off + rows > n || k < 1 || k > PA_MAX_K ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8) || height <= 0 ||
      height % PA_ROWS || height > PA_MAX_HEIGHT || chunks > 65535 ||
      (n + PA_BAND - 1) / PA_BAND > 0x7fffffffLL || (rows + PA_ROWS - 1) / PA_ROWS > 0x7fffffffLL ||
      !M_ || !r_ || !y || !part || !tickets || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* M = static_cast<const float*>(M_);
  const T* r = static_cast<const T*>(r_);
  float* yy = static_cast<float*>(y);
  float* pp = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  Tout* o = static_cast<Tout*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads of M: every row 16-byte aligned; of r: r 16-byte aligned
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(M) % 16 == 0;
  const bool rvec = reinterpret_cast<uintptr_t>(r) % 16 == 0;
#define PA_CASE(KC)                                                                        \
  case KC:                                                                                 \
    return launch_precond_k<T, Tout, KC>(M, r, yy, pp, tk, o, rows, n, off, warps, height, \
                                         vec, rvec, s);
  switch (k) {
    PA_CASE(1) PA_CASE(2) PA_CASE(3) PA_CASE(4) PA_CASE(5) PA_CASE(6) PA_CASE(7)
    default: return launch_precond_k<T, Tout, 8>(M, r, yy, pp, tk, o, rows, n, off, warps,
                                                 height, vec, rvec, s);
  }
#undef PA_CASE
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

// K3's geometry: the rows a block, the columns a warp step (ops/mixed.py
// checks them)
int gpmp_residual_geometry(int what) {
  switch (what) {
    case 0: return RES_BLOCK_ROWS;
    case 1: return RES_STEP;
    default: return -1;
  }
}

int gpmp_residual_f64(const void* K, const void* X, const void* B, void* R, void* part,
                      void* pairs, void* tickets, void* norms, long long rows, long long n, int k,
                      long long cw, void* stream) {
  return launch_residual<double>(K, X, B, R, part, pairs, tickets, norms, rows, n, k, cw, stream);
}

int gpmp_residual_f32(const void* K, const void* X, const void* B, void* R, void* part,
                      void* pairs, void* tickets, void* norms, long long rows, long long n, int k,
                      long long cw, void* stream) {
  return launch_residual<float>(K, X, B, R, part, pairs, tickets, norms, rows, n, k, cw, stream);
}

long long gpmp_ff_residual_blocks(long long n) { return ff_residual_blocks(n); }

int gpmp_ff_residual(const void* hi, const void* lo, const void* X, const void* B, void* R,
                     void* partial, void* norms, long long n, int k, void* stream) {
  return launch_ff_residual(hi, lo, X, B, R, partial, norms, n, k, stream);
}

// K6's geometry: rows a warp (step), columns a band, warps a pass-2 block,
// rows a pass-2 chunk at most
// (ops/mixed.py checks them)
int gpmp_precond_geometry(int what) {
  switch (what) {
    case 0: return PA_ROWS;
    case 1: return PA_BAND;
    case 2: return PA_WARPS;
    case 3: return static_cast<int>(PA_MAX_HEIGHT);
    default: return -1;
  }
}

int gpmp_precond_apply_f64(const void* M, const void* r, void* y, void* part, void* tickets,
                           void* out, long long n, int k, int warps, long long height,
                           void* stream) {
  return launch_precond_apply<double, double>(M, r, y, part, tickets, out, n, n, 0, k, warps,
                                              height, stream);
}

int gpmp_precond_apply_f32(const void* M, const void* r, void* y, void* part, void* tickets,
                           void* out, long long n, int k, int warps, long long height,
                           void* stream) {
  return launch_precond_apply<float, float>(M, r, y, part, tickets, out, n, n, 0, k, warps,
                                            height, stream);
}

// a rank's part of M^T (M r32), f32, from its row slab of M and all of r
int gpmp_precond_apply_slab_f64(const void* M, const void* r, void* y, void* part,
                                void* tickets, void* out, long long rows, long long n,
                                long long off, int k, int warps, long long height,
                                void* stream) {
  return launch_precond_apply<double, float>(M, r, y, part, tickets, out, rows, n, off, k,
                                             warps, height, stream);
}

int gpmp_precond_apply_slab_f32(const void* M, const void* r, void* y, void* part,
                                void* tickets, void* out, long long rows, long long n,
                                long long off, int k, int warps, long long height,
                                void* stream) {
  return launch_precond_apply<float, float>(M, r, y, part, tickets, out, rows, n, off, k,
                                            warps, height, stream);
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
