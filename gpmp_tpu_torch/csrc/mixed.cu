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
#include <stdint.h>

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
