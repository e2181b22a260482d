// gpmp_tpu_torch/csrc/chol.cu
//
// K8r, K8t and K9m (square and slab forms): the hand-written kernels of the
// blocked Cholesky with refined panels (gpmp_tpu_torch/parallel/chol.py;
// wrappers in gpmp_tpu_torch/ops/refine.py and gpmp_tpu_torch/ops/chol.py)
// for Hopper, sm_90a.  Plain C entry points, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.  The path's other kernels, K9u (the
// trailing update) and K9s (its slab form), are csrc/syrk.cu's.
//
// K8t triangular product (replaces the products of gpmp_tpu/ops/refine.py
//    newton_tri_inv, M (2I - L M), and the Ogita-Aishima update of
//    refined_cholesky, L + L Phi(X)):
//      C = beta A + alpha tril(A) f(B) on the lower triangle, A and B
//      (b, b) f64, f(B) = tril(B), or Phi(B) = tril(B) with its diagonal
//      halved, the upper triangle of C written as exact zeros; b is any size
//      >= 1 (the last panel of a factor is ragged).  The Newton step is two
//      launches, P = L M (beta 0) then M' = 2 M - M P (beta 2, alpha -1); the
//      update one, L' = L + L Phi(X) (beta 1, alpha 1).  A product of lower
//      triangular matrices is exactly lower triangular, so only the lower
//      tiles are computed, each over k in [j0, min(i0 + 32, b)).
//    Bound: b^3/6 f64 FMAs (2.2e7 at b = 512: 0.67 us at the 67 TFLOP/s f64
//    tensor peak) against reading A's and B's lower triangles and writing
//    C (4.2 MB, 1.3 us): bytes on paper; in practice the longest tile's
//    chain of dependent k steps (the corner tile sums all b columns).  It
//    replaces a CUDA-core kernel that launched all (b/32)^2 tiles, walked
//    each tile's k range in 32-wide steps, load, synchronise, FMA, in one
//    chain, and took 31 us of device time at b = 512 (24x the bound).
//    Design:
//    - a launch plan built by the wrapper (gpmp_tpu_torch/ops/refine.py
//      tri_product_plan, cached per device and b): one block per lower
//      32 x 32 tile (136 at b = 512, about one wave of 132 SMs), longest k
//      range first; each lower block also writes the zeros of its mirror
//      tile, the diagonal blocks their strict upper parts;
//    - the tile's k range cut into TRI_WARPS = 8 contiguous chunks, one a
//      warp, at multiples of 8 columns (the plan's k_0 .. k_8): the corner
//      tile's 512 columns are 8 steps a warp;
//    - f64 tensor cores: each warp holds the whole 32 x 32 tile as 2 x 4
//      m16n8k8 fragments (csrc/syrk_f64.cuh's Mma<8>), one mma step per 8
//      k columns;
//    - each warp stages its chunk through its own 4-stage cp.async ring
//      (syrk_f64.cuh's cp_async; 16-byte copies when b is even and the
//      operands 16-byte aligned, else 8-byte ones; zero-fill past the
//      chunk and the ragged edge), synchronised by the warp alone: A as 32
//      rows of 8 columns (rows padded to 12 doubles), B k-major as 8 rows
//      of 32 columns (padded to 36), so that the lanes' 8-byte fragment
//      reads hit 16 distinct bank pairs in each half warp;
//    - the masks (A lower, k <= i; f(B) lower, k >= j; Phi's halved
//      diagonal) are applied as the fragments form, on the k steps that
//      meet the tile's row or column range only;
//    - the partial tiles are summed through shared memory in warp order,
//      (((P0 + P1) + P2) + ..) + P7: fixed and reproducible, no atomics;
//      the epilogue writes beta A + alpha C on i >= j (beta = 0 reads no
//      A), a warp on a row.
//    Measured on the card against 4 warps a tile (two blocks an SM), 4
//    warps with 16-column or 6-deep stages, 8 warps with 2- or 3-deep rings
//    or 16-column stages, and 16 warps: 8 warps with 8-column stages 4
//    deep took the least device time at b = 512 and 256 (PERF.md §6).
//
// K8r refinement residual (replaces E = A - L L^T and the convergence
//    guard's sums of gpmp_tpu/ops/refine.py refined_cholesky):
//      E = A - L L^T for one (b, b) f64 diagonal panel and its f64 lower
//      triangular factor L, computed on the lower triangle only and written
//      at (i, j) and (j, i) from one value (E exactly symmetric), and
//      [sum E^2, sum A^2] over the whole symmetric matrix, in f64, in one
//      fixed order.
//    Bound: b^3/6 f64 FMAs (0.67 us at b = 512) against reading A and L and
//    writing E (6 MB, 1.9 us at 3.35 TB/s): bytes on paper, the longest
//    tile's chain of k steps in practice, as K8t's.  It replaces the
//    CUDA-core 32 x 32 residual (8 x 32 threads, two barriers per 32-wide k
//    step, 5% of its bound at b = 512) and its second launch, a fixed-order
//    sum of the tiles' partial sums.
//    Design: K8t's geometry in NT form.
//    - One block per lower 32 x 32 tile of a plan built by the wrapper
//      (gpmp_tpu_torch/ops/refine.py refine_residual_plan, K8t's plan rows:
//      (i0, j0, k_0 .. k_8, 0)), longest k range first; a tile sums over k
//      in [0, min(j0 + 32, b)), past which L's rows j are zero, cut into 8
//      contiguous chunks of whole 8-column steps, one a warp.
//    - Each warp stages rows i0.. and j0.. of L (both by rows, 8 columns a
//      stage, rows padded to 12 doubles) through its own 4-stage cp.async
//      ring, and feeds f64 mma.sync m16n8k8 fragments from both: no mask,
//      L being exactly lower triangular.
//    - The partial tiles are summed in warp order, E = A - C goes out on
//      i >= j, a warp on a row, and into a shared tile with odd rows, from
//      which the mirror rows (j, i) are written: one value, two places.
//    - The guard's sums go into the same launch: each block sums its
//      entries' E^2 and A^2 (off the diagonal twice) over a fixed tree of
//      its 256 threads and writes its pair; the last block to finish, found
//      by an atomic ticket after a __threadfence, sums the pairs in index
//      order with csrc/mixed.cu reduce_pairs_kernel's 256-thread arithmetic
//      and resets the ticket.  Bitwise reproducible, one launch.
//    - The pairs and the ticket sit in a workspace the wrapper caches per
//      (device, b); the shared-memory attribute is set once per device.
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
// K9m is simple and right first; making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "syrk_f64.cuh"

namespace {

constexpr int CT_TILE = 32;
constexpr int CT_TY = 8;  // K9m's block (32, 8)

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device and kernel (a bit of ``done`` per device), not on every launch
template <typename F>
int smem_attribute_once(F kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (!err) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// ---------------------------------------------------------------- K8t
namespace tri {

constexpr int TILE = 32;          // output tile
constexpr int WARPS = 8;          // k chunks a tile, one a warp
constexpr int THREADS = 32 * WARPS;
constexpr int KS = 8;             // k columns a stage: one m16n8k8 step
constexpr int STAGES = 4;         // depth of a warp's ring
constexpr int LDA = KS + 4;       // staged row of A, doubles
constexpr int LDB = TILE + 4;     // staged k row of B, doubles
constexpr int STAGE = TILE * LDA + KS * LDB;  // doubles a stage: A, then B
constexpr int RING = STAGES * STAGE;          // doubles a warp
constexpr int LDP = TILE + 8;     // a partial tile's row, doubles
constexpr int PLAN = 12;          // ints a tile in the plan: i0, j0, k_0 .. k_WARPS, 0
constexpr int SMEM = WARPS * RING * static_cast<int>(sizeof(double));
static_assert(WARPS * TILE * LDP <= WARPS * RING, "the partial tiles fit in the rings");
static_assert(PLAN >= 2 + WARPS + 1, "the plan holds every chunk bound");
static_assert(SMEM <= 232448, "the rings fit in 227 KB");

// one stage: A[i0 .. i0 + 32, k0 .. k0 + 8) and B[k0 .. k0 + 8, j0 .. j0 + 32)
// into st (A rows of LDA, then B rows of LDB), CPB bytes a copy; entries at
// k >= kend or outside the (n, n) matrices are zero-filled
template <int CPB>
__device__ __forceinline__ void load_stage(double* st, const double* A, const double* B,
                                           long long n, long long i0, long long j0, long long k0,
                                           long long kend, int lane) {
  constexpr int W = CPB / 8;  // doubles a copy
  constexpr int A_ROW = KS / W, A_PER = TILE * A_ROW / 32;
  constexpr int B_ROW = TILE / W, B_PER = KS * B_ROW / 32;
#pragma unroll
  for (int q = 0; q < A_PER; ++q) {
    const int c = lane + 32 * q, r = c / A_ROW, kc = (c % A_ROW) * W;
    const long long gi = i0 + r, gk = k0 + kc;
    const bool ok = gi < n && gk < kend;
    syrk::cp_async<CPB>(st + r * LDA + kc, ok ? A + gi * n + gk : A, ok);
  }
#pragma unroll
  for (int q = 0; q < B_PER; ++q) {
    const int c = lane + 32 * q, r = c / B_ROW, cc = (c % B_ROW) * W;
    const long long gk = k0 + r, gj = j0 + cc;
    const bool ok = gk < kend && gj < n;
    syrk::cp_async<CPB>(st + TILE * LDA + r * LDB + cc, ok ? B + gk * n + gj : B, ok);
  }
}

// the warp's 2 x 4 fragments over one staged step at k0: a[2 v + h] =
// A(16 m + g + 8 h, t + 4 v), b[v] = f(B)(t + 4 v, 8 f + g), with the masks
// where the step meets the tile's rows (A: k <= i) or columns (f(B): k >= j,
// Phi's halved diagonal)
__device__ __forceinline__ void mma_stage(const double* st, double (&acc)[2][4][4], int g, int t,
                                          long long i0, long long j0, long long k0, int phi) {
  const double* sa = st;
  const double* sb = st + TILE * LDA;
  const bool mask_a = k0 + KS > i0, mask_b = k0 < j0 + TILE;
  double bf[4][2];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int kk = t + 4 * v, c = 8 * f + g;
      double x = sb[kk * LDB + c];
      if (mask_b) {
        const long long gk = k0 + kk, gj = j0 + c;
        x = gk < gj ? 0.0 : (phi && gk == gj ? 0.5 * x : x);
      }
      bf[f][v] = x;
    }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    double af[4];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h, kk = t + 4 * v;
        const double x = sa[r * LDA + kk];
        af[2 * v + h] = (mask_a && k0 + kk > i0 + r) ? 0.0 : x;
      }
#pragma unroll
    for (int f = 0; f < 4; ++f) syrk::Mma<8>::run(acc[m][f], af, bf[f]);
  }
}

template <int CPB>
__global__ void __launch_bounds__(THREADS, 1)
tri_product_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   double* __restrict__ C, const int* __restrict__ plan, long long n,
                   double beta, double alpha, int phi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int* pl = plan + PLAN * blockIdx.x;
  const long long i0 = pl[0], j0 = pl[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long kb = pl[2 + warp], ke = pl[3 + warp];  // this warp's chunk [kb, ke)
  double* ring = sm + warp * RING;

  double acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.0;

  const int nk = static_cast<int>((ke - kb + KS - 1) / KS);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<CPB>(ring + s * STAGE, A, B, n, i0, j0, kb + s * KS, ke, lane);
    syrk::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    syrk::cp_wait<STAGES - 2>();  // step kt has landed (this lane's copies)
    __syncwarp();                 // ... every lane's; step kt - 1's stage is free
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_stage<CPB>(ring + (pf % STAGES) * STAGE, A, B, n, i0, j0, kb + pf * KS, ke, lane);
    syrk::cp_commit();
    mma_stage(ring + (kt % STAGES) * STAGE, acc, g, t, i0, j0, kb + kt * KS, phi);
  }
  syrk::cp_wait<0>();
  __syncthreads();  // every ring is free: the partial tiles go there

  double* P = sm + warp * TILE * LDP;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = 16 * m + g, c = 8 * f + 2 * t;
      *reinterpret_cast<double2*>(P + r * LDP + c) = make_double2(acc[m][f][0], acc[m][f][1]);
      *reinterpret_cast<double2*>(P + (r + 8) * LDP + c) =
          make_double2(acc[m][f][2], acc[m][f][3]);
    }
  __syncthreads();

  // the tile, a warp on a row: the partials summed in warp order, then
  // beta A + alpha C on i >= j, 0 above; the mirror tile's zeros
#pragma unroll
  for (int q = 0; q < TILE / WARPS; ++q) {
    const int r = warp + WARPS * q, c = lane;
    const long long gi = i0 + r, gj = j0 + c;
    if (gi < n && gj < n) {
      double s = sm[r * LDP + c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += sm[w * TILE * LDP + r * LDP + c];
      double v = 0.0;
      if (gi >= gj) v = beta != 0.0 ? beta * A[gi * n + gj] + alpha * s : alpha * s;
      C[gi * n + gj] = v;
    }
    const long long gr = j0 + r, gc = i0 + c;
    if (i0 != j0 && gr < n && gc < n) C[gr * n + gc] = 0.0;
  }
}

template <int CPB>
int launch_tri_product(const double* A, const double* B, double* C, const int* plan,
                       long long ntiles, long long n, double beta, double alpha, int phi,
                       cudaStream_t s) {
  static std::atomic<unsigned long long> attribute_set{0};
  const auto kernel = tri_product_kernel<CPB>;
  const int err = smem_attribute_once(kernel, SMEM, attribute_set);
  if (err) return err;
  kernel<<<static_cast<unsigned>(ntiles), THREADS, SMEM, s>>>(A, B, C, plan, n, beta, alpha, phi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tri

// ---------------------------------------------------------------- K8r
namespace rres {

using tri::KS;
using tri::LDA;
using tri::LDP;
using tri::PLAN;
using tri::STAGES;
using tri::THREADS;
using tri::TILE;
using tri::WARPS;
constexpr int STAGE = 2 * TILE * LDA;  // doubles a stage: rows i0.. of L, then rows j0..
constexpr int RING = STAGES * STAGE;   // doubles a warp
constexpr int PART = WARPS * TILE * LDP;  // the warps' partial tiles, doubles
constexpr int LDE = TILE + 1;          // a row of the summed tile, odd
constexpr int SMEM = WARPS * RING * static_cast<int>(sizeof(double));
static_assert(PART + TILE * LDE + 2 * THREADS <= WARPS * RING,
              "the partial tiles, the summed tile and the sums fit in the rings");
static_assert(SMEM <= 232448, "the rings fit in 227 KB");
static_assert(THREADS == 256, "the last block sums the pairs as reduce_pairs_kernel does");

// one stage: L[i0 .. i0 + 32, k0 .. k0 + 8) and L[j0 .. j0 + 32, k0 .. k0 + 8)
// into st (rows of LDA), CPB bytes a copy; entries at k >= kend or past the
// (n, n) panel are zero-filled
template <int CPB>
__device__ __forceinline__ void load_stage(double* st, const double* L, long long n,
                                           long long i0, long long j0, long long k0,
                                           long long kend, int lane) {
  constexpr int W = CPB / 8;  // doubles a copy
  constexpr int ROW = KS / W, PER = TILE * ROW / 32;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int c = lane + 32 * q, r = c / ROW, kc = (c % ROW) * W;
    const long long gk = k0 + kc, gi = i0 + r, gj = j0 + r;
    const bool oka = gi < n && gk < kend, okb = gj < n && gk < kend;
    syrk::cp_async<CPB>(st + r * LDA + kc, oka ? L + gi * n + gk : L, oka);
    syrk::cp_async<CPB>(st + TILE * LDA + r * LDA + kc, okb ? L + gj * n + gk : L, okb);
  }
}

// the warp's 2 x 4 fragments over one staged step: a[2 v + h] =
// L(i0 + 16 m + g + 8 h, k0 + t + 4 v), b[v] = L^T(k0 + t + 4 v, j0 + 8 f + g)
__device__ __forceinline__ void mma_stage(const double* st, double (&acc)[2][4][4], int g,
                                          int t) {
  const double* sa = st;
  const double* sb = st + TILE * LDA;
  double bf[4][2];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int v = 0; v < 2; ++v) bf[f][v] = sb[(8 * f + g) * LDA + t + 4 * v];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    double af[4];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int h = 0; h < 2; ++h) af[2 * v + h] = sa[(16 * m + g + 8 * h) * LDA + t + 4 * v];
#pragma unroll
    for (int f = 0; f < 4; ++f) syrk::Mma<8>::run(acc[m][f], af, bf[f]);
  }
}

// a fixed tree over the block's 256 threads: s0[0] and s1[0] hold the sums
__device__ __forceinline__ void block_tree(double* s0, double* s1, int tid) {
  __syncthreads();
#pragma unroll
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s0[tid] += s0[tid + h];
      s1[tid] += s1[tid + h];
    }
    __syncthreads();
  }
}

template <int CPB>
__global__ void __launch_bounds__(THREADS, 1)
refine_residual_kernel(const double* __restrict__ A, const double* __restrict__ L,
                       double* __restrict__ E, const int* __restrict__ plan, long long n,
                       double* __restrict__ pairs, double* __restrict__ sums,
                       unsigned int* __restrict__ ticket) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int* pl = plan + PLAN * blockIdx.x;
  const long long i0 = pl[0], j0 = pl[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long kb = pl[2 + warp], ke = pl[3 + warp];  // this warp's chunk [kb, ke)
  double* ring = sm + warp * RING;

  double acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.0;

  const int nk = static_cast<int>((ke - kb + KS - 1) / KS);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<CPB>(ring + s * STAGE, L, n, i0, j0, kb + s * KS, ke, lane);
    syrk::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    syrk::cp_wait<STAGES - 2>();  // step kt has landed (this lane's copies)
    __syncwarp();                 // ... every lane's; step kt - 1's stage is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage<CPB>(ring + (pf % STAGES) * STAGE, L, n, i0, j0, kb + pf * KS, ke, lane);
    syrk::cp_commit();
    mma_stage(ring + (kt % STAGES) * STAGE, acc, g, t);
  }
  syrk::cp_wait<0>();
  __syncthreads();  // every ring is free: the partial tiles go there

  double* P = sm + warp * TILE * LDP;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = 16 * m + g, c = 8 * f + 2 * t;
      *reinterpret_cast<double2*>(P + r * LDP + c) = make_double2(acc[m][f][0], acc[m][f][1]);
      *reinterpret_cast<double2*>(P + (r + 8) * LDP + c) =
          make_double2(acc[m][f][2], acc[m][f][3]);
    }
  __syncthreads();

  // E = A - C on i >= j, the partials summed in warp order, a warp on a row;
  // the same values into Et for the mirror; this thread's sums
  double* Et = sm + PART;
  double* s0 = Et + TILE * LDE;
  double* s1 = s0 + THREADS;
  double e2 = 0.0, a2 = 0.0;
#pragma unroll
  for (int q = 0; q < TILE / WARPS; ++q) {
    const int r = warp + WARPS * q, c = lane;
    const long long gi = i0 + r, gj = j0 + c;
    if (gi < n && gj < n && gi >= gj) {
      double s = sm[r * LDP + c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += sm[w * TILE * LDP + r * LDP + c];
      const double a = A[gi * n + gj];
      const double e = a - s;
      E[gi * n + gj] = e;
      Et[r * LDE + c] = e;
      const double w = gi == gj ? 1.0 : 2.0;
      e2 += w * e * e;
      a2 += w * a * a;
    }
  }
  s0[tid] = e2;
  s1[tid] = a2;
  __syncthreads();
  // the mirror: row j0 + r of E, columns i0 + c > j0 + r, from Et's column r
#pragma unroll
  for (int q = 0; q < TILE / WARPS; ++q) {
    const int r = warp + WARPS * q, c = lane;
    const long long gr = j0 + r, gc = i0 + c;
    if (gr < n && gc < n && gc > gr) E[gr * n + gc] = Et[c * LDE + r];
  }
  block_tree(s0, s1, tid);
  if (tid == 0) {
    pairs[2 * blockIdx.x] = s0[0];
    pairs[2 * blockIdx.x + 1] = s1[0];
    __threadfence();  // the pair is visible before the ticket counts it
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every pair, in index order
  __threadfence();
  double a = 0.0, b = 0.0;
  for (long long i = tid; i < gridDim.x; i += THREADS) {
    a += __ldcg(pairs + 2 * i);
    b += __ldcg(pairs + 2 * i + 1);
  }
  s0[tid] = a;
  s1[tid] = b;
  block_tree(s0, s1, tid);
  if (tid == 0) {
    sums[0] = s0[0];
    sums[1] = s1[0];
    *ticket = 0u;  // ready for the next launch (and the next graph replay)
  }
}

template <int CPB>
int launch_refine_residual(const double* A, const double* L, double* E, const int* plan,
                           long long ntiles, long long n, double* pairs, double* sums,
                           unsigned int* ticket, cudaStream_t s) {
  static std::atomic<unsigned long long> attribute_set{0};
  const auto kernel = refine_residual_kernel<CPB>;
  const int err = smem_attribute_once(kernel, SMEM, attribute_set);
  if (err) return err;
  kernel<<<static_cast<unsigned>(ntiles), THREADS, SMEM, s>>>(A, L, E, plan, n, pairs, sums,
                                                             ticket);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rres

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

// K8t's plan geometry: the tile width, the warps (k chunks) a tile, the
// columns a k step, the ints a plan row (ops/refine.py checks them)
int gpmp_tri_product_geometry(int what) {
  switch (what) {
    case 0: return tri::TILE;
    case 1: return tri::WARPS;
    case 2: return tri::KS;
    case 3: return tri::PLAN;
    default: return -1;
  }
}

// K8t: C = beta A + alpha tril(A) f(B) over the plan's ntiles lower tiles
int gpmp_tri_product(const void* A, const void* B, void* C, const void* plan, long long ntiles,
                     long long n, double beta, double alpha, int phi, void* stream) {
  if (n <= 0 || ntiles <= 0 || ntiles > 0x7fffffffLL || !A || !B || !C || !plan)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(A), b = reinterpret_cast<uintptr_t>(B);
  if (a % 8 || b % 8 || reinterpret_cast<uintptr_t>(C) % 8 ||
      reinterpret_cast<uintptr_t>(plan) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const double* pa = static_cast<const double*>(A);
  const double* pb = static_cast<const double*>(B);
  double* pc = static_cast<double*>(C);
  const int* pp = static_cast<const int*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every staged row 16-byte aligned and never
  // straddling the matrix's or a chunk's edge: n even, the chunk bounds
  // even (the plan's are j0 + 8 q or min(i0 + 32, n))
  if (n % 2 == 0 && a % 16 == 0 && b % 16 == 0)
    return tri::launch_tri_product<16>(pa, pb, pc, pp, ntiles, n, beta, alpha, phi, s);
  return tri::launch_tri_product<8>(pa, pb, pc, pp, ntiles, n, beta, alpha, phi, s);
}

// K8r: E = A - L L^T over the plan's ntiles lower tiles, mirrored, and
// [sum E^2, sum A^2] into sums; pairs (2 ntiles doubles) and ticket (one
// unsigned int, zero between launches) are the wrapper's cached workspace
int gpmp_refine_residual(const void* A, const void* L, void* E, const void* plan,
                         long long ntiles, long long n, void* pairs, void* sums, void* ticket,
                         void* stream) {
  if (n <= 0 || ntiles <= 0 || ntiles > 0x7fffffffLL || !A || !L || !E || !plan || !pairs ||
      !sums || !ticket)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(A), l = reinterpret_cast<uintptr_t>(L);
  if (a % 8 || l % 8 || reinterpret_cast<uintptr_t>(E) % 8 ||
      reinterpret_cast<uintptr_t>(plan) % 4 || reinterpret_cast<uintptr_t>(pairs) % 8 ||
      reinterpret_cast<uintptr_t>(sums) % 8 || reinterpret_cast<uintptr_t>(ticket) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const double* pa = static_cast<const double*>(A);
  const double* pl = static_cast<const double*>(L);
  double* pe = static_cast<double*>(E);
  const int* pp = static_cast<const int*>(plan);
  double* pr = static_cast<double*>(pairs);
  double* ps = static_cast<double*>(sums);
  unsigned int* pt = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies: n even (every row and every chunk bound even) and L
  // 16-byte aligned
  if (n % 2 == 0 && l % 16 == 0)
    return rres::launch_refine_residual<16>(pa, pl, pe, pp, ntiles, n, pr, ps, pt, s);
  return rres::launch_refine_residual<8>(pa, pl, pe, pp, ntiles, n, pr, ps, pt, s);
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
