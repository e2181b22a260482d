// gpmp_tpu_torch/csrc/residual.cu
//
// K4 and K4s: the factorization residual of the mixed-precision Cholesky
// engine (wrappers in gpmp_tpu_torch/ops/mixed.py), and K8s, the residual
// of its sampling root (wrapper in gpmp_tpu_torch/ops/refine.py), for
// Hopper, sm_90a, on the f64 tensor cores.  Plain C entry points, loaded
// with ctypes by gpmp_tpu_torch/ops/_build.py.  The kernel itself (tiles,
// the cp.async ring, the mma fragments, the epilogue) is csrc/
// syrk_f64.cuh's, in the modes Residual<T> (K4), ResidualSlab (K4s) and
// SamplingResidual (K8s with f64 K).
//
// K4 factorization residual (replaces gpmp_tpu/ops/mixed.py
//    _factorization_residual_f32):
//      R = f32(K - L L^T), K (n, n) f64 or f32, L the (n, n) lower-triangular
//      f32 factor; the products and sums in f64 (an f32 x f32 product is
//      exact there), over the lower tiles only, each entry written at (i, j)
//      and (j, i) from one value: R is exactly symmetric.
// K4s slab residual (the sharded mixed engine on a group mesh,
//    gpmp_tpu_torch/parallel/mixed.py; the JAX package's per-device share of
//    the same product):
//      R[i, offs + j] = f32(K[i, offs + j] - La[i] . Lb[j]) for one rank's
//      rows i (global off + i) and the rows j of a source rank's slab
//      (global offs + j): one (rows, rows_b) column block, both triangles
//      (the mirror lives on another rank).  The same kernel and the same
//      sum order as K4: at one rank R is bitwise K4's, and across ranks
//      R[i, j] on one equals R[j, i] on the other (chip_smoke phase 2f holds
//      both).
// K8s sampling residual (replaces E = K - L L^T of gpmp_tpu/ops/refine.py
//    sampling_sqrt):
//      E = K - L L^T in K's dtype, the sampling root's C = L + L (M E M^T) / 2
//      needing E in f64.  f64 K: K4's kernel, tiles and sum order with an
//      f64 output (mode SamplingResidual), so E rounded to f32 is bitwise K4
//      and E is exactly symmetric; f32 K: E is K4's f32 instance as it is
//      (Residual<float> computes f32(K - L L^T) with K f32), no second
//      instance.  Bound: K4's operations (2.7 ms at n = 8192, the sample
//      paths' size) beside K4's bytes with E written in f64.  It replaces
//      the CUDA-core 32 x 32 residual of csrc/mixed.cu, ~12% of that bound.
//
// Bound on the H100: n^3/3 f64 operations over the lower triangle (L is
//    triangular, so a tile's sum stops at its last column) at the 67
//    TFLOP/s f64 tensor peak: 5.0 us at n = 1000, 2.73 ms at n = 8192,
//    22 ms at n = 16384; its bytes (K and L read once, R written) take
//    4.8 us at n = 1000, so it is compute-bound from n ~ 1000 up.  The
//    former kernel, 32 x 32 tiles of CUDA-core f64 FMAs with about 1.25
//    shared loads per FMA, ran at ~13% of the bound.  Design: csrc/
//    syrk_f64.cuh's f64 mma.sync core, with the f32 factor staged as f32
//    and widened as the fragments form, each tile's k range cut at its last
//    row or column (TRI), tiles listed longest k range first (the wrapper's
//    list, so the longest tiles start in the first wave); 64 x 64 tiles of
//    4 warps, two blocks to an SM, so that one block's ring fill and
//    epilogue overlap the other's k loop.  They were measured on the card
//    against K9u's 128 x 128 tiles of 8 warps (one block to an SM: 36
//    tiles for 132 SMs at n = 1000) and against a split k range summed by
//    a fixed-order second pass: neither was faster at any n (PERF.md, PR
//    8), so neither is built.

#include <cuda_runtime.h>

#include "syrk_f64.cuh"

namespace {

constexpr int MMA_K = 8;  // csrc/syrk.cu's shape (chip_smoke phase 4e's probe)

template <class M>
int launch_tile(const syrk::Args<M>& p, long long ntiles, void* stream) {
  return syrk::launch<M, syrk::Small, MMA_K>(p, ntiles, static_cast<cudaStream_t>(stream));
}

// the square residual in mode M over the listed lower tiles
template <class M>
int residual(const void* K, const void* L, void* R, const void* tiles, long long ntiles,
             long long n, void* stream) {
  if (n <= 0 || !K || !L || !R || !tiles) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(L);
  const syrk::Args<M> p{static_cast<typename M::TO*>(R), static_cast<const typename M::TS*>(K),
                        l, l, static_cast<const int*>(tiles), n, n, n, 0, n, 0, n, n};
  return launch_tile(p, ntiles, stream);
}

}  // namespace

extern "C" {

int gpmp_residual_tile() { return syrk::Small::TILE; }

// K4: R = f32(K - L L^T) over the listed lower tiles, K f64
int gpmp_fact_residual_mma_f64(const void* K, const void* L, void* R, const void* tiles,
                               long long ntiles, long long n, void* stream) {
  return residual<syrk::Residual<double>>(K, L, R, tiles, ntiles, n, stream);
}

// K4 with K f32 (the port's float32 mode)
int gpmp_fact_residual_mma_f32(const void* K, const void* L, void* R, const void* tiles,
                               long long ntiles, long long n, void* stream) {
  return residual<syrk::Residual<float>>(K, L, R, tiles, ntiles, n, stream);
}

// K8s with K f64: E = K - L L^T in f64 over K4's tiles, mirrored (K8s with
// K f32 is gpmp_fact_residual_mma_f32)
int gpmp_sampling_residual_mma_f64(const void* K, const void* L, void* E, const void* tiles,
                                   long long ntiles, long long n, void* stream) {
  return residual<syrk::SamplingResidual>(K, L, E, tiles, ntiles, n, stream);
}

// K4s: R[:, offs:offs + rows_b] = f32(K[:, offs:offs + rows_b] - La Lb^T)
// over the listed 64-wide tiles of the column block (global corners)
int gpmp_slab_fact_residual_mma(const void* K, const void* La, const void* Lb, void* R,
                                const void* tiles, long long ntiles, long long rows,
                                long long rows_b, long long n, long long off, long long offs,
                                void* stream) {
  if (rows <= 0 || rows_b <= 0 || n <= 0 || off < 0 || off + rows > n || offs < 0 ||
      offs + rows_b > n || !K || !La || !Lb || !R || !tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const syrk::Args<syrk::ResidualSlab> p{
      static_cast<float*>(R), static_cast<const double*>(K), static_cast<const float*>(La),
      static_cast<const float*>(Lb), static_cast<const int*>(tiles), n, n, n, off, off + rows,
      offs, offs + rows_b, n};
  return launch_tile(p, ntiles, stream);
}

}  // extern "C"
