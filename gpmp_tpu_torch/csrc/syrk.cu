// gpmp_tpu_torch/csrc/syrk.cu
//
// K9u and K9s (f64): the blocked Cholesky's trailing update and its slab
// form on a row-sharded factor (wrappers in gpmp_tpu_torch/ops/chol.py,
// callers in gpmp_tpu_torch/parallel/chol.py), for Hopper, sm_90a, on the
// f64 tensor cores.  Plain C entry points, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.  The kernel itself (tiles, the cp.async
// ring, the mma fragments, the epilogue) is csrc/syrk_f64.cuh.
//
// K9u trailing update (replaces S[b:, b:] - T T^T of gpmp_tpu/parallel/
//    chol.py _blocked_cholesky_single_unrolled):
//      A[off:, off:] -= T T^T in place on the (n, n) f64 buffer that holds
//      K and becomes L, off = c0 + b, T = A[off:, c0:off] (the solved
//      panel, already written into A); the lower tiles of the trailing
//      block only, (i, j) and (j, i) from one value: S stays exactly
//      symmetric for the next panel.
// K9s slab trailing update, f64 (replaces the per-device update
//    K_loc[:, w0:] - Mt_loc Mt_all[w0:]^T of gpmp_tpu/parallel/chol.py
//    _sharded_cholesky_impl's panel_step):
//      A[i - off, j] -= A[i - off, c0:w0] . Mt[j] on one rank's (rows, n)
//      slab of global rows [off, off + rows), w0 = c0 + b, Mt the (n, b)
//      gather of every rank's trailing panel rows, over the slab's rows
//      i >= w0 and columns w0 <= j <= i (the lower trapezoid: the upper part
//      of a slab is never read again, and its mirror lives on another rank).
//    The same kernel as K9u (MIRROR = false), so at one rank (off = 0) the
//    lower triangle is bitwise K9u's.  The f32 form (the direct factor of
//    the mixed engine's f32 preconditioner) is a CUDA-core kernel, csrc/
//    syrk_f32.cu: its only tensor-core route is TF32, which the port's f32
//    precision pin forbids.
//
// Bound on the H100: (trailing lower entries) x b f64 multiply-adds,
//    n^3/6 over a factor; at n = 16384, b = 512, first panel, 1.29e11
//    flops: 1.93 ms at the 67 TFLOP/s f64 tensor peak, against 0.92 ms for
//    its bytes (the lower block read, the whole block written, T read once)
//    at 3.35 TB/s: compute-bound.  The CUDA cores alone give 34 TFLOP/s in
//    f64, and a kernel that stages k through shared memory one FMA per
//    shared load reaches an eighth of that (the former K4-template kernel:
//    15.6 ms).  Design: the f64 mma.sync tensor-core path with a 64 x 32
//    register tile per warp (4 x 4 m16n8 fragments fed by 16-byte shared
//    loads), k staged 16 columns a step through a 4-stage cp.async ring;
//    128 x 128 tiles, only those that meet the lower triangle, listed by the
//    wrapper.  What is left between it and the bound (chip_smoke phase 4e's
//    sweep over b, PERF.md): a fixed part per wave of tiles, the ring's fill
//    and the epilogue's traffic of S, which every block does at once, beside
//    a k loop below the tensor peak.
//
// MMA_K, the mma shape of K9u and K9s, was chosen by the probe of chip_smoke
// phase 4e (gpmp_syrk_probe: K9u at each sm_90 f64 shape, first panel of
// n = 16384; m16n8k16 spills at 255 registers); the rates are in PERF.md.

#include <cuda_runtime.h>

#include "syrk_f64.cuh"

namespace {

constexpr int MMA_K = 8;

// A's rows and the panel's columns leave a trailing block; for K9s the slab
// holds some of its rows
bool bad_panel(long long n, long long c0, long long b) {
  return n <= 0 || c0 < 0 || b <= 0 || c0 + b >= n;
}

syrk::Args<syrk::Trailing> trailing_args(void* A, const void* tiles, long long n, long long c0,
                                         long long b) {
  double* a = static_cast<double*>(A);
  return {a, {a, n, 0}, a + c0, a + c0, static_cast<const int*>(tiles), n, n, n, 0, n, 0, n, b};
}

template <int MK>
int trailing_update(void* A, const void* tiles, long long ntiles, long long n, long long c0,
                    long long b, void* stream) {
  if (bad_panel(n, c0, b) || !A || !tiles) return static_cast<int>(cudaErrorInvalidValue);
  return syrk::launch<syrk::Trailing, syrk::Big, MK>(trailing_args(A, tiles, n, c0, b), ntiles,
                                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int gpmp_syrk_tile() { return syrk::TILE; }

int gpmp_syrk_mma_k() { return MMA_K; }

// K9u: A[off:, off:] -= T T^T in place over the listed lower tiles
int gpmp_trailing_update(void* A, const void* tiles, long long ntiles, long long n,
                         long long c0, long long b, void* stream) {
  return trailing_update<MMA_K>(A, tiles, ntiles, n, c0, b, stream);
}

// K9u at a chosen mma shape (mma_k in {4, 8, 16}): the shape probe
int gpmp_syrk_probe(void* A, const void* tiles, long long ntiles, long long n, long long c0,
                    long long b, int mma_k, void* stream) {
  switch (mma_k) {
    case 4: return trailing_update<4>(A, tiles, ntiles, n, c0, b, stream);
    case 8: return trailing_update<8>(A, tiles, ntiles, n, c0, b, stream);
    case 16: return trailing_update<16>(A, tiles, ntiles, n, c0, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9s (f64): the slab's lower trapezoid over the listed tiles
int gpmp_slab_update_f64(void* A, const void* Mt, const void* tiles, long long ntiles,
                         long long rows, long long n, long long off, long long c0, long long b,
                         void* stream) {
  if (bad_panel(n, c0, b) || rows <= 0 || off < 0 || off + rows > n || !A || !Mt || !tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((off > c0 + b ? off : c0 + b) >= off + rows) return static_cast<int>(cudaErrorInvalidValue);
  double* a = static_cast<double*>(A);
  const syrk::Args<syrk::Slab> p{a, {a, n, off}, a + c0, static_cast<const double*>(Mt),
                                 static_cast<const int*>(tiles), n, n, b, off, off + rows, 0, n,
                                 b};
  return syrk::launch<syrk::Slab, syrk::Big, MMA_K>(p, ntiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
