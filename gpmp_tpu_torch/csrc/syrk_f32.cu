// gpmp_tpu_torch/csrc/syrk_f32.cu
//
// K9s f32: the slab trailing update of the row-sharded factor on the mixed
// engine's direct f32 factor (wrapper gpmp_tpu_torch/ops/chol.py
// slab_update, caller gpmp_tpu_torch/parallel/chol.py), for Hopper, sm_90a,
// on the CUDA cores.  A plain C entry point, loaded with ctypes by
// gpmp_tpu_torch/ops/_build.py.
//
// Replaces the per-device update K_loc[:, w0:] - Mt_loc Mt_all[w0:]^T of
//    gpmp_tpu/parallel/chol.py _sharded_cholesky_impl's panel_step on the
//    f32 factor (the JAX package's f32 HIGHEST products):
//      A[i - off, j] -= sum_{k < b} A[i - off, c0 + k] Mt[j, k]
//    on one rank's (rows, n) f32 slab of global rows [off, off + rows), Mt
//    the (n, b) gather of every rank's trailing panel rows, over the slab's
//    rows i >= w0 = c0 + b and columns w0 <= j <= i (the lower trapezoid),
//    products and sums in f32, each sum in k order.
//
// Bound on the H100: 2 b operations per trapezoid entry (n^3/3 per factor
//    at one rank) at the 67 TFLOP/s f32 peak of the CUDA cores: 1.93 ms at
//    n = 16384's first panel (b = 512).  TF32, the only f32 tensor-core
//    route, is forbidden by the port's f32 precision pin, and an f64 DMMA
//    form would round otherwise than the JAX package's f32 sums, so FFMA it
//    is.  The former kernel (32 x 32 tiles, a thread's 4 outputs, about 5
//    shared loads per 4 FMAs) ran at 15% of the bound.
//
// Design: the 128 x 128 tiles of ops.chol.syrk_tiles (those meeting the
//    lower trapezoid; the diagonal ones masked entrywise), 256 threads, each
//    with an 8 x 8 register tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
//    columns likewise from tx), so that one k step costs a thread four
//    16-byte shared loads for 64 FMAs.  The operands are staged k-major
//    (a stage holds KT = 8 columns of k, rows padded to 132 floats so that
//    a warp's transposing writes hit 32 distinct banks) in a 4-stage ring
//    filled by 4-byte cp.async copies (any row alignment: odd n too), so
//    the loads of step k + 3 overlap the products of step k.  Two blocks
//    per SM (33 KB of shared memory, at most 128 registers a thread).
//    In place is safe: A is read only in the panel's columns [c0, w0), which
//    no block writes, and at the tile's own written entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int KT = 8;                         // k columns per stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;                  // 16 x 16, an 8 x 8 tile each
constexpr int LDT = TILE + 4;                 // a staged k row, floats
constexpr int STAGE = 2 * KT * LDT;           // floats: both operands
constexpr int SMEM_BYTES = STAGES * STAGE * static_cast<int>(sizeof(float));
constexpr int PER_THREAD = TILE * KT / THREADS;  // copies per operand per stage

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  float* A;          // the slab: global row i at A + (i - off) * n
  const float* Mt;   // (n, b): row j at Mt + j * b
  const int* tiles;  // (i0, j0) of block b at tiles[2 b], tiles[2 b + 1]
  long long n, off, iend, c0, b;
};

// one stage, k-major: sa[k * LDT + r] = A[i0 + r, c0 + k0 + k], sb likewise
// from Mt's rows j0 + r; consecutive threads read consecutive k of a row
__device__ __forceinline__ void load_stage(float* sa, float* sb, const Args& p, long long i0,
                                           long long j0, long long k0, int tid) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int c = tid + q * THREADS;
    const int r = c / KT, k = c % KT;
    const long long gk = k0 + k, gi = i0 + r, gj = j0 + r;
    const bool oka = gk < p.b && gi < p.iend, okb = gk < p.b && gj < p.n;
    cp4(sa + k * LDT + r, oka ? p.A + (gi - p.off) * p.n + p.c0 + gk : p.A, oka);
    cp4(sb + k * LDT + r, okb ? p.Mt + gj * p.b + gk : p.Mt, okb);
  }
}

__global__ void __launch_bounds__(THREADS, 2) slab_update_f32_kernel(Args p) {
  extern __shared__ __align__(16) float ring[];
  const long long i0 = p.tiles[2 * blockIdx.x], j0 = p.tiles[2 * blockIdx.x + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  const int nk = static_cast<int>((p.b + KT - 1) / KT);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage(ring + s * STAGE, ring + s * STAGE + KT * LDT, p, i0, j0,
                 static_cast<long long>(s) * KT, tid);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();        // ... every thread's; step kt - 1's stage is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      float* st = ring + (pf % STAGES) * STAGE;
      load_stage(st, st + KT * LDT, p, i0, j0, static_cast<long long>(pf) * KT, tid);
    }
    cp_commit();
    const float* sa = ring + (kt % STAGES) * STAGE;
    const float* sb = sa + KT * LDT;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + k * LDT + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + k * LDT + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + k * LDT + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + k * LDT + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  cp_wait<0>();

  // A[i, j] -= C[i, j] on the lower entries of the thread's 8 x 8
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long gi = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (gi >= p.iend) continue;
    float* row = p.A + (gi - p.off) * p.n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const long long gj = j0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (gj < p.n && gj <= gi) row[gj] -= acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

int gpmp_syrk_f32_tile() { return TILE; }

// K9s (f32): the slab's lower trapezoid over the listed tiles
int gpmp_slab_update_f32(void* A, const void* Mt, const void* tiles, long long ntiles,
                         long long rows, long long n, long long off, long long c0, long long b,
                         void* stream) {
  const long long w0 = c0 + b;
  if (rows <= 0 || n <= 0 || off < 0 || off + rows > n || c0 < 0 || b <= 0 || w0 >= n || !A ||
      !Mt || !tiles || ntiles <= 0 || ntiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((off > w0 ? off : w0) >= off + rows) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(A) % 4 || reinterpret_cast<uintptr_t>(Mt) % 4 ||
      reinterpret_cast<uintptr_t>(tiles) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args p{static_cast<float*>(A), static_cast<const float*>(Mt),
               static_cast<const int*>(tiles), n, off, off + rows, c0, b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaFuncSetAttribute(
      slab_update_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (err) return err;
  slab_update_f32_kernel<<<static_cast<unsigned>(ntiles), THREADS, SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
