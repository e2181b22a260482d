// gpmp_tpu_torch/csrc/syrk_f64.cuh
//
// The f64 tensor-core core of the blocked Cholesky's trailing update (K9u)
// and of its slab form (K9s), included by csrc/syrk.cu; see there for what
// each kernel replaces and what bounds it.  One device kernel, two
// instances: for each listed 128 x 128 output tile (i0, j0),
//
//      A[i - off, j] -= sum_{k < b} Ta[i, k] Tb[j, k]     (i >= j only)
//
// and with MIRROR (K9u) the same value is also stored at (j, i).
//
// Design, for Hopper (sm_90a):
// - f64 tensor cores through mma.sync.aligned.m16n8k{4,8,16}.row.col.f64
//   (wgmma has no f64 form).  A block of 8 warps owns the 128 x 128 tile;
//   each warp a 64 x 32 sub-tile of 4 x 4 m16n8 fragments: 64 f64
//   accumulators a thread.
// - k advances 16 columns a step through a ring of STAGES stages in dynamic
//   shared memory, filled by cp.async (16-byte .cg copies where every row
//   is 16-byte aligned, else 8-byte .ca copies; zero-fill past the ragged
//   rows and the k tail), so the loads of step k + 3 overlap the products
//   of step k.
// - A lane feeds its mma k slots of a stage (t, t + 4, t + 8, t + 12 of the
//   16) with the stage's columns 4t .. 4t + 3, the same for both operands
//   (a sum over k in another fixed order), so its fragments come as two
//   16-byte shared loads per row; staged rows are padded to LDS = 18
//   doubles (LDS / 2 = 1 mod 8), so each quarter warp's 16-byte loads hit
//   8 distinct bank groups.
// - Each output sums its b products in one fixed order (the k steps in
//   order, each step's mma in order), whatever the tile or the instance:
//   K9s at one rank is bitwise K9u's lower triangle.
// - Epilogue: the tile goes to shared memory (the ring reused, rows padded
//   to an odd LDC so that column reads are conflict-free); each thread then
//   loads all of its S entries (the lower ones only) before it stores any,
//   so the loads are in flight together, writes S - C there (a warp on a
//   row: coalesced), and, with MIRROR, writes the transposed rows (j, i)
//   from the same values (coalesced rows again), so S stays exactly
//   symmetric.
// - In place is safe: the operands are read only in the panel's columns
//   [c0, c0 + b), which no block writes; S is read only at the lower
//   entries of the block's own tile, and the mirror writes only entries
//   above the diagonal, which no block reads.
// - The tile list is built by the caller (gpmp_tpu_torch/ops/chol.py):
//   only tiles that meet the lower triangle (or the slab's lower trapezoid)
//   are launched; the diagonal ones are masked entrywise by i >= j.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace syrk {

constexpr int TILE = 128;                        // output tile, rows and columns
constexpr int KT = 16;                           // k columns per stage: 4 a lane
constexpr int STAGES = 4;                        // depth of the ring
constexpr int LDS = KT + 2;                      // padded staged row, doubles
constexpr int LDC = TILE + 1;                    // padded epilogue row, doubles
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;  // a warp's 64 x 32
constexpr int MF = WM / 16, NF = WN / 8;                 // its 4 x 4 fragments
constexpr int STAGE = 2 * TILE * LDS;                    // doubles per stage
constexpr int SMEM_DOUBLES = STAGES * STAGE > TILE * LDC ? STAGES * STAGE : TILE * LDC;
constexpr int SMEM_BYTES = static_cast<int>(sizeof(double)) * SMEM_DOUBLES;  // 144 KB
static_assert(SMEM_BYTES <= 232448, "the ring and the epilogue tile fit in 227 KB");

struct Args {
  double* A;         // output: A[(i - off) * lda + j] for global rows i in [off, iend)
  const double* Ta;  // row i of the left operand at Ta + (i - off) * lda (A + c0)
  const double* Tb;  // row j of the right operand at Tb + j * ldb
  const int* tiles;  // (i0, j0) of block b at tiles[2 b], tiles[2 b + 1]
  long long lda, ldb, off, iend, n, b;
};

// D += A B for one m16n8 fragment, MK = 4, 8 or 16 (the sm_90 f64 shapes).
// Fragments (lane = 4 g + t): a[2 v + h] holds (row g + 8 h, k t + 4 v),
// b[v] holds (k t + 4 v, column g), d[2 h + e] holds (row g + 8 h,
// column 2 t + e).
template <int MK>
struct Mma;

template <>
struct Mma<4> {
  __device__ __forceinline__ static void run(double (&d)[4], const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};

template <>
struct Mma<8> {
  __device__ __forceinline__ static void run(double (&d)[4], const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

template <>
struct Mma<16> {
  __device__ __forceinline__ static void run(double (&d)[4], const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// cp.async with zero-fill: ok = false copies no byte and writes zeros
__device__ __forceinline__ void cp16(double* dst, const double* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp8(double* dst, const double* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one stage: rows i0.. of Ta and j0.. of Tb, columns [k0, k0 + KT), into the
// (TILE, LDS) arrays sa and sb
template <bool VEC16>
__device__ __forceinline__ void load_stage(double* sa, double* sb, const Args& p, long long i0,
                                           long long j0, long long k0, int tid) {
  constexpr int W = VEC16 ? 2 : 1;  // doubles per copy
  constexpr int PER_ROW = KT / W;
  constexpr int PER_THREAD = TILE * PER_ROW / THREADS;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int c = tid + q * THREADS;
    const int r = c / PER_ROW, kc = (c % PER_ROW) * W;
    const long long gk = k0 + kc, gi = i0 + r, gj = j0 + r;
    const bool oka = gk < p.b && gi < p.iend, okb = gk < p.b && gj < p.n;
    const double* srca = oka ? p.Ta + (gi - p.off) * p.lda + gk : p.Ta;
    const double* srcb = okb ? p.Tb + gj * p.ldb + gk : p.Tb;
    if (VEC16) {
      cp16(sa + r * LDS + kc, srca, oka);
      cp16(sb + r * LDS + kc, srcb, okb);
    } else {
      cp8(sa + r * LDS + kc, srca, oka);
      cp8(sb + r * LDS + kc, srcb, okb);
    }
  }
}

// a lane's 4 staged columns 4t .. 4t + 3 of one row, two 16-byte loads
__device__ __forceinline__ void load4(const double* row, int t, double (&v)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(row + 4 * t);
  const double2 hi = *reinterpret_cast<const double2*>(row + 4 * t + 2);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// the warp's 4 x 4 fragments over one staged k step, MK columns per mma:
// mma step s takes the lane's columns 4t + s KV .. 4t + (s + 1) KV - 1 into
// its slots t + 4 v (v < KV), for both operands
template <int MK>
__device__ __forceinline__ void mma_stage(const double* sa, const double* sb,
                                          double (&acc)[MF][NF][4], int wm, int wn, int g,
                                          int t) {
  constexpr int KV = MK / 4;
  double bf[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) load4(sb + (wn * WN + f * 8 + g) * LDS, t, bf[f]);
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    double a0[4], a1[4];  // rows g and g + 8 of the fragment
    load4(sa + (wm * WM + m * 16 + g) * LDS, t, a0);
    load4(sa + (wm * WM + m * 16 + g + 8) * LDS, t, a1);
#pragma unroll
    for (int s = 0; s < KT / MK; ++s) {
      double af[2 * KV];
#pragma unroll
      for (int v = 0; v < KV; ++v) {
        af[2 * v] = a0[s * KV + v];
        af[2 * v + 1] = a1[s * KV + v];
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) Mma<MK>::run(acc[m][f], af, bf[f] + s * KV);
    }
  }
}

template <bool MIRROR, bool VEC16, int MK>
__global__ void __launch_bounds__(THREADS, 1) syrk_f64_kernel(Args p) {
  extern __shared__ __align__(16) double smem[];
  const long long i0 = p.tiles[2 * blockIdx.x], j0 = p.tiles[2 * blockIdx.x + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N, g = lane >> 2, t = lane & 3;

  double acc[MF][NF][4];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.0;

  const int nk = static_cast<int>((p.b + KT - 1) / KT);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<VEC16>(smem + s * STAGE, smem + s * STAGE + TILE * LDS, p, i0, j0,
                                  static_cast<long long>(s) * KT, tid);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();        // ... every thread's; step kt - 1's stage is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      double* st = smem + (pf % STAGES) * STAGE;
      load_stage<VEC16>(st, st + TILE * LDS, p, i0, j0, static_cast<long long>(pf) * KT, tid);
    }
    cp_commit();
    const double* st = smem + (kt % STAGES) * STAGE;
    mma_stage<MK>(st, st + TILE * LDS, acc, wm, wn, g, t);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the tile goes there

  double* cs = smem;
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int r = wm * WM + m * 16 + g, c = wn * WN + f * 8 + 2 * t;
      cs[r * LDC + c] = acc[m][f][0];
      cs[r * LDC + c + 1] = acc[m][f][1];
      cs[(r + 8) * LDC + c] = acc[m][f][2];
      cs[(r + 8) * LDC + c + 1] = acc[m][f][3];
    }
  __syncthreads();

  // (i, j) <- S(i, j) - C(i, j) on the lower entries: a warp on rows
  // warp + 8 q, a lane on columns lane + 32 e; every load first
  constexpr int RQ = TILE / (THREADS / 32), CE = TILE / 32;
  double sv[RQ][CE];
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const long long gi = i0 + warp + q * (THREADS / 32);
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const long long gj = j0 + lane + 32 * e;
      sv[q][e] = (gi < p.iend && gj < p.n && gj <= gi) ? p.A[(gi - p.off) * p.lda + gj] : 0.0;
    }
  }
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const int r = warp + q * (THREADS / 32);
    const long long gi = i0 + r;
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const int c = lane + 32 * e;
      const long long gj = j0 + c;
      if (gi < p.iend && gj < p.n && gj <= gi) {
        const double v = sv[q][e] - cs[r * LDC + c];
        p.A[(gi - p.off) * p.lda + gj] = v;
        if (MIRROR) cs[r * LDC + c] = v;
      }
    }
  }
  if (MIRROR) {  // (j, i) <- (i, j) for i > j, a row j per warp (off = 0)
    __syncthreads();
    const long long ilast = (i0 + TILE < p.iend ? i0 + TILE : p.iend) - 1;
    for (int c = warp; c < TILE; c += THREADS / 32) {
      const long long gj = j0 + c;
      if (gj >= p.n || gj >= ilast) break;
      double* row = p.A + (gj - p.off) * p.lda;
      for (int r = lane; r < TILE; r += 32) {
        const long long gi = i0 + r;
        if (gi < p.iend && gi > gj) row[gi] = cs[r * LDC + c];
      }
    }
  }
}

// 16-byte copies need every staged row 16-byte aligned (and b even, so that
// a copy never straddles the k tail into the columns being written)
inline bool rows_16b_aligned(const Args& p) {
  return reinterpret_cast<uintptr_t>(p.Ta) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.Tb) % 16 == 0 && p.lda % 2 == 0 && p.ldb % 2 == 0 &&
         p.b % 2 == 0;
}

template <bool MIRROR, bool VEC16, int MK>
int launch_vec(const Args& p, long long ntiles, cudaStream_t s) {
  const auto kernel = syrk_f64_kernel<MIRROR, VEC16, MK>;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  if (err) return err;
  kernel<<<static_cast<unsigned>(ntiles), THREADS, SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the copy width from the operands' alignment, then the launch
template <bool MIRROR, int MK>
int launch(const Args& p, long long ntiles, cudaStream_t s) {
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(p.A) % 8 || reinterpret_cast<uintptr_t>(p.Tb) % 8 ||
      reinterpret_cast<uintptr_t>(p.tiles) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return rows_16b_aligned(p) ? launch_vec<MIRROR, true, MK>(p, ntiles, s)
                             : launch_vec<MIRROR, false, MK>(p, ntiles, s);
}

}  // namespace syrk
}  // namespace
