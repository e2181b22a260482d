// gpmp_tpu_torch/csrc/syrk_f64.cuh
//
// The f64 tensor-core core of the port's symmetric products, included by
// csrc/syrk.cu (K9u, the blocked Cholesky's trailing update, and K9s f64,
// its slab form) and csrc/residual.cu (K4, the factorization residual
// K - L L^T, K4s, its slab form, and K8s, the sampling root's residual
// E = K - L L^T kept in f64); see there for what each kernel replaces and
// what bounds it.  csrc/chol.cu's K8t takes only the mma and cp.async
// helpers.  One device kernel, one instance per mode:
// for each listed TILE x TILE output tile (i0, j0),
//
//      O[i - off, j] = S[i - off, j] - sum_{k < kend} Ta[i, k] Tb[j, k]
//
// with the products and the sums in f64 and O rounded to its type; the
// mode (a struct of types and flags, below) says
//   - the operand type TA: f64 (K9), or f32 widened to f64 as the fragments
//     are formed (K4, K8s: an f32 x f32 product is exact in f64);
//   - the output type TO: f32 (K4, K4s) or f64 (K9, K8s);
//   - LOWER: only the entries i >= j (K9u, K9s, K4, K8s); K4s writes its
//     whole column block;
//   - MIRROR: the same value also stored at (j, i) (K9u, K4, K8s): O stays
//     exactly symmetric;
//   - TRI: the operands are rows of a lower-triangular factor, so the sum
//     stops at kend = min(last row, last column) + 1 of the tile (K4, K4s,
//     K8s; K9 sums all b columns).
//
// Design, for Hopper (sm_90a):
// - f64 tensor cores through mma.sync.aligned.m16n8k{4,8,16}.row.col.f64
//   (wgmma has no f64 form).  A block of WARPS_M x WARPS_N warps owns the
//   tile; each warp a (TILE / WARPS_M) x (TILE / WARPS_N) sub-tile of m16n8
//   fragments.  Two geometries: 128 x 128 tiles of 8 warps (64 f64
//   accumulators a thread, one block per SM; K9u, K9s), and 64 x 64 tiles
//   of 4 warps (32 accumulators, two blocks per SM; K4, K4s, K8s), which keep
//   the SMs busy at small n, where 128-wide tiles leave most of them idle.
// - k advances 16 columns a step through a ring of STAGES stages in dynamic
//   shared memory, filled by cp.async (16-byte .cg copies where every row
//   is 16-byte aligned, else 8-byte (f64) or 4-byte (f32) .ca copies;
//   zero-fill past the ragged rows and the k tail), so the loads of step
//   k + 3 overlap the products of step k.  f32 operands are staged as f32:
//   half the ring's bytes.
// - A lane feeds its mma k slots of a stage (t, t + 4, t + 8, t + 12 of the
//   16) with the stage's columns 4t .. 4t + 3, the same for both operands
//   (a sum over k in another fixed order), so its fragments come as two
//   16-byte shared loads per row (one for f32); staged f64 rows are padded
//   to LDS = 18 doubles (9 16-byte units, odd), f32 rows stay 16 floats
//   (4 units), so each quarter warp's 16-byte loads hit 8 distinct bank
//   groups either way.
// - Each output sums its products in one fixed order (the k steps in order
//   from k = 0, each step's mma in order), whatever the tile, its size or
//   the mode: K9s at one rank is bitwise K9u's lower triangle; K4s at one
//   rank is bitwise K4 (the steps past a tile's kend add exact zeros, and an
//   entry computed with the operands' roles swapped sums the same exact
//   products in the same slots); K8s holds the f64 value S - C that K4
//   rounds to f32, so K8s rounded to f32 is bitwise K4.
// - Epilogue: the tile goes to shared memory (the ring reused, rows padded
//   to an odd LDC so that column reads are conflict-free); each thread then
//   loads all of its S entries before it stores any, so the loads are in
//   flight together, writes O = S - C there (a warp on a row: coalesced),
//   and, with MIRROR, writes the transposed rows (j, i) from the same
//   values, rounded once (coalesced rows again).
// - In place is safe (K9: S = O = A): the operands are read only in the
//   panel's columns [c0, c0 + b), which no block writes; S is read only at
//   the entries of the block's own tile that it writes, and the mirror
//   writes only entries above the diagonal, which no block reads.
// - The tile list is built by the caller (gpmp_tpu_torch/ops/chol.py,
//   gpmp_tpu_torch/ops/mixed.py): only tiles that meet the written region
//   are launched (the diagonal ones masked entrywise by i >= j), K4's and
//   K4s's longest k range first.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace syrk {

constexpr int KT = 16;      // k columns per stage: 4 a lane
constexpr int STAGES = 4;   // depth of the ring

// a TILE x TILE output tile on WARPS_M x WARPS_N warps; MIN_BLOCKS per SM
template <int TILE_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_>
struct Geo {
  static constexpr int TILE = TILE_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;  // a warp's sub-tile
  static constexpr int MF = WM / 16, NF = WN / 8;                 // its m16n8 fragments
  static constexpr int LDC = TILE + 1;                            // padded epilogue row
};
using Big = Geo<128, 2, 4, 1>;    // a warp's 64 x 32: 4 x 4 fragments
using Small = Geo<64, 2, 2, 2>;   // a warp's 32 x 32: 2 x 4 fragments
constexpr int TILE = Big::TILE;

template <typename T>
struct Staged;
template <>
struct Staged<double> {
  static constexpr int LDS = KT + 2;  // padded staged row, doubles
};
template <>
struct Staged<float> {
  static constexpr int LDS = KT;      // staged row, floats
};

template <class G, typename TA>
struct Smem {
  static constexpr int LDS = Staged<TA>::LDS;
  static constexpr int STAGE = 2 * G::TILE * LDS;  // elements of TA per stage
  static constexpr int RING = STAGES * STAGE * static_cast<int>(sizeof(TA));
  static constexpr int EPI = G::TILE * G::LDC * static_cast<int>(sizeof(double));
  static constexpr int BYTES = RING > EPI ? RING : EPI;
  static_assert(BYTES <= 232448, "the ring and the epilogue tile fit in 227 KB");
};

// ------------------------------------------------------------------ modes
struct Trailing {  // K9u: A -= T T^T in place, mirrored
  using TA = double;
  using TS = double;
  using TO = double;
  static constexpr bool LOWER = true, MIRROR = true, TRI = false;
};
struct Slab {  // K9s f64: a slab's lower trapezoid in place
  using TA = double;
  using TS = double;
  using TO = double;
  static constexpr bool LOWER = true, MIRROR = false, TRI = false;
};
template <typename T>
struct Residual {  // K4: R = f32(K - L L^T) on the lower tiles, mirrored
  using TA = float;
  using TS = T;
  using TO = float;
  static constexpr bool LOWER = true, MIRROR = true, TRI = true;
};
struct SamplingResidual {  // K8s: E = K - L L^T in f64 on the lower tiles, mirrored
  using TA = float;
  using TS = double;
  using TO = double;
  static constexpr bool LOWER = true, MIRROR = true, TRI = true;
};
struct ResidualSlab {  // K4s: a (rows, rows_b) column block of f32(K - La Lb^T)
  using TA = float;
  using TS = double;
  using TO = float;
  static constexpr bool LOWER = false, MIRROR = false, TRI = true;
};

template <class M>
struct Args {
  typename M::TO* O;        // output: O[(i - off) * ldo + j] for global rows i in [off, iend)
  const typename M::TS* S;  // source, the same layout (K9: S = O = A, in place)
  const typename M::TA* Ta;  // row i of the left operand at Ta + (i - off) * lda
  const typename M::TA* Tb;  // row j of the right operand at Tb + (j - joff) * ldb
  const int* tiles;          // (i0, j0) of block b at tiles[2 b], tiles[2 b + 1]
  long long ldo, lda, ldb, off, iend, joff, jend, b;  // columns j < jend; k < b
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

// cp.async of BYTES bytes with zero-fill: ok = false copies no byte and
// writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(ok ? BYTES : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one stage: rows i0.. of Ta and j0.. of Tb, columns [k0, k0 + KT) (those
// below kend), into the (TILE, LDS) arrays sa and sb, CPB bytes a copy
template <class G, class M, int CPB>
__device__ __forceinline__ void load_stage(typename M::TA* sa, typename M::TA* sb,
                                           const Args<M>& p, long long i0, long long j0,
                                           long long k0, long long kend, int tid) {
  using TA = typename M::TA;
  constexpr int LDS = Staged<TA>::LDS;
  constexpr int W = CPB / static_cast<int>(sizeof(TA));  // elements per copy
  constexpr int PER_ROW = KT / W;
  constexpr int PER_THREAD = G::TILE * PER_ROW / G::THREADS;
  static_assert(PER_THREAD * G::THREADS == G::TILE * PER_ROW, "whole copies a thread");
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int c = tid + q * G::THREADS;
    const int r = c / PER_ROW, kc = (c % PER_ROW) * W;
    const long long gk = k0 + kc, gi = i0 + r, gj = j0 + r;
    const bool oka = gk < kend && gi < p.iend, okb = gk < kend && gj < p.jend;
    const TA* srca = oka ? p.Ta + (gi - p.off) * p.lda + gk : p.Ta;
    const TA* srcb = okb ? p.Tb + (gj - p.joff) * p.ldb + gk : p.Tb;
    cp_async<CPB>(sa + r * LDS + kc, srca, oka);
    cp_async<CPB>(sb + r * LDS + kc, srcb, okb);
  }
}

// a lane's 4 staged columns 4t .. 4t + 3 of one row, widened to f64
__device__ __forceinline__ void load4(const double* row, int t, double (&v)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(row + 4 * t);
  const double2 hi = *reinterpret_cast<const double2*>(row + 4 * t + 2);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* row, int t, double (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(row + 4 * t);
  v[0] = static_cast<double>(q.x);
  v[1] = static_cast<double>(q.y);
  v[2] = static_cast<double>(q.z);
  v[3] = static_cast<double>(q.w);
}

// the warp's fragments over one staged k step, MK columns per mma: mma step
// s takes the lane's columns 4t + s KV .. 4t + (s + 1) KV - 1 into its
// slots t + 4 v (v < KV), for both operands
template <class G, int MK, typename TA>
__device__ __forceinline__ void mma_stage(const TA* sa, const TA* sb,
                                          double (&acc)[G::MF][G::NF][4], int wm, int wn,
                                          int g, int t) {
  constexpr int KV = MK / 4;
  constexpr int LDS = Staged<TA>::LDS;
  double bf[G::NF][4];
#pragma unroll
  for (int f = 0; f < G::NF; ++f) load4(sb + (wn * G::WN + f * 8 + g) * LDS, t, bf[f]);
#pragma unroll
  for (int m = 0; m < G::MF; ++m) {
    double a0[4], a1[4];  // rows g and g + 8 of the fragment
    load4(sa + (wm * G::WM + m * 16 + g) * LDS, t, a0);
    load4(sa + (wm * G::WM + m * 16 + g + 8) * LDS, t, a1);
#pragma unroll
    for (int s = 0; s < KT / MK; ++s) {
      double af[2 * KV];
#pragma unroll
      for (int v = 0; v < KV; ++v) {
        af[2 * v] = a0[s * KV + v];
        af[2 * v + 1] = a1[s * KV + v];
      }
#pragma unroll
      for (int f = 0; f < G::NF; ++f) Mma<MK>::run(acc[m][f], af, bf[f] + s * KV);
    }
  }
}

// the tile's epilogue from C staged in cs (TILE x LDC doubles): O = S - C
// on the written entries, a warp on rows warp + NW q, a lane on columns
// lane + 32 e, every load of S first; with MIRROR the transposed rows (j, i)
// from the same rounded values, a row j per warp (off = 0)
template <class M, class G>
__device__ __forceinline__ void epilogue(const Args<M> p, double* cs, long long i0,
                                         long long j0, int warp, int lane) {
  using TO = typename M::TO;
  constexpr int TILE = G::TILE, LDC = G::LDC;
  constexpr int NW = G::THREADS / 32, RQ = TILE / NW, CE = TILE / 32;
  double sv[RQ][CE];
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const long long gi = i0 + warp + q * NW;
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const long long gj = j0 + lane + 32 * e;
      sv[q][e] = (gi < p.iend && gj < p.jend && (!M::LOWER || gj <= gi))
                     ? static_cast<double>(p.S[(gi - p.off) * p.ldo + gj])
                     : 0.0;
    }
  }
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const int r = warp + q * NW;
    const long long gi = i0 + r;
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      const int c = lane + 32 * e;
      const long long gj = j0 + c;
      if (gi < p.iend && gj < p.jend && (!M::LOWER || gj <= gi)) {
        const TO v = static_cast<TO>(sv[q][e] - cs[r * LDC + c]);
        p.O[(gi - p.off) * p.ldo + gj] = v;
        if (M::MIRROR) cs[r * LDC + c] = static_cast<double>(v);
      }
    }
  }
  if (M::MIRROR) {
    __syncthreads();
    const long long ilast = (i0 + TILE < p.iend ? i0 + TILE : p.iend) - 1;
    for (int c = warp; c < TILE; c += NW) {
      const long long gj = j0 + c;
      if (gj >= p.jend || gj >= ilast) break;
      TO* row = p.O + (gj - p.off) * p.ldo;
      for (int r = lane; r < TILE; r += 32) {
        const long long gi = i0 + r;
        if (gi < p.iend && gi > gj) row[gi] = static_cast<TO>(cs[r * LDC + c]);
      }
    }
  }
}

template <class M, class G, int CPB, int MK>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS) mma_tile_kernel(Args<M> p) {
  using TA = typename M::TA;
  constexpr int TILE = G::TILE, LDC = G::LDC;
  constexpr int STAGE = Smem<G, TA>::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* ring = reinterpret_cast<TA*>(smem_raw);
  const long long i0 = p.tiles[2 * blockIdx.x], j0 = p.tiles[2 * blockIdx.x + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N, g = lane >> 2, t = lane & 3;

  // the sum's extent: all b columns, or (TRI) up to the tile's last row or
  // column, past which one operand's rows of the triangular factor are zero
  long long kend = p.b;
  if (M::TRI) {
    const long long ilast = (i0 + TILE < p.iend ? i0 + TILE : p.iend) - 1;
    const long long jlast = (j0 + TILE < p.jend ? j0 + TILE : p.jend) - 1;
    const long long kt = (ilast < jlast ? ilast : jlast) + 1;
    kend = kt < kend ? kt : kend;
  }

  double acc[G::MF][G::NF][4];
#pragma unroll
  for (int m = 0; m < G::MF; ++m)
#pragma unroll
    for (int f = 0; f < G::NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.0;

  const int nk = static_cast<int>((kend + KT - 1) / KT);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<G, M, CPB>(ring + s * STAGE, ring + s * STAGE + TILE * Staged<TA>::LDS, p, i0,
                            j0, static_cast<long long>(s) * KT, kend, tid);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();        // ... every thread's; step kt - 1's stage is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      TA* st = ring + (pf % STAGES) * STAGE;
      load_stage<G, M, CPB>(st, st + TILE * Staged<TA>::LDS, p, i0, j0,
                            static_cast<long long>(pf) * KT, kend, tid);
    }
    cp_commit();
    const TA* st = ring + (kt % STAGES) * STAGE;
    mma_stage<G, MK, TA>(st, st + TILE * Staged<TA>::LDS, acc, wm, wn, g, t);
  }
  cp_wait<0>();

  __syncthreads();  // the ring is free: the tile goes there

  double* cs = reinterpret_cast<double*>(smem_raw);
#pragma unroll
  for (int m = 0; m < G::MF; ++m)
#pragma unroll
    for (int f = 0; f < G::NF; ++f) {
      const int r = wm * G::WM + m * 16 + g, c = wn * G::WN + f * 8 + 2 * t;
      cs[r * LDC + c] = acc[m][f][0];
      cs[r * LDC + c + 1] = acc[m][f][1];
      cs[(r + 8) * LDC + c] = acc[m][f][2];
      cs[(r + 8) * LDC + c + 1] = acc[m][f][3];
    }
  __syncthreads();
  epilogue<M, G>(p, cs, i0, j0, warp, lane);
}

// 16-byte copies need every staged row 16-byte aligned; for f64 operands
// also b even, so that a copy never straddles the k tail into the columns
// being written (K9, in place).  f32 operands (K4, not in place) may read
// past kend within a row: the triangular factor's entries there meet zeros
// of the other operand's rows (exact zero products).
template <class M>
inline bool rows_16b_aligned(const Args<M>& p) {
  constexpr long long W = 16 / sizeof(typename M::TA);
  return reinterpret_cast<uintptr_t>(p.Ta) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.Tb) % 16 == 0 && p.lda % W == 0 && p.ldb % W == 0 &&
         (sizeof(typename M::TA) == 4 || p.b % 2 == 0);
}

template <class M, class G, int CPB, int MK>
int launch_copy(const Args<M>& p, long long ntiles, cudaStream_t s) {
  const auto kernel = mma_tile_kernel<M, G, CPB, MK>;
  constexpr int SMEM = Smem<G, typename M::TA>::BYTES;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
  if (err) return err;
  kernel<<<static_cast<unsigned>(ntiles), G::THREADS, SMEM, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the copy width from the operands' alignment, then the launch
template <class M, class G, int MK>
int launch(const Args<M>& p, long long ntiles, cudaStream_t s) {
  constexpr int NARROW = static_cast<int>(sizeof(typename M::TA));  // 8 (f64) or 4 (f32)
  if (ntiles <= 0 || ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(p.O) % sizeof(typename M::TO) ||
      reinterpret_cast<uintptr_t>(p.S) % sizeof(typename M::TS) ||
      reinterpret_cast<uintptr_t>(p.Ta) % NARROW || reinterpret_cast<uintptr_t>(p.Tb) % NARROW ||
      reinterpret_cast<uintptr_t>(p.tiles) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return rows_16b_aligned(p) ? launch_copy<M, G, 16, MK>(p, ntiles, s)
                             : launch_copy<M, G, NARROW, MK>(p, ntiles, s);
}

}  // namespace syrk
}  // namespace
