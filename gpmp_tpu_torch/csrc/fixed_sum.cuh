// gpmp_tpu_torch/csrc/fixed_sum.cuh
//
// Fixed-order f64 sums across a block and across a grid, in one launch:
// the finish of the one-launch reductions K7 (csrc/mixed.cu) and K10t
// (csrc/streamed.cu).  Every sum runs in one order that depends only on the
// launch geometry, never on which block finishes last: bitwise
// reproducible, with no atomics on the values.
//
//   block_sum: Q values of each of THREADS threads summed by a butterfly
//     over each warp's lanes (__shfl_xor_sync, strides 16, 8, 4, 2, 1),
//     then the warps' sums in warp order by thread 0 (which holds the
//     result);
//   grid_sum: each block's block_sum into partial[Q b + q]; the last block
//     to take the ticket, after a __threadfence, sums the partials (thread
//     t the blocks t, t + THREADS, ... in order, then block_sum) and resets
//     the ticket; true in that block's thread 0, which holds the totals.
// ops/mixed.py and ops/streamed.py (the walks of tests/
// test_torch_trace_sums.py) repeat this order.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace fixed_sum {

template <int Q, int THREADS>
struct Smem {
  double warp[THREADS / 32][Q];
  int last;
};

template <int Q, int THREADS>
__device__ __forceinline__ void block_sum(Smem<Q, THREADS>& sm, double (&v)[Q]) {
  static_assert(THREADS % 32 == 0, "whole warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], m);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) sm.warp[warp][q] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      double s = sm.warp[0][q];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) s += sm.warp[w][q];
      v[q] = s;
    }
  }
}

// partial: Q doubles a block of the grid; ticket: zero between launches
template <int Q, int THREADS>
__device__ __forceinline__ bool grid_sum(Smem<Q, THREADS>& sm, double (&v)[Q],
                                         double* __restrict__ partial,
                                         unsigned int* __restrict__ ticket) {
  block_sum(sm, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) partial[Q * blockIdx.x + q] = v[q];
    __threadfence();  // the partials are visible before the ticket counts them
    sm.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();  // also: thread 0 has read sm.warp
  if (!sm.last) return false;
  __threadfence();
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += THREADS) {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] += __ldcg(partial + Q * b + q);
  }
  block_sum(sm, v);
  if (threadIdx.x == 0) *ticket = 0u;
  return threadIdx.x == 0;
}

}  // namespace fixed_sum
}  // namespace
