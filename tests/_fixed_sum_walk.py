# tests/_fixed_sum_walk.py
"""csrc/fixed_sum.cuh's order of sums in numpy, for the walks of the port's
one-launch reductions (tests/test_torch_trace_sums.py: K10t and K7;
tests/test_torch_distance_walk.py: the K1d pullbacks).  No JAX."""

import numpy as np

THREADS = 256  # the kernels' blocks


def block_sum(v):
    """block_sum over the last axis (THREADS threads): a butterfly over each
    warp's 32 lanes (v[l] + v[l ^ m], m = 16 .. 1), then the warps' lane-0
    values in warp order."""
    w = v.reshape(v.shape[:-1] + (THREADS // 32, 32))
    lane = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ m]
    s = w[..., 0, 0]
    for k in range(1, THREADS // 32):
        s = s + w[..., k, 0]
    return s


def grid_sum(v):
    """grid_sum of v (blocks, THREADS, Q): each block's block_sum into its
    partials; the last block's thread t sums the partials of blocks t,
    t + THREADS, ... in order, then block_sum."""
    part = block_sum(np.moveaxis(v, 1, -1))  # (blocks, Q)
    t = np.zeros((THREADS, v.shape[2]))
    for b0 in range(0, part.shape[0], THREADS):
        chunk = part[b0:b0 + THREADS]
        t[:len(chunk)] += chunk
    return block_sum(t.T)
