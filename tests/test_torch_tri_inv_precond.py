# tests/test_torch_tri_inv_precond.py
"""K5 (the diagonal-block triangular inverse) and K6 (the preconditioner
apply M^T (M r)) of the mixed engine, gpmp_tpu_torch.ops.mixed, on the CPU.

The kernels run only on a CUDA card (chip_smoke.py phases 2b, 2d and 2f hold
them to their plain versions there).  Here:

- K5's plain version, which follows the kernel's order (8-wide leaves by
  substitution, then the doubling levels X21 = -(X22 (A21 X11))), against
  torch.linalg.solve_triangular in f64 and against gpmp_tpu's
  ``_block_tri_inv`` base case (one triangular solve a block), rel 1e-5 at
  cond(K) = 1e4 (f32 inverses in another order, each ~eps32 cond(L) off),
  bases 7, 64 and 128, n 100, 300 and 1000 (ragged last blocks); exact zeros
  above the diagonal, a ragged block's identity exact; the working size;
- K6's launch plan (``precond_plan``; each band's first chunk and count, as
  the kernel works them out): pass 2's row chunks tile the rows, every
  entry of a slab's lower triangle falls in
  exactly one nonempty (band, chunk) block and no entry of it in a skipped
  one, and a walk that sums each chunk's part of M^T y and then the chunks
  in order equals ``precond_apply_plain`` and gpmp_tpu's ``_apply`` within
  rel 1e-6 (f32 sums in another order, tests/test_torch_streamed.py's bar),
  the slabs' parts summing to the square product;
- the wrappers refuse CPU tensors.

The inputs are built once per module (the ``inputs`` fixture), numpy's BLAS
on one thread: beside the suite's other workers, its thread pool made each
n = 1000 input take 15-40 s.
"""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import gpmp_tpu.num as jgnp  # noqa: F401  (enables x64 in the JAX package)
from gpmp_tpu.ops import mixed as jmixed

from gpmp_tpu_torch import config
from gpmp_tpu_torch.ops import mixed

H100_SMS = 132  # the card's SM count, as K6's wrapper reads it there


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    with threadpool_limits(1, user_api="blas"):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        return Q @ np.diag(np.logspace(0, -np.log10(cond), n)) @ Q.T


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _l32(n, seed):
    L32, _ = mixed._f32_preconditioner(torch.as_tensor(_spd(n, 1e4, seed)))
    return L32


class _Inputs:
    """Each f32 factor (by n and seed), M = L32^{-1} and jitted JAX function
    made once for the module (none of them is written to)."""

    def __init__(self):
        self._cache = {}

    def _get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def l32(self, n, seed):
        return self._get(("l32", n, seed), lambda: _l32(n, seed))

    def m32(self, n, seed):
        return self._get(("m32", n, seed), lambda: mixed._block_tri_inv(self.l32(n, seed)))

    def jax_base_case(self, blocks):
        """gpmp_tpu's _block_tri_inv on each (base, base) block: its base
        case, one triangular solve."""
        base = blocks.shape[-1]
        fn = self._get(("base case", base), lambda: jax.jit(
            jax.vmap(lambda A: jmixed._block_tri_inv(A, base))))
        return np.asarray(fn(blocks))

    def jax_block_tri_inv(self, L32, base):
        fn = self._get("block_tri_inv", lambda: jax.jit(jmixed._block_tri_inv,
                                                        static_argnums=1))
        return np.asarray(fn(L32, base))

    def jax_apply(self, M32, R):
        return np.asarray(self._get("apply", lambda: jax.jit(jmixed._apply))(M32, R))


@pytest.fixture(scope="module")
def inputs():
    return _Inputs()


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 300, 1000])
@pytest.mark.parametrize("base", [7, 64, 128])
def test_k5_plain_matches_solve_and_jax(n, base, inputs):
    L32 = inputs.l32(n, n + base)
    X = mixed.diag_block_inv_plain(L32, base)
    nb = -(-n // base)
    assert X.dtype == torch.float32 and X.shape == (nb, base, base)
    assert bool((torch.triu(X, 1) == 0).all())
    A = mixed._diag_blocks(L32, base)
    ref = torch.linalg.solve_triangular(A.double(), torch.eye(base, dtype=torch.float64).expand(
        A.shape), upper=False)
    assert _rel(X.numpy(), ref.numpy()) <= 1e-5
    assert _rel(X.numpy(), inputs.jax_base_case(A.numpy())) <= 1e-5
    r = n - (nb - 1) * base  # the last block's rows of L; the rest identity
    if r < base:
        assert torch.equal(X[-1, r:, r:], torch.eye(base - r))
        assert bool((X[-1, r:, :r] == 0).all())


def test_k5_diag_blocks_and_sizes():
    """_diag_blocks (views of the full blocks, the ragged one copied) and the
    kernel's working size."""
    L = torch.tril(torch.arange(1.0, 1 + 300 * 300).reshape(300, 300))
    for base in (1, 7, 64, 128, 300):
        B = mixed._diag_blocks(L, base)
        for b in range(B.shape[0]):
            r0, r1 = b * base, min(300, (b + 1) * base)
            assert torch.equal(B[b, : r1 - r0, : r1 - r0], L[r0:r1, r0:r1])
            assert torch.equal(B[b, r1 - r0:, r1 - r0:], torch.eye(base - (r1 - r0)))
    sizes = {b: mixed.tri_inv_size(b) for b in (1, 7, 8, 9, 64, 65, 100, 128)}
    assert sizes == {1: 8, 7: 8, 8: 8, 9: 16, 64: 64, 65: 128, 100: 128, 128: 128}


def test_k5_block_tri_inv_on_the_plain_blocks(inputs):
    """The port's _block_tri_inv (K5's plain version, then the products)
    against gpmp_tpu's at n = 1000, base 128 (8 blocks, a ragged last one of
    104 rows), rel 1e-5."""
    L32 = inputs.l32(1000, 5)
    M = inputs.m32(1000, 5).numpy()
    Mj = inputs.jax_block_tri_inv(L32.numpy(), 128)
    assert np.all(np.triu(M, 1) == 0) and _rel(M, Mj) <= 1e-5


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------
PLANS = [(1, 1), (100, 100), (1000, 1000), (1001, 1001), (4099, 4099), (8192, 8192),
         (32768, 32768), (51200, 51200), (2050, 4099), (4096, 8192)]


@pytest.mark.parametrize("rows,n", PLANS)
def test_k6_plan_tiles_the_rows(rows, n):
    warps, chunks, height = mixed.precond_plan(rows, n, H100_SMS)
    step = mixed.PRECOND_WARPS * mixed.PRECOND_ROWS
    assert warps in (1, 2, 4, 8) and height % step == 0 and height > 0
    assert (chunks - 1) * height < rows <= chunks * height and chunks <= 65535
    assert height <= mixed.PRECOND_MAX_CHUNK
    target = mixed.PRECOND_BLOCKS_PER_SM * H100_SMS
    row_warps = -(-rows // mixed.PRECOND_ROWS)
    # pass 1: 8 warps a block, halved while that leaves the card short of blocks
    assert -(-row_warps // warps) >= target or warps == 1
    assert warps == mixed.PRECOND_WARPS or -(-row_warps // (2 * warps)) < target
    if (rows, n) == (1000, 1000):
        assert (warps, chunks, height) == (1, 32, 32)
    if (rows, n) == (32768, 32768):
        assert (warps, chunks, height) == (8, 32, 1024)


def _band_chunks(rows, n, off, height):
    """K6 pass 2's blocks of each column band of a slab (global rows [off,
    off + rows)), as the kernel works them out: per band, (first chunk,
    chunks summed), from the chunk holding the band's first row of the
    triangle to the last ((0, 0): no row of the slab reaches the band)."""
    chunks = -(-rows // height)
    plan = []
    for j0 in range(0, n, mixed.PRECOND_BAND):
        rstar = j0 - off
        ch0 = max(rstar, 0) // height
        plan.append((0, 0) if rstar >= rows else (ch0, chunks - ch0))
    return plan


def _coverage(rows, n, off, height):
    """How many (band, chunk) blocks, taken as the kernel takes them, hold
    each entry of the slab: a block's rows run from the later of its chunk's
    first row and the band's first row of the triangle; its entries are
    those on or below the diagonal."""
    cover = torch.zeros((rows, n), dtype=torch.int32)
    plan = _band_chunks(rows, n, off, height)
    for b, (ch0, count) in enumerate(plan):
        j0, j1 = b * mixed.PRECOND_BAND, min(n, (b + 1) * mixed.PRECOND_BAND)
        if count == 0:  # no row of the slab reaches the band
            assert j0 - off >= rows
            continue
        assert ch0 + count == -(-rows // height)
        for ch in range(ch0, ch0 + count):
            rbeg, rend = max(ch * height, j0 - off), min((ch + 1) * height, rows)
            assert rbeg < rend  # no nonempty block is empty
            gi = torch.arange(rbeg, rend)[:, None] + off
            cover[rbeg:rend, j0:j1] += (torch.arange(j0, j1)[None, :] <= gi).int()
        # the chunks before ch0 hold no entry of the band's triangle
        assert ch0 * height + off <= j0 or ch0 == 0
    return cover


@pytest.mark.parametrize("rows,n,off", [(100, 100, 0), (1000, 1000, 0), (1001, 1001, 0),
                                        (500, 1000, 0), (500, 1000, 500), (333, 1000, 667),
                                        (300, 1000, 350)])
def test_k6_blocks_cover_the_triangle_once(rows, n, off):
    _, _, height = mixed.precond_plan(rows, n, H100_SMS)
    for h in {height, 32, 96}:
        cover = _coverage(rows, n, off, h)
        lower = torch.arange(n)[None, :] <= (torch.arange(rows)[:, None] + off)
        assert torch.equal(cover, lower.int())


def _k6_walk(M32, R, off=0):
    """K6 as the kernel cuts it, on a (rows, n) slab of M at global rows
    [off, off + rows): y = M r32 over each row's triangle, then each band's
    chunks of M^T y summed alone and in chunk order (f32).  Every (band,
    chunk) block's product at once; a block's rows above the band's
    triangle (and the chunks before its first, _band_chunks) hold only the
    zeros of tril, so their products are exact zeros, which the sum in
    chunk order adds unchanged."""
    rows, n = M32.shape
    _, chunks, height = mixed.precond_plan(rows, n, H100_SMS)
    band = mixed.PRECOND_BAND
    bands = -(-n // band)
    Mt = torch.tril(M32, off)  # the entries the kernel reads: j <= off + i
    y = Mt @ R.float()
    k = R.shape[1]
    Mp = torch.zeros((chunks * height, bands * band), dtype=torch.float32)
    Mp[:rows, :n] = Mt
    yp = torch.zeros((chunks * height, k), dtype=torch.float32)
    yp[:rows] = y
    # blocks[b, ch] = Mt[chunk ch's rows, band b's columns]^T y[chunk ch's rows]
    blocks = Mp.reshape(chunks, height, bands, band).permute(2, 0, 3, 1) @ yp.reshape(
        chunks, height, k)
    out = torch.zeros((bands, band, k), dtype=torch.float32)
    for ch in range(chunks):
        out += blocks[:, ch]
    return out.reshape(bands * band, k)[:n]


@pytest.mark.parametrize("n,k", [(300, 2), (1000, 1), (1000, 8), (1001, 3)])
def test_k6_walk_matches_plain_and_jax(n, k, inputs):
    M32 = inputs.m32(n, 3 * n + k)
    R = torch.as_tensor(np.random.default_rng(n + k).normal(size=(n, k)))
    walk = _k6_walk(M32, R)
    plain = mixed.precond_apply_plain(M32, R)
    ref = inputs.jax_apply(M32.numpy(), R.numpy())
    assert _rel(walk.double().numpy(), plain.numpy()) <= 1e-6
    assert _rel(walk.double().numpy(), ref) <= 1e-6
    # two ranks' slabs: their parts sum to the square product
    h = n // 2
    parts = _k6_walk(M32[:h].contiguous(), R, 0) + _k6_walk(M32[h:].contiguous(), R, h)
    assert _rel(parts.double().numpy(), plain.numpy()) <= 1e-6
    slab = mixed.precond_apply_slab_plain(M32[h:].contiguous(), R)
    assert _rel(_k6_walk(M32[h:].contiguous(), R, h).numpy(), slab.numpy()) <= 1e-6


def test_k5_k6_wrappers_refuse():
    """CPU tensors to the *_cuda entries raise; none falls back."""
    L = _l32(64, 1)
    R = torch.ones((64, 2), dtype=torch.float64)
    for call in (lambda: mixed.diag_block_inv_cuda(L, 16),
                 lambda: mixed.precond_apply_cuda(L, R),
                 lambda: mixed.precond_apply_slab_cuda(L[:32].contiguous(), R, 0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = (mixed.K5_LAUNCHES, mixed.K6_LAUNCHES)
    assert torch.equal(mixed.diag_block_inv(L, 16), mixed.diag_block_inv_plain(L, 16))
    assert torch.equal(mixed._apply(L, R), mixed.precond_apply_plain(L, R))
    assert (mixed.K5_LAUNCHES, mixed.K6_LAUNCHES) == before
