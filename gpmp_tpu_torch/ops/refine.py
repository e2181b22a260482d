# gpmp_tpu_torch/ops/refine.py
"""f64-accurate factors from f32 factorizations + f64 products.

Counterpart of gpmp_tpu/ops/refine.py.  Two users:

1. The sampling square root of the mixed engine, C C^T = K to ~1e-9
   (``sampling_sqrt``):

    L32 = chol_f32(K + ridge), M32 = L32^{-1}  (the mixed engine's f32
                                               preconditioner: cholesky_ex, K5)
    E   = K - L L^T                            (K8s, f64, L = L32 promoted)
    Dt  = M (E M^T)                            (f64 torch.matmul)
    C   = L + L Dt / 2                         (torch.addmm)

   C is not triangular; C C^T = K + L (Dt^2 / 4) L^T, and any such root
   draws paths with covariance C C^T.  The guard sum Dt^2 < 1e2 turns
   runaway cases into NaN; a non-PD K is already NaN through the f32
   Cholesky.

2. The refined panels of the blocked Cholesky (gpmp_tpu_torch/parallel/
   chol.py): ``refined_cholesky`` factors a (B, B) f64 panel from one f32
   Cholesky and f64 products,

    L0 = chol_f32(A), M = trisolve_f32(L0, I)
    M <- M (2I - L0 M)                          (Newton, ``newton_tri_inv``)
    E  = A - L L^T                              (K8r)
    L <- L + L Phi(M E M^T), M <- M (2I - L M)  (Ogita-Aishima, twice)

   with the guard |A - L L^T|_F^2 / |A|_F^2 < 1e-16 (K8r's sums) turning an
   unconverged factor into NaN; ``refined_solve_lower`` solves a panel
   T L^T = B with the refined inverse and one residual sweep
   (torch.matmul, as the JAX package's jnp.dot).

Hand-written CUDA (gpmp_tpu_torch/csrc/residual.cu, csrc/mixed.cu and
csrc/chol.cu), each with a plain PyTorch version and a launch counter:

- K8s ``sampling_residual``: K4's kernel on the f64 tensor cores (csrc/
  syrk_f64.cuh) over K4's tile list, with an output in K's dtype: for f64
  K the mode SamplingResidual (E in f64, bitwise K4 once rounded to f32),
  for f32 K K4's f32 instance itself; it launches only the lower 64 x 64
  tiles, stops each tile's k loop at its last column, and writes (i, j)
  and (j, i) from one value, so E is exactly symmetric (``K8S_LAUNCHES``);
- K8r ``refine_residual``: E = A - L L^T on the lower tiles, mirrored,
  and the guard's [sum E^2, sum A^2] in a fixed order, in one launch
  (``K8R_LAUNCHES``): K8t's geometry in NT form (``refine_residual_plan``:
  the lower 32 x 32 tiles, each over k < min(j0 + 32, b) cut into a chunk a
  warp), f64 mma.sync; the last block to finish sums the blocks' pairs
  (its workspace cached per device and b);
- K8t ``tri_product``: C = beta A + alpha A f(B) over the lower tiles only,
  f(B) = tril(B) or Phi(B), the upper triangle exact zeros: the two
  products of a Newton step and the Ogita-Aishima update
  (``K8T_LAUNCHES``).  f64 mma.sync on 32 x 32 tiles from a launch plan
  (``tri_product_plan``: the lower tiles, longest first, each tile's k
  range cut into one contiguous chunk a warp), the warps' partial tiles
  summed in warp order.

Each dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); there is no fallback between them.
JAX's ``jnp.linalg.cholesky`` and ``solve_triangular`` of the f32 panel are
``torch.linalg.cholesky_ex`` (a failed factorization is NaN, never an
exception) and ``torch.linalg.solve_triangular``.

On the card an f64 ``refined_cholesky`` replays one captured CUDA graph per
(device, b, steps, with_inverse, rtol2) (``capture.Graph``): its ~25
launches (cholesky_ex, the f32 inverse, 3 K8r, 8 K8t, the f64 products,
the guards) cost one replay's host issue instead of each its own.  Each
replay adds the graph's K8r and K8t launches to the counters, and the
graph holds K8t's and K8r's cached launch state.  Inside another capture
the sequence is recorded into that graph instead.  A capture or replay
error raises; nothing runs the panel eagerly instead.
"""

from __future__ import annotations

import collections
import functools

import torch

from . import _build, capture
from .mixed import (_F32, _check_cuda, _f32_preconditioner, _on_card, _residual_tile,
                    _residual_tiles_on, _square)

K8S_LAUNCHES = 0
K8R_LAUNCHES = 0
K8T_LAUNCHES = 0
# sum Dt^2 above this turns the root into NaN (gpmp_tpu/ops/refine.py:116)
_SQRT_GUARD = 1e2
# relative Frobenius residual^2 acceptance of the refined factor
# (gpmp_tpu/ops/refine.py:39), kept for parity.  The JAX package set it
# against the TPU's emulated-f64 products; with the card's native f64 a
# converged panel should read far below it (chip_smoke.py prints it).
_FACTOR_RTOL2 = 1e-16
_F64 = torch.float64


def sampling_residual_plain(K, L32):
    """K8s plain: K - L L^T in K's dtype (L = L32 promoted); the lower
    triangle is kept and mirrored, so the result is exactly symmetric."""
    L = L32.to(K.dtype)
    E = torch.tril(K - L @ L.T)
    return E + torch.tril(E, -1).T


def sampling_residual_cuda(K, L32):
    """K8s on the card: symmetric K - L L^T in K's dtype from the lower
    triangle, over K4's tiles (f32 K: K4's own f32 instance)."""
    global K8S_LAUNCHES
    dev = _check_cuda("K8s sampling_residual", (K, L32),
                      ((torch.float64, torch.float32), (_F32,)))
    n = _square("K8s sampling_residual", K)
    if L32.shape != K.shape:
        raise ValueError(f"K8s: L must be {tuple(K.shape)}; got {tuple(L32.shape)}")
    lib = _build.load()
    tiles = _residual_tiles_on(dev, n, _residual_tile(lib))
    out = torch.empty((n, n), dtype=K.dtype, device=dev)
    fn = (lib.gpmp_sampling_residual_mma_f64 if K.dtype == torch.float64
          else lib.gpmp_fact_residual_mma_f32)
    _build.launch("K8s sampling_residual", fn, dev, K.data_ptr(), L32.data_ptr(),
                  out.data_ptr(), tiles.data_ptr(), tiles.shape[0], n)
    K8S_LAUNCHES += 1
    return out


def sampling_residual(K, L32):
    if _on_card(K):
        return sampling_residual_cuda(K.contiguous(), L32.contiguous())
    return sampling_residual_plain(K, L32)


def sampling_sqrt(K):
    """C with C C^T ~= K (relative error ~1e-9): the sampling factor; NaN
    where the f32 factorization fails or the guard does."""
    L32, M32 = _f32_preconditioner(K)
    L, M = L32.to(K.dtype), M32.to(K.dtype)
    Dt = M @ (sampling_residual(K, L32) @ M.T)
    ok = torch.sum(Dt * Dt) < _SQRT_GUARD
    return torch.where(ok, torch.addmm(L, L, Dt, alpha=0.5), torch.nan)


# ----------------------------------------------------------------------------
# The refined panels of the blocked Cholesky: K8r, K8t
# ----------------------------------------------------------------------------
def refine_residual_plain(A, L):
    """K8r plain: (E = A - L L^T, exactly symmetric from its lower triangle,
    [sum E^2, sum A^2]) in f64."""
    E = torch.tril(A - L @ L.T)
    E = E + torch.tril(E, -1).T
    return E, torch.stack([torch.sum(E * E), torch.sum(A * A)])


def refine_residual_cuda(A, L):
    """K8r on the card: (symmetric E = A - L L^T, [sum E^2, sum A^2]), f64,
    one launch."""
    global K8R_LAUNCHES
    dev = _check_cuda("K8r refine_residual", (A, L), ((_F64,), (_F64,)))
    n = _square("K8r refine_residual", A)
    if L.shape != A.shape:
        raise ValueError(f"K8r: L must be {tuple(A.shape)}; got {tuple(L.shape)}")
    fn, plan, ntiles, pairs, ticket, _ = _refine_residual_on(dev, n)
    E = torch.empty_like(A)
    sums = torch.empty(2, dtype=_F64, device=dev)
    _build.launch("K8r refine_residual", fn, dev, A.data_ptr(), L.data_ptr(), E.data_ptr(),
                  plan, ntiles, n, pairs, sums.data_ptr(), ticket)
    K8R_LAUNCHES += 1
    return E, sums


def refine_residual(A, L):
    if _on_card(A):
        return refine_residual_cuda(A.contiguous(), L.contiguous())
    return refine_residual_plain(A, L)


def _phi(X):
    """Lower triangle with halved diagonal."""
    return torch.tril(X) - 0.5 * torch.diag(torch.diag(X))


def tri_product_plain(A, B, beta=0.0, alpha=1.0, phi=False):
    """K8t plain: tril(beta A + alpha tril(A) f(B)), f(B) = Phi(B) if phi
    else tril(B)."""
    fB = _phi(B) if phi else torch.tril(B)
    return torch.tril(beta * A + alpha * (torch.tril(A) @ fB))


# K8t's launch geometry (csrc/chol.cu): 32 x 32 output tiles, the k range
# of each cut into TRI_WARPS chunks (one a warp) at multiples of TRI_KS
# columns; a plan row is (i0, j0, k_0, .., k_TRI_WARPS, 0)
TRI_TILE, TRI_WARPS, TRI_KS, TRI_PLAN = 32, 8, 8, 12


def tri_product_plan(b):
    """K8t's launch plan for a (b, b) product, on the CPU: an int32 (count,
    TRI_PLAN) tensor, one row per lower TRI_TILE-square tile (j0 <= i0),
    (i0, j0, k_0, .., k_TRI_WARPS, 0).  Warp w sums k in [k_w, k_{w+1}): the
    tile's range [j0, min(i0 + TRI_TILE, b)) (A lower: k <= i; f(B) lower:
    k >= j) cut into contiguous chunks of whole TRI_KS-column steps, as even
    a split as the steps allow (the last chunk ends at the range's end;
    empty chunks are allowed).  Rows listed longest k range first (row
    order among equals)."""
    if b <= 0:
        raise ValueError(f"tri_product_plan: b={b}")
    i0, j0 = _lower_tiles(b)
    return _chunk_plan(i0, j0, j0, torch.clamp(i0 + TRI_TILE, max=b))


def _lower_tiles(b):
    """The corners (i0, j0), j0 <= i0, of the lower TRI_TILE-square tiles of a
    (b, b) matrix, row by row."""
    i0, j0 = torch.meshgrid(torch.arange(0, b, TRI_TILE), torch.arange(0, b, TRI_TILE),
                            indexing="ij")
    keep = j0 <= i0
    return i0[keep], j0[keep]


def _chunk_plan(i0, j0, kbeg, kend):
    """Plan rows (i0, j0, k_0, .., k_TRI_WARPS, 0): each tile's k range
    [kbeg, kend) cut into TRI_WARPS contiguous chunks of whole TRI_KS-column
    steps, as even a split as the steps allow (the last chunk ends at kend;
    empty chunks are allowed); int32, the longest range first (row order
    among equals)."""
    steps = -(-(kend - kbeg) // TRI_KS)
    w = torch.arange(TRI_WARPS + 1)
    bounds = torch.minimum(kbeg[:, None] + TRI_KS * (w[None, :] * steps[:, None] // TRI_WARPS),
                           kend[:, None])
    rows = torch.cat([i0[:, None], j0[:, None], bounds,
                      torch.zeros((i0.shape[0], TRI_PLAN - TRI_WARPS - 3), dtype=i0.dtype)], 1)
    order = torch.sort(-(kend - kbeg), stable=True).indices
    return rows[order].to(torch.int32)


def refine_residual_plan(b):
    """K8r's launch plan for a (b, b) panel, on the CPU: K8t's rows (i0, j0,
    k_0, .., k_TRI_WARPS, 0), one per lower TRI_TILE-square tile, each over
    the k range [0, min(j0 + TRI_TILE, b)) (L lower: L[j, k] = 0 for k > j)
    cut into contiguous chunks of whole TRI_KS-column steps, one a warp;
    longest k range first (row order among equals)."""
    if b <= 0:
        raise ValueError(f"refine_residual_plan: b={b}")
    i0, j0 = _lower_tiles(b)
    return _chunk_plan(i0, j0, torch.zeros_like(j0), torch.clamp(j0 + TRI_TILE, max=b))


def _tri_geometry(lib):
    built = tuple(lib.gpmp_tri_product_geometry(q) for q in range(4))
    if built != (TRI_TILE, TRI_WARPS, TRI_KS, TRI_PLAN):
        raise RuntimeError(f"csrc/chol.cu's K8t geometry (tile, warps, ks, plan) is {built}, "
                           f"not {(TRI_TILE, TRI_WARPS, TRI_KS, TRI_PLAN)}")


@capture.cached(maxsize=64)
def _tri_plan_on(device, b):
    _tri_geometry(_build.load())
    return tri_product_plan(b).to(device)


@capture.cached(maxsize=64)
def _refine_residual_on(device, b):
    """K8r's launch state per (device, b): the entry, the plan on the card,
    its tile count, and the workspace, the tiles' pairs and the ticket
    (zero between launches: the last block resets it), as raw pointers
    beside the tensors that hold them."""
    lib = _build.load()
    _tri_geometry(lib)
    plan = refine_residual_plan(b).to(device)
    pairs = torch.empty(2 * plan.shape[0], dtype=_F64, device=device)
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    return (lib.gpmp_refine_residual, plan.data_ptr(), plan.shape[0], pairs.data_ptr(),
            ticket.data_ptr(), (plan, pairs, ticket))


def tri_product_cuda(A, B, beta=0.0, alpha=1.0, phi=False):
    """K8t on the card: beta A + alpha tril(A) f(B) over the lower tiles, the
    upper triangle zeros, f64 (A, B contiguous, (b, b), on one card)."""
    global K8T_LAUNCHES
    dev = _check_cuda("K8t tri_product", (A, B), ((_F64,), (_F64,)))
    n = _square("K8t tri_product", A)
    if B.shape != A.shape:
        raise ValueError(f"K8t: B must be {tuple(A.shape)}; got {tuple(B.shape)}")
    lib = _build.load()
    plan = _tri_plan_on(dev, n)
    C = torch.empty_like(A)
    _build.launch("K8t tri_product", lib.gpmp_tri_product, dev, A.data_ptr(), B.data_ptr(),
                  C.data_ptr(), plan.data_ptr(), plan.shape[0], n, float(beta), float(alpha),
                  int(bool(phi)))
    K8T_LAUNCHES += 1
    return C


def tri_product(A, B, beta=0.0, alpha=1.0, phi=False):
    if _on_card(A):
        return tri_product_cuda(A.contiguous(), B.contiguous(), beta, alpha, phi)
    return tri_product_plain(A, B, beta, alpha, phi)


def newton_tri_inv(L, M, steps=1):
    """Newton iteration M <- M (2I - L M) = 2M - M (L M) for the inverse of a
    lower triangular f64 L; quadratically convergent, two K8t products per
    step, exactly triangular."""
    for _ in range(steps):
        M = tri_product(M, tri_product(L, M), beta=2.0, alpha=-1.0)
    return M


def _f32_inverse(L32):
    """L32^{-1} by the f32 triangular solve with an identity right-hand side
    (the JAX package's op)."""
    eye = torch.eye(L32.shape[0], dtype=_F32, device=L32.device)
    return torch.linalg.solve_triangular(L32, eye, upper=False)


def refined_cholesky(A, steps=2, with_inverse=False, rtol2=_FACTOR_RTOL2):
    """f64-accurate lower Cholesky factor of SPD A via f32 + refinement.

    Returns L, or (L, M ~= L^{-1}) with with_inverse=True.  NaN when the f32
    factorization fails (non-PD) or the final relative factor residual^2
    reaches ``rtol2``: 3 K8r and 2 + 3 steps K8t launches, no host read.
    An f64 panel on the card replays the sequence's captured graph
    (``_panel_graph``); other panels, and panels inside another capture,
    run it as it is."""
    if A.is_cuda and A.dtype == _F64 and not torch.cuda.is_current_stream_capturing():
        out = _panel_graph(A.device, A.shape[0], steps, with_inverse, rtol2)(A)
        return out if with_inverse else out[0]
    return _refined_cholesky_launches(A, steps, with_inverse, rtol2)


def _refined_cholesky_launches(A, steps, with_inverse, rtol2):
    """``refined_cholesky``'s launch sequence, as the graph captures it."""
    L32, info = torch.linalg.cholesky_ex(A.to(_F32))
    L32 = torch.where(info == 0, L32, torch.nan)
    L = L32.to(A.dtype)
    M = newton_tri_inv(L, _f32_inverse(L32).to(A.dtype), steps=1)
    for _ in range(steps):
        E, _sums = refine_residual(A, L)
        L = tri_product(L, M @ E @ M.T, beta=1.0, alpha=1.0, phi=True)
        M = newton_tri_inv(L, M, steps=1)
    # convergence guard: the final factor residual must be ~f64-small
    _E, sums = refine_residual(A, L)
    err2 = sums[0] / torch.clamp(sums[1], min=torch.finfo(A.dtype).tiny)
    ok = err2 < rtol2
    L = torch.where(ok, L, torch.nan)
    if with_inverse:
        return L, torch.where(ok, M, torch.nan)
    return L


_PANEL_GRAPHS = collections.OrderedDict()
_PANEL_GRAPHS_KEPT = 8  # a factor meets one or two panel sizes


def _panel_graph(device, b, steps, with_inverse, rtol2):
    key = (device, b, steps, bool(with_inverse), float(rtol2))
    graph = _PANEL_GRAPHS.get(key)
    if graph is None:
        graph = _PANEL_GRAPHS[key] = capture.Graph(
            functools.partial(_refined_cholesky_launches, steps=steps,
                              with_inverse=bool(with_inverse), rtol2=float(rtol2)),
            (torch.eye(b, dtype=_F64, device=device),))
        if len(_PANEL_GRAPHS) > _PANEL_GRAPHS_KEPT:
            _PANEL_GRAPHS.popitem(last=False)
    else:
        _PANEL_GRAPHS.move_to_end(key)
    return graph


def refined_solve_lower(L, M, B, n_refine=1):
    """T solving T L^T = B (right triangular solve) as products:
    T0 = B M^T, then residual refinement T += (B - T L^T) M^T."""
    T = B @ M.T
    for _ in range(n_refine):
        T = T + (B - T @ L.T) @ M.T
    return T
