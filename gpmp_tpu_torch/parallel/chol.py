# gpmp_tpu_torch/parallel/chol.py
"""Blocked Cholesky with refined panels, blocked triangular solves and
Murray's backward, on one card.

Counterpart of the single-device parts of gpmp_tpu/parallel/chol.py: the
right-looking factor over ``block``-wide panels,

  1. factor the (B, B) diagonal block D of the trailing matrix S
     (``panel_impl`` 'refined': f32 Cholesky + Ogita-Aishima refinement,
     gpmp_tpu_torch/ops/refine.py, kernels K8r/K8t; 'direct':
     ``torch.linalg.cholesky_ex``; 'auto': refined for float64),
  2. solve the panel T = S[:, :B] Ljj^{-T} (the refined inverse and one
     residual sweep, or a triangular solve),
  3. update the trailing block S <- S[B:, B:] - T[B:] T[B:]^T (K9u),

and the blocked forward and backward substitutions, whose f64 diagonal
panels are inverted in f32 and Newton-refined (K8t) per panel, per solve.
The trailing update shrinks with the panel: exactly the n^3/3 multiply-adds
of the textbook algorithm (the JAX package's unrolled single-device factor;
its fixed-shape ``fori_loop`` twin and the ``GPMP_CHOL_UNROLL`` switch only
bounded XLA's compile time and are not ported).  The solves multiply only
the rows already solved (``L[c0:c0+B, :c0] @ y[:c0]``), the same sum as the
JAX package's full-width masked product without its exact zeros.

The factor works in place on one (n, n) buffer, which holds K and becomes
L (the strict upper triangle zeroed at the end): where no gradient is asked
(predict, LOO, a precomputed ``factor=``), K's own buffer, so that n = 51200
holds K and L in 21 GB; under autograd, one copy of K.  Every custom VJP of
the JAX module is a ``torch.autograd.Function``: the solves' adjoints, and
Murray's backward of the factor, Kbar = (S + S^T) / 2 with
S = L^{-T} Phi(L^T Lbar) L^{-1} (Phi and the symmetrization by K9m, the
two n-wide solves blocked as above, L^T Lbar a torch.matmul).

On a group mesh (parallel/mesh.py: one process per rank over
torch.distributed) the same functions take and return THE RANK'S ROW SLAB:
K, L, Kbar and every right-hand side as rows [off, off + n/R) of the
global (n, .) array (the JAX package's ``P(axis_name, None)``), n divisible
by R and by ``block``, block <= n/R (a panel may straddle two ranks).  The
row-sharded factor is the JAX package's ``per_shard``/``panel_step``, in
place on the slab: per panel, gather the (n, B) panel (its diagonal block
D, built from D's lower triangle), factor D on every rank (refined for
f64), write L_jj's rows where the slab holds them, solve the slab's
trailing rows T, gather the trailing rows of every rank (Mt, n x B) and
update the slab's lower trapezoid (K9s, ops/chol.py).  The solves are
column-oriented: per panel one all-reduce brings the diagonal block L_jj and
its right-hand side (the owners' rows; in the backward substitution less
every rank's partial sum L[k, j]^T x_k over its solved rows), every rank
solves it the same way, and updates its own rows.  Murray's backward on
slabs: P = L^T tril(Lbar) reduce-scattered by (n, n/R) column blocks, Phi
by K9m's slab form, the transposes P^T, tmp^T and S^T by all-to-all, never
an (n, n) array on a rank.  log det is an all-reduce of the slab's part.
"""

import torch

from gpmp_tpu_torch.ops import chol as _ops
from gpmp_tpu_torch.ops.autograd import first_order_only
from gpmp_tpu_torch.ops.refine import (
    _f32_inverse,
    newton_tri_inv,
    refined_cholesky,
    refined_solve_lower,
)
from . import comm
from .comm import is_group

_F32 = torch.float32
_F64 = torch.float64


def _check_block(n, block):
    if block < 1 or n % block != 0:
        raise ValueError(f"n ({n}) must be divisible by block ({block})")
    return n // block


def _panel_impl_for(dtype, panel_impl):
    if panel_impl == "auto":
        return "refined" if dtype == _F64 else "direct"
    if panel_impl not in ("refined", "direct"):
        raise ValueError(f"panel_impl must be 'auto', 'refined' or 'direct'; got {panel_impl!r}")
    return panel_impl


def _cholesky_nan(D):
    """Lower Cholesky factor, NaN where D is not PD (as jnp.linalg.cholesky)."""
    L, info = torch.linalg.cholesky_ex(D)
    return torch.where(info == 0, L, torch.nan)


def _panel_factor(D, panel, panel_impl):
    """(Ljj, T): factor the (block, block) diagonal block and solve the
    (rows, block) panel T = panel Ljj^{-T}."""
    if panel_impl == "refined":
        Ljj, Mjj = refined_cholesky(D, with_inverse=True)
        return Ljj, refined_solve_lower(Ljj, Mjj, panel)
    Ljj = _cholesky_nan(D)
    return Ljj, torch.linalg.solve_triangular(Ljj.T, panel, upper=True, left=False)


def _blocked_cholesky_(A, block, panel_impl="auto"):
    """The right-looking blocked factor in place: A (n, n), contiguous,
    holding SPD K on entry, holds L on return (strict upper triangle 0)."""
    n = A.shape[0]
    nb = _check_block(n, block)
    panel_impl = _panel_impl_for(A.dtype, panel_impl)
    for j in range(nb):
        c0 = j * block
        D = A[c0:c0 + block, c0:c0 + block].contiguous()
        _Ljj, T = _panel_factor(D, A[c0:, c0:c0 + block], panel_impl)
        A[c0:, c0:c0 + block] = T
        del T
        if c0 + block < n:
            _ops.trailing_update(A, c0, block)  # K9u
    return A.tril_()


def _factor_in_place(K, mesh, block, panel_impl="auto"):
    """L from K (the slab on a group mesh), in K's own buffer where nothing
    differentiates through K (grad mode off, or K not requiring a gradient);
    else ``sharded_cholesky`` (one copy, Murray's backward)."""
    if torch.is_grad_enabled() and K.requires_grad:
        return sharded_cholesky(K, mesh, block=block, panel_impl=panel_impl)
    if not K.is_contiguous():
        K = K.contiguous()
    if is_group(mesh):
        return _group_cholesky_(K.detach(), mesh, block, panel_impl)
    return _blocked_cholesky_(K.detach(), block, panel_impl)


# ----------------------------------------------------------------------------
# blocked solves
# ----------------------------------------------------------------------------
def _refined_panel_inverse(Ljj):
    """Ljj^{-1} for an f64 diagonal panel: the f32 inverse, one Newton step
    (two K8t launches)."""
    return newton_tri_inv(Ljj, _f32_inverse(Ljj.to(_F32)).to(Ljj.dtype), steps=1)


def _panel_solve_lower(Ljj, rhs):
    """Ljj^{-1} rhs for a (block, block) diagonal panel: f64 by the refined
    inverse and one residual sweep, other types by a triangular solve."""
    if Ljj.dtype != _F64:
        return torch.linalg.solve_triangular(Ljj, rhs, upper=False)
    M = _refined_panel_inverse(Ljj)
    y = M @ rhs
    return y + M @ (rhs - Ljj @ y)


def _panel_solve_upper_t(Ljj, rhs):
    """Ljj^{-T} rhs, the same way, transposed."""
    if Ljj.dtype != _F64:
        return torch.linalg.solve_triangular(Ljj.T, rhs, upper=True)
    M = _refined_panel_inverse(Ljj)
    x = M.T @ rhs
    return x + M.T @ (rhs - Ljj.T @ x)


def _as_matrix(B):
    return B.reshape(-1, 1) if B.ndim == 1 else B


def _blocked_solve_lower_impl(L, B, block):
    """y = L^{-1} B by blocked forward substitution."""
    n = L.shape[0]
    nb = _check_block(n, block)
    Bm = _as_matrix(B)
    y = torch.empty(Bm.shape, dtype=torch.result_type(L, Bm), device=Bm.device)
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        rhs = Bm[c0:c1]
        if c0:
            rhs = rhs - L[c0:c1, :c0] @ y[:c0]
        y[c0:c1] = _panel_solve_lower(L[c0:c1, c0:c1].contiguous(), rhs)
        del rhs
    return y.reshape(B.shape)


def _blocked_solve_upper_t_impl(L, B, block):
    """x = L^{-T} B by blocked backward substitution (column panels of L
    read as transposed row panels)."""
    n = L.shape[0]
    nb = _check_block(n, block)
    Bm = _as_matrix(B)
    x = torch.empty(Bm.shape, dtype=torch.result_type(L, Bm), device=Bm.device)
    for jr in range(nb):
        c0, c1 = (nb - 1 - jr) * block, (nb - jr) * block
        rhs = Bm[c0:c1]
        if c1 < n:
            rhs = rhs - L[c1:, c0:c1].T @ x[c1:]
        x[c0:c1] = _panel_solve_upper_t(L[c0:c1, c0:c1].contiguous(), rhs)
        del rhs
    return x.reshape(B.shape)


class _SolveLower(torch.autograd.Function):
    """y = L^{-1} B; Bbar = L^{-T} ybar, Lbar = -tril(Bbar y^T)."""

    @staticmethod
    def forward(ctx, L, B, block):
        y = _blocked_solve_lower_impl(L, B, block)
        ctx.save_for_backward(L, y)
        ctx.block = block
        return y

    @staticmethod
    @first_order_only("blocked_solve_lower")
    def backward(ctx, y_bar):
        L, y = ctx.saved_tensors
        B_bar = _blocked_solve_upper_t_impl(L, y_bar, ctx.block)
        L_bar = None
        if ctx.needs_input_grad[0]:
            L_bar = -torch.tril(_as_matrix(B_bar) @ _as_matrix(y).T)
        return L_bar, B_bar, None


class _SolveUpperT(torch.autograd.Function):
    """x = L^{-T} B; Bbar = L^{-1} xbar, Lbar = -tril(x Bbar^T)."""

    @staticmethod
    def forward(ctx, L, B, block):
        x = _blocked_solve_upper_t_impl(L, B, block)
        ctx.save_for_backward(L, x)
        ctx.block = block
        return x

    @staticmethod
    @first_order_only("blocked_solve_upper_t")
    def backward(ctx, x_bar):
        L, x = ctx.saved_tensors
        B_bar = _blocked_solve_lower_impl(L, x_bar, ctx.block)
        L_bar = None
        if ctx.needs_input_grad[0]:
            L_bar = -torch.tril(_as_matrix(x) @ _as_matrix(B_bar).T)
        return L_bar, B_bar, None


def blocked_solve_lower(L, B, block=256, mesh=None, axis_name="shard"):
    """y = L^{-1} B by blocked forward substitution on the lower factor (on a
    group mesh: L's, B's and y's row slabs).  Differentiable through the
    triangular-solve adjoint."""
    if is_group(mesh):
        return _GroupSolveLower.apply(L, B, block, mesh)
    return _SolveLower.apply(L, B, block)


def blocked_solve_upper_t(L, B, block=256, mesh=None, axis_name="shard"):
    """x = L^{-T} B by blocked backward substitution (on a group mesh: row
    slabs).  Differentiable as above."""
    if is_group(mesh):
        return _GroupSolveUpperT.apply(L, B, block, mesh)
    return _SolveUpperT.apply(L, B, block)


# ----------------------------------------------------------------------------
# the factor and Murray's backward
# ----------------------------------------------------------------------------
def _murray_backward(L, L_bar, block):
    """Kbar = (S + S^T) / 2, S = L^{-T} Phi(L^T tril(Lbar)) L^{-1} (Murray
    2016), each (n, n) temporary dropped after its last use."""
    P = L.T @ torch.tril(L_bar)
    del L_bar
    _ops.murray_phi(P)  # K9m
    tmp = _blocked_solve_upper_t_impl(L, P.T, block)
    del P
    S = _blocked_solve_upper_t_impl(L, tmp.T, block)
    del tmp
    return _ops.symmetrize(S)  # K9m


class _ShardedCholesky(torch.autograd.Function):
    """L = chol(K) on one copy of K; the backward saves only L."""

    @staticmethod
    def forward(ctx, K, block, panel_impl):
        L = _blocked_cholesky_(K.detach().clone(memory_format=torch.contiguous_format),
                               block, panel_impl)
        ctx.save_for_backward(L)
        ctx.block = block
        return L

    @staticmethod
    @first_order_only("sharded_cholesky")
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        return _murray_backward(L, L_bar, ctx.block), None, None


def sharded_cholesky(K, mesh, axis_name="shard", block=256, panel_impl="auto"):
    """Lower Cholesky factor of SPD K (n, n), n divisible by ``block``;
    strict upper triangle zero.  On a group mesh K and L are this rank's
    (n/R, n) row slabs (block <= n/R).

    panel_impl: 'refined' (f32 Cholesky + f64 refinement per panel, with the
    NaN guard), 'direct' (f64 cholesky_ex), 'auto' (refined for float64,
    direct otherwise).  Differentiable through Murray's backward, which
    saves only L.  K is not modified."""
    if is_group(mesh):
        _check_group_block(K.shape, mesh, block)
        return _GroupCholesky.apply(K, block, panel_impl, mesh)
    _check_block(K.shape[0], block)
    return _ShardedCholesky.apply(K, block, panel_impl)


_FACTOR_GRAD_MESSAGE = (
    "differentiating through a precomputed factor= is unsupported (VALUE ONLY): "
    "the factor is a constant to autodiff, so the factorization's dependence on "
    "the guarded argument (covparam / K) would be silently dropped from the "
    "gradient.  Call with factor=None inside differentiated code so the "
    "factorization is part of the graph.")


class _ValueOnly(torch.autograd.Function):
    """``out`` unchanged; the backward raises when the guarded input asks
    for a gradient."""

    @staticmethod
    def forward(ctx, out, guarded):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise ValueError(_FACTOR_GRAD_MESSAGE)
        return g, None


def value_only_wrt(out, guarded):
    """Return ``out``; differentiating it with ``guarded`` requiring a
    gradient raises (the factor-reuse barrier of the JAX package)."""
    return _ValueOnly.apply(out, guarded)


def sharded_cholesky_solve(K, B, mesh, axis_name="shard", block=256, factor=None):
    """(K^{-1} B, L).  factor: a previously computed L (sharded_cholesky's)
    to skip the O(n^3) factorization -- predict after fit."""
    L = factor if factor is not None else sharded_cholesky(K, mesh, block=block)
    y = blocked_solve_lower(L, B, block=block, mesh=mesh)
    x = blocked_solve_upper_t(L, y, block=block, mesh=mesh)
    if factor is not None and K is not factor:
        # with a precomputed factor K is never read: a K-gradient would
        # silently be zero
        x = value_only_wrt(x, K)
    return x, L


def sharded_solve_and_logdet(K, B, mesh, axis_name="shard", block=256, factor=None):
    """(K^{-1} B, log det K) through the blocked factor (on a group mesh: the
    slab of K^{-1} B and the replicated log det)."""
    X, L = sharded_cholesky_solve(K, B, mesh, axis_name=axis_name, block=block,
                                  factor=factor)
    off, _ = comm.rows_of(L.shape[1], mesh)
    return X, comm.psum(2.0 * torch.sum(torch.log(torch.diagonal(L, off))), mesh)


# ----------------------------------------------------------------------------
# the group mesh: row slabs
# ----------------------------------------------------------------------------
def _check_group_block(shape, mesh, block):
    """(off, n_loc, nb) of a (n/R, n) slab; n divisible by R and block, and
    block <= n/R (the JAX package's conditions)."""
    n_loc, n = shape
    off, n_loc_ = comm.rows_of(n, mesh)
    if n_loc != n_loc_:
        raise ValueError(f"a slab of an (n, n) matrix over {mesh.size} ranks is "
                         f"({n_loc_}, {n}); got {tuple(shape)}")
    nb = _check_block(n, block)
    if block > n_loc:
        raise ValueError(f"block ({block}) must not exceed the per-rank row count "
                         f"({n_loc}); decrease block or the rank count")
    return off, n_loc, nb


def _span(c0, c1, off, n_loc):
    """Local [a, b) of the global rows [c0, c1) that this slab holds."""
    return min(max(c0 - off, 0), n_loc), min(max(c1 - off, 0), n_loc)


def _group_cholesky_(A, mesh, block, panel_impl="auto"):
    """The row-sharded right-looking factor in place on this rank's slab A
    (n/R, n), contiguous, holding K's rows on entry and L's on return
    (strict upper triangle 0).  Two gathers per panel; every rank runs every
    collective, whatever rows it holds."""
    off, n_loc, nb = _check_group_block(A.shape, mesh, block)
    n = A.shape[1]
    panel_impl = _panel_impl_for(A.dtype, panel_impl)
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        panel = comm.gather_rows(A[:, c0:c1], mesh)
        Dl = panel[c0:c1]
        D = torch.tril(Dl) + torch.tril(Dl, -1).T  # the slabs keep D's lower triangle
        del panel, Dl
        r0, t0 = _span(c0, c1, off, n_loc)  # [r0, t0): D's rows here; [t0, n_loc): trailing
        if r0 < n_loc:
            if panel_impl == "refined":
                Ljj, Mjj = refined_cholesky(D, with_inverse=True)
            else:
                Ljj = _cholesky_nan(D)
            if r0 < t0:
                A[r0:t0, c0:c1] = Ljj[off + r0 - c0:off + t0 - c0]
            if t0 < n_loc:
                rows = A[t0:, c0:c1]
                A[t0:, c0:c1] = (refined_solve_lower(Ljj, Mjj, rows) if panel_impl == "refined"
                                 else torch.linalg.solve_triangular(Ljj.T, rows, upper=True,
                                                                    left=False))
        if c1 < n:
            Mt = torch.zeros((n_loc, block), dtype=A.dtype, device=A.device)
            Mt[t0:] = A[t0:, c0:c1]
            Mt_all = comm.gather_rows(Mt, mesh)
            del Mt
            if t0 < n_loc:
                _ops.slab_update(A, off, c0, block, Mt_all)  # K9s
            del Mt_all
    return A.tril_(off)


def _diag_block_and_rhs(L, R, c0, c1, off, n_loc):
    """(B, B + m) buffer: L's diagonal block [c0, c1)^2 and R's rows [c0, c1),
    where this slab holds them, zeros elsewhere (summed over ranks, the whole
    block)."""
    block = c1 - c0
    buf = torch.zeros((block, block + R.shape[1]), dtype=R.dtype, device=R.device)
    a, b = _span(c0, c1, off, n_loc)
    if a < b:
        buf[off + a - c0:off + b - c0, :block] = L[a:b, c0:c1]
        buf[off + a - c0:off + b - c0, block:] = R[a:b]
    return buf, a, b


def _group_solve_lower_impl(L, B, block, mesh):
    """y = L^{-1} B on slabs, column-oriented: per panel, one all-reduce of
    the diagonal block and its updated right-hand side, the same panel solve
    on every rank, then this slab's trailing rows updated."""
    off, n_loc, nb = _check_group_block(L.shape, mesh, block)
    Bm = _as_matrix(B)
    y = Bm.to(torch.result_type(L, Bm), copy=True)
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        buf, a, b = _diag_block_and_rhs(L, y, c0, c1, off, n_loc)
        comm.all_reduce_sum_(buf, mesh)
        yj = _panel_solve_lower(buf[:, :block].contiguous(), buf[:, block:])
        del buf
        if a < b:
            y[a:b] = yj[off + a - c0:off + b - c0]
        if b < n_loc:
            y[b:].addmm_(L[b:, c0:c1], yj, alpha=-1.0)
    return y.reshape(B.shape)


def _group_solve_upper_t_impl(L, B, block, mesh):
    """x = L^{-T} B on slabs: per panel (last first), one all-reduce of the
    diagonal block and its right-hand side less every rank's sum
    L[k, j]^T x_k over its solved rows k >= c1."""
    off, n_loc, nb = _check_group_block(L.shape, mesh, block)
    Bm = _as_matrix(B)
    x = torch.empty(Bm.shape, dtype=torch.result_type(L, Bm), device=Bm.device)
    for jr in range(nb):
        c0, c1 = (nb - 1 - jr) * block, (nb - jr) * block
        buf, a, b = _diag_block_and_rhs(L, Bm, c0, c1, off, n_loc)
        if b < n_loc:
            buf[:, block:].addmm_(L[b:, c0:c1].T, x[b:], alpha=-1.0)
        comm.all_reduce_sum_(buf, mesh)
        xj = _panel_solve_upper_t(buf[:, :block].contiguous(), buf[:, block:])
        del buf
        if a < b:
            x[a:b] = xj[off + a - c0:off + b - c0]
    return x.reshape(B.shape)


class _GroupSolveLower(torch.autograd.Function):
    """Slabs of y = L^{-1} B; Bbar = L^{-T} ybar, Lbar = -tril(Bbar y^T) on
    this slab's rows (y gathered: (n, m))."""

    @staticmethod
    def forward(ctx, L, B, block, mesh):
        y = _group_solve_lower_impl(L, B, block, mesh)
        ctx.save_for_backward(L, y)
        ctx.block, ctx.mesh = block, mesh
        return y

    @staticmethod
    @first_order_only("blocked_solve_lower")
    def backward(ctx, y_bar):
        L, y = ctx.saved_tensors
        B_bar = _group_solve_upper_t_impl(L, y_bar.contiguous(), ctx.block, ctx.mesh)
        L_bar = None
        if ctx.needs_input_grad[0]:
            off, _ = comm.rows_of(L.shape[1], ctx.mesh)
            y_all = comm.gather_rows(_as_matrix(y), ctx.mesh)
            L_bar = -torch.tril(_as_matrix(B_bar) @ y_all.T, off)
        return L_bar, B_bar, None, None


class _GroupSolveUpperT(torch.autograd.Function):
    """Slabs of x = L^{-T} B; Bbar = L^{-1} xbar, Lbar = -tril(x Bbar^T) on
    this slab's rows (Bbar gathered)."""

    @staticmethod
    def forward(ctx, L, B, block, mesh):
        x = _group_solve_upper_t_impl(L, B, block, mesh)
        ctx.save_for_backward(L, x)
        ctx.block, ctx.mesh = block, mesh
        return x

    @staticmethod
    @first_order_only("blocked_solve_upper_t")
    def backward(ctx, x_bar):
        L, x = ctx.saved_tensors
        B_bar = _group_solve_lower_impl(L, x_bar.contiguous(), ctx.block, ctx.mesh)
        L_bar = None
        if ctx.needs_input_grad[0]:
            off, _ = comm.rows_of(L.shape[1], ctx.mesh)
            b_all = comm.gather_rows(_as_matrix(B_bar), ctx.mesh)
            L_bar = -torch.tril(_as_matrix(x) @ b_all.T, off)
        return L_bar, B_bar, None, None


def _group_murray_backward(L, L_bar, block, mesh):
    """Slab of Kbar = (S + S^T) / 2, S = L^{-T} Phi(L^T tril(Lbar)) L^{-1}:
    P's slab by one reduce-scatter per (n, n/R) column block of L^T tril(Lbar),
    Phi by K9m's slab form, the transposes by all-to-all."""
    off, n_loc, _nb = _check_group_block(L.shape, mesh, block)
    Lb = torch.tril(L_bar, off)
    del L_bar
    P = torch.empty_like(L)
    for r in range(mesh.size):
        cols = slice(r * n_loc, (r + 1) * n_loc)
        P[:, cols] = comm.reduce_scatter_rows(L.T @ Lb[:, cols], mesh)
    del Lb
    _ops.murray_phi_slab(P, off)  # K9m
    tmp = _group_solve_upper_t_impl(L, comm.transpose_slab(P, mesh), block, mesh)
    del P
    S = _group_solve_upper_t_impl(L, comm.transpose_slab(tmp, mesh), block, mesh)
    del tmp
    return _ops.symmetrize_slab(S, comm.transpose_slab(S, mesh), off)  # K9m


class _GroupCholesky(torch.autograd.Function):
    """L's slab from K's slab on one copy; the backward saves only L's slab."""

    @staticmethod
    def forward(ctx, K, block, panel_impl, mesh):
        L = _group_cholesky_(K.detach().clone(memory_format=torch.contiguous_format), mesh,
                             block, panel_impl)
        ctx.save_for_backward(L)
        ctx.block, ctx.mesh = block, mesh
        return L

    @staticmethod
    @first_order_only("sharded_cholesky")
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        return _group_murray_backward(L, L_bar, ctx.block, ctx.mesh), None, None, None
