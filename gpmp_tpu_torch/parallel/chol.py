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

Not ported: the row-sharded factor over more than one card (``shard_map``,
the psum gathers); such meshes raise NotImplementedError.
"""

import torch
from torch.autograd.function import once_differentiable

from gpmp_tpu_torch.ops import chol as _ops
from gpmp_tpu_torch.ops.refine import (
    _f32_inverse,
    newton_tri_inv,
    refined_cholesky,
    refined_solve_lower,
)

_F32 = torch.float32
_F64 = torch.float64


def _check_one_card(mesh):
    if mesh is not None and mesh.size != 1:
        raise NotImplementedError(
            "meshes of more than one card need torch.distributed/NCCL "
            "(ROADMAP queue 1 item 11)")


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
    """L from K, in K's own buffer where nothing differentiates through K
    (grad mode off, or K not requiring a gradient); else
    ``sharded_cholesky`` (one copy, Murray's backward)."""
    if torch.is_grad_enabled() and K.requires_grad:
        return sharded_cholesky(K, mesh, block=block, panel_impl=panel_impl)
    _check_one_card(mesh)
    if not K.is_contiguous():
        K = K.contiguous()
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
    @once_differentiable
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
    @once_differentiable
    def backward(ctx, x_bar):
        L, x = ctx.saved_tensors
        B_bar = _blocked_solve_lower_impl(L, x_bar, ctx.block)
        L_bar = None
        if ctx.needs_input_grad[0]:
            L_bar = -torch.tril(_as_matrix(x) @ _as_matrix(B_bar).T)
        return L_bar, B_bar, None


def blocked_solve_lower(L, B, block=256, mesh=None, axis_name="shard"):
    """y = L^{-1} B by blocked forward substitution on the lower factor.
    Differentiable through the triangular-solve adjoint."""
    _check_one_card(mesh)
    return _SolveLower.apply(L, B, block)


def blocked_solve_upper_t(L, B, block=256, mesh=None, axis_name="shard"):
    """x = L^{-T} B by blocked backward substitution.  Differentiable as
    above."""
    _check_one_card(mesh)
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
    @once_differentiable
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        return _murray_backward(L, L_bar, ctx.block), None, None


def sharded_cholesky(K, mesh, axis_name="shard", block=256, panel_impl="auto"):
    """Lower Cholesky factor of SPD K (n, n), n divisible by ``block``, on
    the mesh's card; strict upper triangle zero.

    panel_impl: 'refined' (f32 Cholesky + f64 refinement per panel, with the
    NaN guard), 'direct' (f64 cholesky_ex), 'auto' (refined for float64,
    direct otherwise).  Differentiable through Murray's backward, which
    saves only L.  K is not modified."""
    _check_one_card(mesh)
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
    """(K^{-1} B, log det K) through the blocked factor."""
    X, L = sharded_cholesky_solve(K, B, mesh, axis_name=axis_name, block=block,
                                  factor=factor)
    return X, 2.0 * torch.sum(torch.log(torch.diagonal(L)))
