# gpmp_tpu_torch/num/__init__.py
"""PyTorch numerical namespace (`gnp`) for gpmp_tpu_torch.

Counterpart of gpmp_tpu/num/__init__.py, limited to what the REML fit,
kriging predict, LOO and sample-path paths and user model code need: array
creation on the configured device and dtype, a few elementwise ops and
reductions, Cholesky/QR linear algebra, distances (``scaled_distance`` and
``scaled_distance_elementwise`` run the K1d kernel on CUDA tensors,
ops/distance.py), the RNG shim, and the criterion wrapper that hands
(value, gradient) to SciPy.

- Autodiff is ``torch.autograd``.
- Linalg failures do not raise: a failed Cholesky yields NaNs
  (``torch.linalg.cholesky_ex``, no host synchronisation), which the
  criterion boundary maps to +inf, as the JAX package does.
- Every tensor created here gets an explicit device (``config.get_device``,
  read at call time) and dtype (``GPMP_DTYPE``, fixed at import).

- Random numbers come from a module-level ``torch.Generator`` on the
  configured device (``set_seed``); every draw also takes an explicit
  ``generator=``, where the JAX package takes ``key=``.  torch and JAX give
  different numbers from the same seed.

Not ported yet (ROADMAP): ``normal``/``multivariate_normal``,
``BatchDifferentiableSelectionCriterion`` and
``SecondOrderDifferentiableFunction``.
"""

from __future__ import annotations

import builtins
import math
from typing import Callable

import numpy as _onp
import torch

from gpmp_tpu_torch.config import get_config, get_device, get_logger

_config = get_config()

_dtype = torch.float64 if _config.dtype == "float64" else torch.float32
_config.dtype_resolved = _dtype
get_logger().info("Using backend: torch (dtype=%s)", _dtype)

pi = math.pi
inf = math.inf
nan = math.nan
eps = float(torch.finfo(_dtype).eps)
fmax = float(torch.finfo(_dtype).max)


def get_dtype():
    return _dtype


# ----------------------------------------------------------------------------
# Constructors: floats -> working dtype, ints preserved, configured device
# ----------------------------------------------------------------------------
def _float_or_keep(t, dtype):
    if dtype is not None:
        return t.to(device=get_device(), dtype=dtype)
    if t.is_floating_point():
        return t.to(device=get_device(), dtype=_dtype)
    return t.to(device=get_device())


def asarray(x, dtype=None):
    """Tensor on the configured device; floats in the working dtype.

    A tensor already there is returned as is (same object), so identity
    tests such as ``y is x`` in the covariance dispatch keep working.
    A Python scalar becomes a 1-element tensor, as in the JAX package.
    """
    if isinstance(x, torch.Tensor):
        return _float_or_keep(x, dtype)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        if dtype is None:
            dtype = _dtype if isinstance(x, float) else torch.int64
        return torch.tensor([x], dtype=dtype, device=get_device())
    return _float_or_keep(torch.as_tensor(_onp.asarray(x)), dtype)


def array(x, dtype=None):
    """Like asarray, but always a new tensor."""
    if isinstance(x, torch.Tensor):
        return _float_or_keep(x, dtype).clone()
    return _float_or_keep(torch.tensor(_onp.asarray(x)), dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=dtype or _dtype, device=get_device())


def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=dtype or _dtype, device=get_device())


def full(shape, fill_value, dtype=None):
    return torch.full(
        _shape(shape), fill_value, dtype=dtype or _dtype, device=get_device()
    )


def arange(*args, dtype=None):
    """torch.arange on the configured device; integers stay int64."""
    return torch.arange(*args, dtype=dtype, device=get_device())


def eye(n, m=None, dtype=None):
    return torch.eye(n, n if m is None else m, dtype=dtype or _dtype,
                     device=get_device())


def concatenate(tensors, axis=0):
    return torch.cat(tuple(tensors), dim=axis)


def stack(tensors, axis=0):
    return torch.stack(tuple(tensors), dim=axis)


def reshape(x, shape):
    return torch.reshape(x, shape)


def to_np(x):
    """Tensor -> host numpy array (identity for non-tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def to_scalar(x):
    if isinstance(x, (int, float, bool)):
        return x
    return x.item()


# ----------------------------------------------------------------------------
# Elementwise ops and reductions (JAX-style ``axis`` keywords)
# ----------------------------------------------------------------------------
def _tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=_dtype, device=get_device())


def exp(x):
    return torch.exp(_tensor(x))


def log(x):
    return torch.log(_tensor(x))


def sqrt(x):
    return torch.sqrt(_tensor(x))


def gammaln(x):
    return torch.special.gammaln(_tensor(x))


def sum(x, axis=None, keepdims=False):
    if axis is None:
        return torch.sum(x)
    return torch.sum(x, dim=axis, keepdim=keepdims)


def max(x, axis=None, keepdims=False):
    if axis is None:
        return torch.amax(x)
    return torch.amax(x, dim=axis, keepdim=keepdims)


def min(x, axis=None, keepdims=False):
    if axis is None:
        return torch.amin(x)
    return torch.amin(x, dim=axis, keepdim=keepdims)


def any(x):
    return torch.any(x)


def maximum(a, b):
    a = _tensor(a)
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


einsum = torch.einsum
matmul = torch.matmul
diag = torch.diag


# ----------------------------------------------------------------------------
# Distances
# ----------------------------------------------------------------------------
_CDIST_BLOCK_BUDGET = 2**27  # max elements of the (b, m, d) difference tensor


class _SafeSqrt(torch.autograd.Function):
    """sqrt with a zero subgradient at 0.

    d/dx sqrt(x) at x=0 is +inf, which poisons autodiff through the gram
    diagonal (coincident points); 0 is the subgradient used there, as in
    the JAX package's custom_jvp ``_safe_sqrt``.
    """

    @staticmethod
    def forward(ctx, d2):
        y = torch.sqrt(d2)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        pos = y > 0.0
        return torch.where(pos, 0.5 / torch.where(pos, y, 1.0), 0.0) * g


_safe_sqrt = _SafeSqrt.apply


def _cdist_diff(x, y):
    """Accurate pairwise Euclidean distances via explicit differences."""
    d2 = torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1)
    return _safe_sqrt(d2)


def cdist(x, y):
    """Pairwise Euclidean distance matrix, row-blocked for large inputs.

    Difference formulation (accurate for nearby points), with rows taken
    in blocks so the (n, m, d) intermediate stays under
    ``_CDIST_BLOCK_BUDGET`` elements.
    """
    x = torch.atleast_2d(x)
    y = torch.atleast_2d(y)
    n, d = x.shape
    m = y.shape[0]
    if n * m * builtins.max(d, 1) <= _CDIST_BLOCK_BUDGET:
        return _cdist_diff(x, y)
    block = builtins.max(1, _CDIST_BLOCK_BUDGET // (m * builtins.max(d, 1)))
    return torch.cat([_cdist_diff(x[i:i + block], y) for i in range(0, n, block)])


def scaled_distance(loginvrho, x, y):
    """Anisotropic scaled distance cdist(exp(loginvrho)*x, exp(loginvrho)*y),
    differentiable in loginvrho: the K1d kernel on CUDA tensors, the plain
    composition on CPU tensors (ops.distance)."""
    from gpmp_tpu_torch.ops import distance  # ops imports this module

    return distance.scaled_distance(loginvrho, x, y)


def scaled_distance_elementwise(loginvrho, x, y):
    """||exp(loginvrho) * (x_i - y_i)|| row by row (K1d on CUDA tensors);
    zeros when y is x or None."""
    if x is y or y is None:
        return torch.zeros((x.shape[0],), dtype=_dtype, device=x.device)
    from gpmp_tpu_torch.ops import distance  # ops imports this module

    return distance.scaled_distance_elementwise(loginvrho, x, y)


# ----------------------------------------------------------------------------
# Linear algebra (LU-free: Cholesky and QR only, as in the JAX package)
# ----------------------------------------------------------------------------
def cholesky(A):
    """Lower Cholesky factor, NaN-filled where A is not positive definite.

    ``torch.linalg.cholesky`` raises (and synchronises with the device to
    do so); ``cholesky_ex`` reports failure in ``info`` instead, and the
    factor is masked on the device.
    """
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def solve_triangular(A, b, lower=False, trans=0):
    """Solve A x = b (trans=0) or A^T x = b (trans=1) for triangular A.

    Keeps the JAX/SciPy signature: ``lower=`` rather than torch's
    ``upper=``, and a vector right-hand side is accepted.
    """
    if trans in (1, "T", "C"):
        A, lower = A.mT, not lower
    elif trans not in (0, "N"):
        raise ValueError(f"trans must be 0 or 1, got {trans!r}")
    vec = b.ndim == A.ndim - 1
    B = b.unsqueeze(-1) if vec else b
    X = torch.linalg.solve_triangular(A, B, upper=not lower)
    return X.squeeze(-1) if vec else X


def solve(A, b, **kwargs):
    """Dense solve via Householder QR (no LU, as in the JAX package).

    scipy-style kwargs (overwrite_a, overwrite_b, assume_a) are accepted
    and ignored.
    """
    for k in ("overwrite_a", "overwrite_b", "assume_a"):
        kwargs.pop(k, None)
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    Q, R = torch.linalg.qr(A)
    return solve_triangular(R, Q.mT @ b, lower=False)


def qr(a, mode="reduced"):
    return torch.linalg.qr(a, mode=mode)


def logdet(A):
    """log|A| for symmetric positive-definite A via Cholesky (NaN if not PD)."""
    L = cholesky(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def cholesky_inv(A):
    n = A.shape[-1]
    L = cholesky(A)
    T = solve_triangular(L, torch.eye(n, dtype=A.dtype, device=A.device), lower=True)
    return T.mT @ T


def cholesky_solve(A, b):
    """Solve A x = b for SPD A via Cholesky.  Returns (x, L).

    On a non-PD matrix the factor and the solution are NaN; nothing raises.
    """
    L = cholesky(A)
    y = solve_triangular(L, b, lower=True)
    x = solve_triangular(L.mT, y, lower=False)
    return x, L


# ----------------------------------------------------------------------------
# RNG: a module-level generator with global-seed UX
# ----------------------------------------------------------------------------
_DEFAULT_SEED = 1234  # gpmp_tpu/config.py's default seed
_rng = {"seed": _DEFAULT_SEED, "device": None, "generator": None}


def set_seed(seed: int) -> None:
    """Reset the module-level generator (UX parity with the reference)."""
    _rng.update(seed=int(seed), device=None, generator=None)


def _generator(generator=None):
    """The given generator, or the module-level one on the configured device
    (made there from the current seed when first used or when the device
    has changed since)."""
    if generator is not None:
        return generator
    dev = get_device()
    if _rng["device"] != dev:
        _rng.update(device=dev,
                    generator=torch.Generator(device=dev).manual_seed(_rng["seed"]))
    return _rng["generator"]


def _draw_shape(shape):
    return tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape


def rand(*shape, generator=None):
    """Uniform [0, 1) draws in the working dtype on the configured device."""
    gen = _generator(generator)
    return torch.rand(_draw_shape(shape), generator=gen, dtype=_dtype, device=gen.device)


def randn(*shape, generator=None):
    """Standard normal draws in the working dtype on the configured device."""
    gen = _generator(generator)
    return torch.randn(_draw_shape(shape), generator=gen, dtype=_dtype, device=gen.device)


def choice(a, size=None, replace=True, p=None, generator=None):
    """Draws from a (an int n stands for arange(n)), with or without
    replacement, optionally with probabilities p."""
    gen = _generator(generator)
    pool = torch.arange(a, device=gen.device) if isinstance(a, int) else asarray(a)
    shape = () if size is None else (size if isinstance(size, tuple) else (size,))
    k = math.prod(shape)
    n = pool.shape[0]
    if p is not None:
        w = torch.as_tensor(p, dtype=torch.float64, device=gen.device)
        idx = torch.multinomial(w, k, replacement=replace, generator=gen)
    elif replace:
        idx = torch.randint(n, (k,), generator=gen, device=gen.device)
    else:
        if k > n:
            raise ValueError(f"cannot take {k} samples from {n} without replacement")
        idx = torch.randperm(n, generator=gen, device=gen.device)[:k]
    return pool[idx].reshape(shape + pool.shape[1:])


def permutation(x, generator=None):
    """A random permutation of range(x) (int x) or of the rows of x."""
    gen = _generator(generator)
    if isinstance(x, int):
        return torch.randperm(x, generator=gen, device=gen.device)
    x = asarray(x)
    return x[torch.randperm(x.shape[0], generator=gen, device=gen.device)]


# ----------------------------------------------------------------------------
# Criterion wrapper (the optimizer boundary)
# ----------------------------------------------------------------------------
class DifferentiableSelectionCriterion:
    """Criterion wrapper exposing the 4-callable optimizer protocol.

    One forward and one ``torch.autograd.grad`` per evaluation; the value
    and the gradient come back to the host in one transfer.
    ``evaluate_pre_grad`` caches the gradient, keyed on ``p``, so the
    optimizer's following ``gradient`` call at the same point is free.
    Non-finite values (failed Cholesky -> NaN) map to +inf with a zero
    gradient.
    """

    def __init__(self, crit: Callable, x, z):
        self.crit = crit
        self.x, self.z = asarray(x), asarray(z)
        self._cache_p = None
        self._cache_g = None

    def __call__(self, p):
        return self.evaluate(p)

    def _compute(self, p):
        pt = asarray(_onp.asarray(p, dtype=float)).requires_grad_(True)
        value = self.crit(pt, self.x, self.z).reshape(())
        (g,) = torch.autograd.grad(value, pt)
        vg = torch.cat([value.detach().reshape(1), g.reshape(-1)])
        vg = vg.to(device="cpu", dtype=torch.float64).numpy()
        value, g = float(vg[0]), vg[1:].reshape(_onp.shape(p))
        if not _onp.isfinite(value):
            return _onp.inf, _onp.zeros_like(g)
        if not _onp.all(_onp.isfinite(g)):
            g = _onp.zeros_like(g)
        return value, g

    def evaluate(self, p):
        value, g = self._compute(p)
        self._cache_p, self._cache_g = _onp.array(p, dtype=float), g
        return value

    def evaluate_pre_grad(self, p):
        return self.evaluate(p)

    def evaluate_no_grad(self, p):
        with torch.no_grad():
            value = float(self.crit(asarray(_onp.asarray(p, dtype=float)),
                                    self.x, self.z))
        return value if _onp.isfinite(value) else _onp.inf

    def gradient(self, p):
        pnp = _onp.asarray(p, dtype=float)
        if self._cache_p is not None and _onp.array_equal(pnp, self._cache_p):
            return self._cache_g
        _, g = self._compute(p)
        return g


def _is_linalg_exception(exc: Exception) -> bool:
    """Linalg failure surfaces as NaN here, not as an exception; kept for
    the optimizer loop's defensive path (as in the JAX package)."""
    msg = str(exc).lower()
    keywords = ("singular", "cholesky", "not positive definite", "linalg", "lapack")
    return builtins.any(k in msg for k in keywords)
