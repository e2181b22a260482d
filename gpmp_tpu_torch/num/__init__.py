# gpmp_tpu_torch/num/__init__.py
"""PyTorch numerical namespace (`gnp`) for gpmp_tpu_torch.

Counterpart of gpmp_tpu/num/__init__.py: array creation on the configured
device and dtype, the NumPy-style elementwise ops, reductions and shape
ops, linear algebra, distances (``scaled_distance`` and
``scaled_distance_elementwise`` run the K1d kernel on CUDA tensors,
ops/distance.py), the RNG shim and the normal distributions, autodiff
helpers, and the criterion wrappers that hand (value, gradient) to SciPy.

- Autodiff is ``torch.autograd``.
- Linalg failures do not raise: a failed Cholesky yields NaNs
  (``torch.linalg.cholesky_ex``, no host synchronisation), which the
  criterion boundary maps to +inf, as the JAX package does.
- Every tensor created here gets an explicit device (``config.get_device``,
  read at call time) and dtype (``GPMP_DTYPE``, fixed at import).
- The ops take NumPy arrays and Python sequences wherever they take
  arrays, as ``jnp`` converts them in the JAX package (``_tensor``): such
  an operand becomes a tensor on the configured device, floats in the
  working dtype.  A tensor is taken as it is, on its own device: nothing
  here moves a tensor between the CPU and the card.

- Random numbers come from a module-level ``torch.Generator`` on the
  configured device (``set_seed``); every draw also takes an explicit
  ``generator=``, where the JAX package takes ``key=``.  torch and JAX give
  different numbers from the same seed.

Left out on purpose: the JAX package's ``jax``/``jnp``/``lax`` names, its
PRNG keys (``next_key``), its typing aliases and its XLA compile cache.
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


def eye(n, m=None, k=0, dtype=None):
    dev = get_device()
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(n if m is None else m, device=dev)[None, :]
    return (cols - rows == k).to(dtype or _dtype)


def _tensor(x, dtype=None):
    """An operand of the ops below: a tensor as it is, on its own device;
    anything else (a NumPy array, a Python sequence or scalar) as a tensor
    on the configured device, in ``dtype`` if given, else floats in the
    working dtype and ints and bools kept (``jnp``'s conversion in the JAX
    package, which copies: the tensor never shares the caller's memory)."""
    if isinstance(x, torch.Tensor):
        return x
    return _float_or_keep(torch.tensor(_onp.asarray(x)), dtype)


def concatenate(tensors, axis=0):
    return torch.cat([_tensor(t) for t in tensors], dim=axis)


def stack(tensors, axis=0):
    return torch.stack([_tensor(t) for t in tensors], dim=axis)


def reshape(x, shape):
    return torch.reshape(_tensor(x), shape)


def to_np(x):
    """Tensor -> host numpy array (identity for non-tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def to_scalar(x):
    if isinstance(x, (int, float, bool)):
        return x
    return x.item()


def to_numpy(x):
    """Alias of to_np."""
    return to_np(x)


tensor = asarray
ndarray = torch.Tensor
NDArray = torch.Tensor
TensorLike = torch.Tensor | float | int
finfo = torch.finfo
float32, float64, int32, int64 = torch.float32, torch.float64, torch.int32, torch.int64
builtins_max = builtins.max


def init_backend() -> str:
    """The backend's name (kept for the reference's API)."""
    return "torch"


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def isarray(x) -> bool:
    return isinstance(x, (torch.Tensor, _onp.ndarray))


def isscalar(x) -> bool:
    """True for Python and NumPy scalars and for 0-d arrays (as jnp.isscalar)."""
    if isinstance(x, (torch.Tensor, _onp.ndarray)):
        return x.ndim == 0
    return _onp.isscalar(x)


def asdouble(x):
    """x in the working float dtype."""
    return _tensor(x).to(_dtype)


def asint(x):
    return _tensor(x).to(torch.int64)


def copy(x):
    return _tensor(x).clone()


def empty(shape, dtype=None):
    return torch.empty(_shape(shape), dtype=dtype or _dtype, device=get_device())


def _like(fn, a, dtype, *fill):
    a = _tensor(a)
    return fn(a, *fill, dtype=dtype or a.dtype)


def empty_like(a, dtype=None):
    return _like(torch.empty_like, a, dtype)


def zeros_like(a, dtype=None):
    return _like(torch.zeros_like, a, dtype)


def ones_like(a, dtype=None):
    return _like(torch.ones_like, a, dtype)


def full_like(a, fill_value, dtype=None):
    return _like(torch.full_like, a, dtype, fill_value)


def safe_inf():
    """+inf in the working dtype (a criterion's value on a linalg failure)."""
    return torch.tensor(math.inf, dtype=_dtype, device=get_device())


def safe_neginf():
    return torch.tensor(-math.inf, dtype=_dtype, device=get_device())


def inftobigf(a, bigf=fmax / 1000.0):
    """Every +-inf replaced by the big finite value bigf (keeps the Matern
    polynomial finite)."""
    a = _tensor(a)
    return torch.where(torch.isinf(a), torch.full_like(a, bigf), a)


# ----------------------------------------------------------------------------
# Elementwise ops and reductions (JAX-style ``axis`` keywords)
# ----------------------------------------------------------------------------
def exp(x):
    return torch.exp(_tensor(x, _dtype))


def log(x):
    return torch.log(_tensor(x, _dtype))


def sqrt(x):
    return torch.sqrt(_tensor(x, _dtype))


def gammaln(x):
    return torch.special.gammaln(_tensor(x, _dtype))


def _keep_all(out, x, keepdims):
    """A reduction over every axis, its dimensions kept if asked."""
    return out.reshape((1,) * x.ndim) if keepdims else out


def _reduce(fn, x, axis, keepdims):
    if axis is None:
        return _keep_all(fn(x), x, keepdims)
    return fn(x, dim=axis, keepdim=keepdims)


def sum(x, axis=None, keepdims=False, dtype=None, initial=None, where=None):
    x = _tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    if where is not None:
        x = torch.where(_tensor(where, torch.bool).to(x.device), x, 0)
    out = _reduce(torch.sum, x, axis, keepdims)
    return out if initial is None else out + initial


def _extremum(fn, x, axis, keepdims, dtype, initial, where, pick):
    x = _tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    if where is not None:
        if initial is None:
            raise ValueError("reduction with where= needs initial=")
        x = torch.where(_tensor(where, torch.bool).to(x.device), x, initial)
    out = _reduce(fn, x, axis, keepdims)
    if initial is None:
        return out
    return pick(out, torch.as_tensor(initial, dtype=out.dtype, device=out.device))


def max(x, axis=None, keepdims=False, dtype=None, initial=None, where=None):
    return _extremum(torch.amax, x, axis, keepdims, dtype, initial, where, torch.maximum)


def min(x, axis=None, keepdims=False, dtype=None, initial=None, where=None):
    return _extremum(torch.amin, x, axis, keepdims, dtype, initial, where, torch.minimum)


def any(x, axis=None, keepdims=False):
    return _reduce(torch.any, _tensor(x), axis, keepdims)


def all(x, axis=None, keepdims=False):
    return _reduce(torch.all, _tensor(x), axis, keepdims)


def maximum(a, b):
    a = _tensor(a, _dtype)
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def diag(v, k=0):
    return torch.diag(_tensor(v), k)


einsum = torch.einsum
matmul = torch.matmul


def minimum(a, b):
    a = _tensor(a, _dtype)
    return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _float(x):
    """An operand of a float-valued op: ints and bools in the working dtype."""
    x = _tensor(x)
    return x if x.is_floating_point() or x.is_complex() else x.to(_dtype)


def _unary(fn, convert=_float):
    def op(x):
        return fn(convert(x))

    op.__name__ = fn.__name__
    op.__doc__ = f"torch.{fn.__name__} of a tensor or an array-like."
    return op


log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
tanh = _unary(torch.tanh)
abs = _unary(torch.abs, _tensor)
floor = _unary(torch.floor, _tensor)
ceil = _unary(torch.ceil, _tensor)
isnan = _unary(torch.isnan, _tensor)
isinf = _unary(torch.isinf, _tensor)
isfinite = _unary(torch.isfinite, _tensor)
logical_not = _unary(torch.logical_not, _tensor)


def _pair(a, b):
    """Two operands on a's device, in their promoted dtype (b follows a
    when it is not a tensor)."""
    a = _tensor(a)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(_onp.asarray(b), device=a.device)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def logical_and(a, b):
    return torch.logical_and(*_pair(a, b))


def logical_or(a, b):
    return torch.logical_or(*_pair(a, b))


def where(condition, x=None, y=None):
    """torch.where; with the condition alone, the indices where it holds."""
    cond = _tensor(condition, torch.bool)
    if x is None and y is None:
        return torch.nonzero(cond, as_tuple=True)
    x, y = _pair(x, y)
    return torch.where(cond.to(x.device), x, y)


def clip(a, a_min=None, a_max=None):
    """Elementwise clip to [a_min, a_max] (either may be None)."""
    return torch.clamp(_tensor(a), a_min, a_max)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_pair(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(torch.all(isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)))


def array_equal(a1, a2, equal_nan=False):
    a1, a2 = _pair(a1, a2)
    if a1.shape != a2.shape:
        return False
    eq = a1 == a2
    if equal_nan:
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return bool(torch.all(eq))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(_tensor(x), nan=nan, posinf=posinf, neginf=neginf)


# ----------------------------------------------------------------------------
# Shape ops
# ----------------------------------------------------------------------------
def hstack(tensors):
    return torch.hstack([_tensor(t) for t in tensors])


def vstack(tensors):
    return torch.vstack([_tensor(t) for t in tensors])


def tile(A, reps):
    return torch.tile(_tensor(A), (reps,) if isinstance(reps, int) else tuple(reps))


def take(a, indices, axis=None):
    a = _tensor(a)
    idx = _tensor(indices).to(device=a.device, dtype=torch.int64)
    if axis is None:
        return a.reshape(-1)[idx]
    ax = axis % a.ndim
    return torch.index_select(a, ax, idx.reshape(-1)).reshape(
        a.shape[:ax] + idx.shape + a.shape[ax + 1:])


def split(ary, indices_or_sections, axis=0):
    """numpy.split: an int splits into that many equal parts (an error if
    they cannot be equal), a sequence gives the split points."""
    ary = _tensor(ary)
    if isinstance(indices_or_sections, int):
        if ary.shape[axis] % indices_or_sections:
            raise ValueError("array split does not result in an equal division")
        return list(torch.tensor_split(ary, indices_or_sections, dim=axis))
    return list(torch.tensor_split(ary, [int(i) for i in indices_or_sections], dim=axis))


def squeeze(a, axis=None):
    a = _tensor(a)
    return torch.squeeze(a) if axis is None else torch.squeeze(a, axis)


def expand_dims(a, axis):
    a = _tensor(a)
    for ax in sorted(axis if isinstance(axis, (tuple, list)) else (axis,)):
        a = torch.unsqueeze(a, ax)
    return a


def atleast_2d(x):
    return torch.atleast_2d(_tensor(x))


def transpose(x, dim0, dim1):
    """Torch-style transpose: swap two dimensions."""
    return torch.transpose(_tensor(x), dim0, dim1)


def meshgrid(*xi, indexing="xy"):
    return list(torch.meshgrid(*[_tensor(x) for x in xi], indexing=indexing))


def _linspace(start, stop, num, endpoint, dtype):
    """numpy.linspace's arithmetic: start + k * step, the last point set to
    stop when it is included."""
    dev, dtype = get_device(), dtype or _dtype
    start = torch.as_tensor(_onp.asarray(to_np(start)), dtype=dtype, device=dev)
    stop = torch.as_tensor(_onp.asarray(to_np(stop)), dtype=dtype, device=dev)
    div = (num - 1) if endpoint else num
    k = torch.arange(num, dtype=dtype, device=dev).reshape((num,) + (1,) * start.ndim)
    step = (stop - start) / div if div > 0 else torch.full_like(start, torch.nan)
    y = start + k * (step if div > 0 else 0.0)
    if endpoint and num > 1:
        y[-1] = stop
    return y, step


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None, axis=0):
    y, step = _linspace(start, stop, num, endpoint, dtype)
    y = torch.movedim(y, 0, axis)
    return (y, step) if retstep else y


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, axis=0):
    y, _ = _linspace(start, stop, num, endpoint, dtype)
    return torch.movedim(torch.pow(base, y), 0, axis)


# ----------------------------------------------------------------------------
# Reductions, sorting and statistics
# ----------------------------------------------------------------------------
def mean(a, axis=None, keepdims=False, dtype=None):
    a = _float(a) if dtype is None else _tensor(a).to(dtype)
    return _reduce(torch.mean, a, axis, keepdims)


def var(a, axis=None, ddof=0, keepdims=False):
    a = _float(a)
    if axis is None:
        return _keep_all(torch.var(a, correction=ddof), a, keepdims)
    return torch.var(a, dim=axis, correction=ddof, keepdim=keepdims)


def std(a, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(var(a, axis=axis, ddof=ddof, keepdims=keepdims))


def prod(a, axis=None, keepdims=False):
    return _reduce(torch.prod, _tensor(a), axis, keepdims)


def _flat_if_none(a, axis):
    a = _tensor(a)
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def cumsum(a, axis=None):
    a, axis = _flat_if_none(a, axis)
    return torch.cumsum(a, dim=axis)


def diff(a, n=1, axis=-1):
    return torch.diff(_tensor(a), n=n, dim=axis)


def argmin(a, axis=None, keepdims=False):
    return torch.argmin(_tensor(a), dim=axis, keepdim=keepdims)


def argmax(a, axis=None, keepdims=False):
    return torch.argmax(_tensor(a), dim=axis, keepdim=keepdims)


def sort(a, axis=-1):
    a, axis = _flat_if_none(a, axis)
    return torch.sort(a, dim=axis, stable=True).values


def argsort(a, axis=-1):
    a, axis = _flat_if_none(a, axis)
    return torch.argsort(a, dim=axis, stable=True)


def unique(ar, return_index=False, return_inverse=False, return_counts=False, axis=None):
    """Sorted unique values (of the flattened array unless axis is given),
    with numpy.unique's indices of first occurrence, inverse and counts."""
    ar = _tensor(ar)
    if axis is None:
        ar = ar.reshape(-1)
    vals, inv, counts = torch.unique(ar, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = inv.shape[0]
        first = torch.full((counts.shape[0],), n, dtype=torch.int64, device=ar.device)
        out.append(first.scatter_reduce(0, inv, torch.arange(n, device=ar.device), "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def cov(m, y=None, rowvar=True, bias=False, ddof=None):
    """numpy.cov: rows are variables unless rowvar is False."""
    def rows(a):
        a = torch.atleast_2d(_float(a))
        return a.mT if not rowvar and a.shape[0] != 1 else a

    X = rows(m)
    if y is not None:
        X = torch.cat([X, rows(y).to(X.device)], dim=0)
    correction = (0 if bias else 1) if ddof is None else ddof
    return torch.cov(X, correction=correction)


def quantile(a, q, axis=None, method="linear", keepdims=False):
    a = _float(a)
    qt = torch.as_tensor(_onp.asarray(to_np(q)), dtype=a.dtype, device=a.device)
    return torch.quantile(a, qt, dim=axis, keepdim=keepdims, interpolation=method)


def percentile(a, q, axis=None, method="linear", keepdims=False):
    return quantile(a, _onp.asarray(to_np(q), dtype=float) / 100.0, axis=axis,
                    method=method, keepdims=keepdims)


def norm(x, ord=None, axis=None, keepdims=False):
    """numpy.linalg.norm (a vector or a matrix norm, by x's rank and axis)."""
    return torch.linalg.norm(_float(x), ord=ord, dim=axis, keepdim=keepdims)


def trace(a, offset=0, axis1=0, axis2=1):
    return torch.sum(torch.diagonal(_tensor(a), offset, axis1, axis2), dim=-1)


def inner(a, b):
    return torch.inner(*_pair(a, b))


def outer(a, b):
    a, b = _pair(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def convolve(a, v, mode="full"):
    """numpy.convolve of two 1-D arrays ('full', 'same' or 'valid')."""
    a, v = _pair(a, v)
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    n, k = a.shape[0], v.shape[0]
    full = torch.nn.functional.conv1d(a.reshape(1, 1, -1), v.flip(0).reshape(1, 1, -1),
                                      padding=k - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        return full[(k - 1) // 2:(k - 1) // 2 + n]
    if mode == "valid":
        return full[k - 1:n]
    raise ValueError(f"mode must be 'full', 'same' or 'valid', got {mode!r}")


# ----------------------------------------------------------------------------
# Distances
# ----------------------------------------------------------------------------
_CDIST_BLOCK_BUDGET = 2**27  # max elements of the (b, m, d) difference tensor


class _SafeSqrt(torch.autograd.Function):
    """sqrt with a zero subgradient at 0.

    d/dx sqrt(x) at x=0 is +inf, which poisons autodiff through the gram
    diagonal (coincident points); 0 is the subgradient used there, as in
    the JAX package's custom_jvp ``_safe_sqrt``.  Plain torch ops, so
    torch.func transforms generate its vmap rule.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(d2):
        return torch.sqrt(d2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

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
    x = torch.atleast_2d(_tensor(x))
    y = torch.atleast_2d(_tensor(y))
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

    xt = _tensor(x)
    return distance.scaled_distance(_tensor(loginvrho), xt, xt if y is x else _tensor(y))


def scaled_distance_elementwise(loginvrho, x, y):
    """||exp(loginvrho) * (x_i - y_i)|| row by row (K1d on CUDA tensors);
    zeros when y is x or None."""
    same = x is y or y is None
    x = _tensor(x)
    if same:
        return torch.zeros((x.shape[0],), dtype=_dtype, device=x.device)
    from gpmp_tpu_torch.ops import distance  # ops imports this module

    return distance.scaled_distance_elementwise(_tensor(loginvrho), x, _tensor(y))


# ----------------------------------------------------------------------------
# Linear algebra (LU-free: Cholesky and QR only, as in the JAX package)
# ----------------------------------------------------------------------------
def cholesky(A):
    """Lower Cholesky factor, NaN-filled where A is not positive definite.

    ``torch.linalg.cholesky`` raises (and synchronises with the device to
    do so); ``cholesky_ex`` reports failure in ``info`` instead, and the
    factor is masked on the device.
    """
    L, info = torch.linalg.cholesky_ex(_tensor(A))
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def solve_triangular(A, b, lower=False, trans=0):
    """Solve A x = b (trans=0) or A^T x = b (trans=1) for triangular A.

    Keeps the JAX/SciPy signature: ``lower=`` rather than torch's
    ``upper=``, and a vector right-hand side is accepted.
    """
    A, b = _tensor(A), _tensor(b)
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
    Q, R = torch.linalg.qr(_tensor(A))
    return solve_triangular(R, Q.mT @ _tensor(b), lower=False)


def qr(a, mode="reduced"):
    return torch.linalg.qr(_tensor(a), mode=mode)


def logdet(A):
    """log|A| for symmetric positive-definite A via Cholesky (NaN if not PD)."""
    L = cholesky(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def cholesky_inv(A):
    A = _tensor(A)
    n = A.shape[-1]
    L = cholesky(A)
    T = solve_triangular(L, torch.eye(n, dtype=A.dtype, device=A.device), lower=True)
    return T.mT @ T


def cholesky_solve(A, b):
    """Solve A x = b for SPD A via Cholesky.  Returns (x, L).

    On a non-PD matrix the factor and the solution are NaN; nothing raises.
    """
    L = cholesky(A)
    y = solve_triangular(L, _tensor(b), lower=True)
    x = solve_triangular(L.mT, y, lower=False)
    return x, L


def cho_factor(a, lower=False, overwrite_a=False, check_finite=True):
    """scipy.linalg.cho_factor: (factor, lower), the factor NaN where a is
    not positive definite; the other triangle is zero."""
    L = cholesky(a)
    return (L if lower else L.mT), lower


def cho_solve(c_and_lower, b, overwrite_b=False, check_finite=True):
    """Solve a x = b from cho_factor's (factor, lower)."""
    c, lower = c_and_lower
    L = c if lower else c.mT
    return solve_triangular(L.mT, solve_triangular(L, b, lower=True), lower=False)


# General matrices: library calls (LU), outside any kernel of the port.
def slogdet(A):
    """(sign, log|det A|) of a square matrix."""
    return torch.linalg.slogdet(_float(A))


def det(A):
    return torch.linalg.det(_float(A))


def inv(A):
    return torch.linalg.inv(_float(A))


def cond(x, p=None):
    return torch.linalg.cond(_float(x), p)


def eigh(a, UPLO="L"):
    """Eigenvalues (ascending) and eigenvectors of a symmetric matrix."""
    return torch.linalg.eigh(_float(a), UPLO=UPLO)


def svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    """numpy.linalg.svd: (U, S, Vh), or S alone when compute_uv is False."""
    a = _float(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    return torch.linalg.svd(a, full_matrices=full_matrices)


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


def _size(size):
    return () if size is None else (size if isinstance(size, tuple) else (size,))


def choice(a, size=None, replace=True, p=None, generator=None):
    """Draws from a (an int n stands for arange(n)), with or without
    replacement, optionally with probabilities p."""
    gen = _generator(generator)
    pool = torch.arange(a, device=gen.device) if isinstance(a, int) else asarray(a)
    shape = _size(size)
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


def _loc_scale(x, loc, scale):
    x = _float(x)
    return (x, torch.as_tensor(loc, dtype=x.dtype, device=x.device),
            torch.as_tensor(scale, dtype=x.dtype, device=x.device))


class normal:
    """scipy.stats.norm-like interface (the formulas of jax.scipy.stats.norm)."""

    @staticmethod
    def logpdf(x, loc=0.0, scale=1.0):
        x, loc, scale = _loc_scale(x, loc, scale)
        log_normalizer = torch.log(2.0 * math.pi * scale * scale)
        quadratic = (x - loc) ** 2 / (scale * scale)
        return (log_normalizer + quadratic) / -2.0

    @staticmethod
    def pdf(x, loc=0.0, scale=1.0):
        return torch.exp(normal.logpdf(x, loc, scale))

    @staticmethod
    def cdf(x, loc=0.0, scale=1.0):
        x, loc, scale = _loc_scale(x, loc, scale)
        return torch.special.ndtr((x - loc) / scale)

    @staticmethod
    def logcdf(x, loc=0.0, scale=1.0):
        x, loc, scale = _loc_scale(x, loc, scale)
        return torch.special.log_ndtr((x - loc) / scale)

    @staticmethod
    def ppf(q, loc=0.0, scale=1.0):
        q, loc, scale = _loc_scale(q, loc, scale)
        return torch.special.ndtri(q) * scale + loc

    @staticmethod
    def rvs(loc=0.0, scale=1.0, size=None, generator=None):
        gen = _generator(generator)
        z = torch.randn(_size(size), generator=gen, dtype=_dtype, device=gen.device)
        _, loc, scale = _loc_scale(z, loc, scale)
        return loc + scale * z


def _is_scalar_cov(cov):
    return isscalar(cov) or (isarray(cov) and math.prod(cov.shape) == 1)


class multivariate_normal:
    """scipy.stats.multivariate_normal-like interface.

    rvs and logpdf are tensor ops; cdf is SciPy's on the host (no closed
    form), as in the JAX package.  Draws take ``generator=`` and default to
    the module generator; the covariance's root is its SVD's, as the JAX
    package's ``method="svd"``.
    """

    @staticmethod
    def _mean_array(mean, d):
        m = asdouble(mean)
        if m.ndim == 0:
            return torch.full((d,), float(m), dtype=_dtype, device=m.device)
        m = m.reshape(-1)
        if m.numel() != d:
            raise ValueError("mean has incompatible length.")
        return m

    @staticmethod
    def rvs(mean=0.0, cov=1.0, n=1, generator=None):
        gen = _generator(generator)
        if _is_scalar_cov(cov):
            c = torch.sqrt(asdouble(cov).reshape(())).to(gen.device)
            z = torch.randn((n,), generator=gen, dtype=_dtype, device=gen.device)
            return asdouble(mean).to(gen.device) + c * z
        covm = asdouble(cov).to(gen.device)
        if covm.ndim != 2 or covm.shape[0] != covm.shape[1]:
            raise ValueError("cov must be a scalar or a square 2D matrix.")
        d = covm.shape[0]
        m = multivariate_normal._mean_array(mean, d).to(gen.device)
        U, s, _ = torch.linalg.svd(covm)
        z = torch.randn((n, d), generator=gen, dtype=_dtype, device=gen.device)
        out = m + z @ (U * torch.sqrt(s)).mT
        return out[0] if n == 1 else out

    @staticmethod
    def logpdf(x, mean=0.0, cov=1.0):
        if _is_scalar_cov(cov):
            return normal.logpdf(x, mean, torch.sqrt(asdouble(cov).reshape(())))
        covm = asdouble(cov)
        d = covm.shape[0]
        x = asdouble(x).to(covm.device)
        m = multivariate_normal._mean_array(mean, d).to(covm.device)
        L = torch.linalg.cholesky(covm)
        y = torch.linalg.solve_triangular(L, (x - m).reshape(-1, d).mT, upper=False)
        out = (-0.5 * torch.sum(y * y, dim=0) - torch.sum(torch.log(torch.diagonal(L)))
               - 0.5 * d * math.log(2.0 * math.pi))
        return out.reshape(x.shape[:-1])

    @staticmethod
    def cdf(x, mean=0.0, cov=1.0):
        import scipy.stats as _sps

        if _is_scalar_cov(cov):
            return normal.cdf(x, mean, torch.sqrt(asdouble(cov).reshape(())))
        covm = _onp.asarray(to_np(cov), dtype=float)
        m = to_np(multivariate_normal._mean_array(mean, covm.shape[0]))
        xm = _onp.asarray(to_np(x), dtype=float)
        return asarray(_onp.asarray(_sps.multivariate_normal.cdf(xm, mean=m, cov=covm)))


class Normal:
    """torch.distributions.Normal-like wrapper over ``normal``."""

    def __init__(self, loc, scale):
        self.loc = asdouble(loc)
        self.scale = asdouble(scale).to(self.loc.device)

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return self.scale

    @property
    def variance(self):
        return self.scale**2

    def log_prob(self, x):
        return normal.logpdf(asdouble(x), self.loc, self.scale)

    def cdf(self, x):
        return normal.cdf(asdouble(x), self.loc, self.scale)

    def icdf(self, q):
        return normal.ppf(asdouble(q), self.loc, self.scale)

    def sample(self, sample_shape=(), generator=None):
        gen = _generator(generator)
        shape = tuple(sample_shape) + torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        z = torch.randn(shape, generator=gen, dtype=_dtype, device=gen.device)
        return self.loc + self.scale * z

    rsample = sample


class MultivariateNormal:
    """torch.distributions.MultivariateNormal-like wrapper."""

    def __init__(self, loc, covariance_matrix):
        self.loc = torch.atleast_1d(asdouble(loc))
        self.covariance_matrix = asdouble(covariance_matrix).to(self.loc.device)

    @property
    def mean(self):
        return self.loc

    def log_prob(self, x):
        return multivariate_normal.logpdf(x, self.loc, self.covariance_matrix)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape)
        out = multivariate_normal.rvs(self.loc, self.covariance_matrix,
                                      n=math.prod(shape), generator=generator)
        return out.reshape(shape + self.loc.shape)

    rsample = sample


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

    def evaluate_batch(self, P):
        """Values at the rows of an (m, p) stack of parameter vectors, NaN
        mapped to +inf, as a NumPy vector.

        The rows go one after the other through the criterion that
        ``evaluate_no_grad`` calls (on the card each launches the gram
        kernel as a single call does; the JAX package vmaps the rows into
        one program instead), and the values come back in one transfer.
        """
        P = _onp.asarray(P, dtype=float)
        with torch.no_grad():
            vals = torch.stack([self.crit(asarray(p), self.x, self.z).reshape(())
                                for p in P])
        vals = vals.to(device="cpu", dtype=torch.float64).numpy()
        return _onp.where(_onp.isfinite(vals), vals, _onp.inf)


class BatchDifferentiableSelectionCriterion:
    """A criterion summed over batches: value and gradient of each (xb, zb)
    batch of ``loader`` (any iterable of batches), accumulated on the host
    weighted by batch size, then averaged (reduction 'mean') or not ('sum').
    ``batches_per_eval`` > 0 takes that many batches per evaluation, cycling
    through the loader; 0 takes them all."""

    def __init__(self, crit, loader, reduction="mean", batches_per_eval=0):
        if reduction not in ("mean", "sum"):
            raise ValueError("reduction must be 'mean' or 'sum'")
        if batches_per_eval < 0:
            raise ValueError("batches_per_eval must be >= 0")
        self.crit = crit
        self.loader = loader
        self.reduction = reduction
        self.bpe = int(batches_per_eval)
        self._batch_iter = iter(loader) if self.bpe > 0 else None
        self._cache_p = None
        self._cache_g = None

    def __call__(self, p):
        return self.evaluate_no_grad(p)

    def _batches(self):
        if self.bpe == 0:
            yield from self.loader
        else:
            for _ in range(self.bpe):
                try:
                    yield next(self._batch_iter)
                except StopIteration:
                    self._batch_iter = iter(self.loader)
                    yield next(self._batch_iter)

    def _accumulate(self, p):
        pnp = _onp.asarray(p, dtype=float)
        total, gtotal, n_samples = 0.0, _onp.zeros(pnp.shape), 0
        for xb, zb in self._batches():
            pt = asarray(pnp).requires_grad_(True)
            value = self.crit(pt, asarray(xb), asarray(zb)).reshape(())
            (g,) = torch.autograd.grad(value, pt)
            vg = torch.cat([value.detach().reshape(1), g.reshape(-1)])
            vg = vg.to(device="cpu", dtype=torch.float64).numpy()
            bs = xb.shape[0]
            total += float(vg[0]) * bs
            gtotal += vg[1:].reshape(pnp.shape) * bs
            n_samples += bs
        if n_samples == 0:
            raise ValueError("Loader is empty.")
        if self.reduction == "mean":
            total /= n_samples
            gtotal /= n_samples
        if not _onp.isfinite(total):
            return _onp.inf, _onp.zeros_like(gtotal)
        if not _onp.all(_onp.isfinite(gtotal)):
            gtotal = _onp.zeros_like(gtotal)
        return total, gtotal

    def evaluate(self, p):
        value, g = self._accumulate(p)
        self._cache_p, self._cache_g = _onp.array(p, dtype=float), g
        return value

    def evaluate_pre_grad(self, p):
        return self.evaluate(p)

    def evaluate_no_grad(self, p):
        value, _ = self._accumulate(p)
        return value

    def gradient(self, p):
        pnp = _onp.asarray(p, dtype=float)
        if self._cache_p is not None and _onp.array_equal(pnp, self._cache_p):
            return self._cache_g
        _, g = self._accumulate(p)
        return g


class SecondOrderDifferentiableFunction:
    """Value, gradient and Hessian of a scalar function of a parameter vector
    (``torch.autograd``; the Hessian by ``torch.autograd.functional.hessian``).

    The mixed Cholesky engine's Functions have first-order rules only and
    raise when asked for a second derivative: the Hessian is then computed
    again with the f64 engine pinned, and that is logged; later Hessians of
    this function keep the f64 engine."""

    def __init__(self, f):
        self.f = f
        self._pin_f64 = False
        self._theta = None
        self._value = None

    def evaluate(self, theta):
        self._theta = asdouble(theta).detach()
        self._value = self.f(self._theta)
        return self._value

    def gradient(self):
        theta = self._theta.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(self.f(theta), theta)
        return g

    def _hessian(self):
        return torch.autograd.functional.hessian(self.f, self._theta.clone())

    def hessian(self):
        from gpmp_tpu_torch.ops.autograd import SecondOrderNotImplemented

        if not self._pin_f64:
            try:
                return self._hessian()
            except SecondOrderNotImplemented:
                pass
            get_logger().warning(
                "The mixed Cholesky engine has no second-order rule; computing "
                "this Hessian again with the exact f64 engine.")
            self._pin_f64 = True
        from gpmp_tpu_torch.config import get_chol_engine, set_chol_engine

        prev = get_chol_engine()
        set_chol_engine("f64")
        try:
            return self._hessian()
        finally:
            set_chol_engine(prev)


def grad(f):
    """The gradient function of a scalar function f (autodiff)."""

    def grad_f(x):
        x = asdouble(x).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(x), x)
        return g

    return grad_f


def value_and_grad(f, x, **unused):
    """(f(x), grad f(x))."""
    x = asdouble(x).detach().requires_grad_(True)
    y = f(x)
    (g,) = torch.autograd.grad(y, x)
    return y.detach(), g


# ----------------------------------------------------------------------------
# Shared helpers
# ----------------------------------------------------------------------------
_gammaln_table = {}


def compute_gammaln(up_to_p: int):
    """gammaln(k) for k = 0..2p+1, from a table cached per device."""
    n = 2 * up_to_p + 2
    dev = get_device()
    table = _gammaln_table.get(dev)
    if table is None or table.shape[0] < n:
        table = torch.special.gammaln(
            torch.arange(builtins.max(n, 64), dtype=_dtype, device=dev))
        _gammaln_table[dev] = table
    return table[:n]


def derivative_finite_diff(f, x, h):
    """5-point central difference derivative of f with respect to scalar x."""
    f_x_p2 = f(x + 2 * h)
    f_x_p1 = f(x + h)
    f_x_m1 = f(x - h)
    f_x_m2 = f(x - 2 * h)
    return (-f_x_p2 + 8 * f_x_p1 - 8 * f_x_m1 + f_x_m2) / (12.0 * h)


def try_with_postmortem(func, *args, **kwargs):
    """func(*args, **kwargs), dropping into pdb's post-mortem on an error."""
    try:
        return func(*args, **kwargs)
    except Exception:
        import pdb
        import sys
        import traceback

        traceback.print_exc()
        pdb.post_mortem(sys.exc_info()[2])


def custom_sqrt(x):
    """sqrt with a zero subgradient at 0 (the gram's coincident points)."""
    return _safe_sqrt(asdouble(x))


def scalar_safe(f):
    """f, its argument converted once (scalars, lists, NumPy arrays)."""

    def f_(x):
        return f(asarray(x))

    return f_


def axis_to_dim(f):
    """Adapter of a torch function taking ``dim`` to NumPy's ``axis``."""

    def f_(x, axis=None, **kwargs):
        if axis is None:
            return f(x, **kwargs)
        return f(x, dim=axis, **kwargs)

    return f_


def _is_linalg_exception(exc: Exception) -> bool:
    """Linalg failure surfaces as NaN here, not as an exception; kept for
    the optimizer loop's defensive path (as in the JAX package)."""
    msg = str(exc).lower()
    keywords = ("singular", "cholesky", "not positive definite", "linalg", "lapack")
    return builtins.any(k in msg for k in keywords)
