# gpmp_tpu_torch/parallel/comm.py
"""The collectives of the group mesh (parallel/mesh.py), on
``torch.distributed`` over the mesh's process group (NCCL, or gloo).

- ``gather_rows``: every rank's row slab, concatenated in rank order (the
  counterpart of gpmp_tpu/parallel/chol.py ``_gather_rows``, a plain
  ``all_gather_into_tensor``; the JAX package's psum emulation is a TPU
  workaround and is not ported);
- ``all_reduce_sum_``: a sum over ranks in place (scalars, thin (n, m)
  results, a panel assembled from its owners);
- ``reduce_scatter_rows``: the sum over ranks of an (n, w) array, each rank
  keeping its row block;
- ``transpose_slab``: the slab of X^T from the slab of X, an
  ``all_to_all_single`` of (n/R, n/R) blocks;
- ``broadcast_``: rank ``src``'s tensor on every rank;
- ``replicate`` / ``psum``: the autograd pair of the replicated criteria.
  ``replicate`` is the identity whose backward sums the ranks' cotangents
  (a replicated input such as covparam enters each rank's graph through
  it); ``psum`` sums the ranks' contributions and its backward is the
  identity (a replicated value leaves the ranks' graphs through it).  So a
  gradient is the sum of every rank's part, on every rank.

``slab``, ``gather_rows``, ``all_reduce_sum_``, ``broadcast_``,
``replicate`` and ``psum`` take any mesh: on the one-card mesh (or None)
they are identities, so the callers need no branch.  On a group mesh every
collective runs, also at one rank (a gather or sum of one).

``psum``'s backward passes its cotangent on unchanged, which is right only
for a replicated cotangent: a replicated value that rank-local terms consume
enters them through ``replicate``.

``CALLS`` and ``BYTES`` count each collective's calls and the bytes of its
payload (the gathered or reduced tensor, the all-to-all's input) on this
rank; ``reset_counts`` zeroes them.
"""

import torch

from gpmp_tpu_torch.ops.autograd import first_order_only

_OPS = ("gather", "all_reduce", "reduce_scatter", "all_to_all", "broadcast")
CALLS = dict.fromkeys(_OPS, 0)
BYTES = dict.fromkeys(_OPS, 0)


def reset_counts():
    for k in _OPS:
        CALLS[k] = 0
        BYTES[k] = 0


def _count(op, t):
    CALLS[op] += 1
    BYTES[op] += t.numel() * t.element_size()


def _dist():
    import torch.distributed as dist

    return dist


def is_group(mesh):
    """True for a group mesh (torch.distributed ranks; slab arguments)."""
    return mesh is not None and mesh.is_group


def rows_of(n, mesh):
    """(off, n_loc): the global offset and count of this rank's rows (all n
    rows on the one-card mesh)."""
    if not is_group(mesh):
        return 0, n
    if n % mesh.size != 0:
        raise ValueError(f"n ({n}) must be divisible by the mesh's rank count ({mesh.size})")
    n_loc = n // mesh.size
    return mesh.rank * n_loc, n_loc


def slab(x, mesh):
    """This rank's rows of a replicated (n, ...) tensor (a view)."""
    off, n_loc = rows_of(x.shape[0], mesh)
    return x[off:off + n_loc]


def _no_graph(name, x):
    """The collectives below are not autograd operations: refuse a tensor
    whose gradient they would drop in silence (``psum`` and ``replicate``
    are the differentiable ones)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"comm.{name} is not differentiable: the result would carry no "
                           "gradient (differentiate the replicated criteria and predict)")


def gather_rows(x_loc, mesh):
    """(R n_loc, ...) from every rank's (n_loc, ...) slab, in rank order."""
    if not is_group(mesh):
        return x_loc
    _no_graph("gather_rows", x_loc)
    x_loc = x_loc.contiguous()
    out = torch.empty((mesh.size * x_loc.shape[0],) + tuple(x_loc.shape[1:]),
                      dtype=x_loc.dtype, device=x_loc.device)
    _dist().all_gather_into_tensor(out, x_loc, group=mesh.group)
    _count("gather", out)
    return out


def all_reduce_sum_(x, mesh):
    """x summed over the ranks, in place (x contiguous); returns x."""
    if not is_group(mesh):
        return x
    _no_graph("all_reduce_sum_", x)
    _dist().all_reduce(x, group=mesh.group)
    _count("all_reduce", x)
    return x


def reduce_scatter_rows(x, mesh):
    """(n_loc, ...): this rank's row block of the sum over ranks of x (n, ...)."""
    _no_graph("reduce_scatter_rows", x)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _dist().reduce_scatter_tensor(out, x, group=mesh.group)
    _count("reduce_scatter", x)
    return out


def transpose_slab(x_loc, mesh):
    """The (n_loc, n) slab of X^T from the (n_loc, n) slab of X (n = R n_loc):
    rank r sends its (n_loc, n_loc) block of columns [s n_loc, (s + 1) n_loc)
    to rank s and transposes what it receives."""
    _no_graph("transpose_slab", x_loc)
    n_loc, n = x_loc.shape
    R = mesh.size
    if n != R * n_loc:
        raise ValueError(f"a slab of a square matrix is (n/R, n); got {tuple(x_loc.shape)}")
    inp = x_loc.reshape(n_loc, R, n_loc).permute(1, 0, 2).contiguous()
    out = torch.empty_like(inp)
    _dist().all_to_all_single(out, inp, group=mesh.group)
    _count("all_to_all", inp)
    return out.permute(2, 0, 1).reshape(n_loc, n).contiguous()


def broadcast_(x, mesh, src=0):
    """Rank ``src``'s x on every rank, in place (x contiguous); returns x."""
    if not is_group(mesh):
        return x
    _no_graph("broadcast_", x)
    _dist().broadcast(x, src=src, group=mesh.group)
    _count("broadcast", x)
    return x


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    @first_order_only("replicate")
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.mesh), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum_(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate(x, mesh):
    """x (the same on every rank) into this rank's graph: its gradient is the
    sum over ranks of theirs."""
    return _Replicate.apply(x, mesh) if is_group(mesh) else x


def psum(x, mesh):
    """The sum over ranks of x, differentiable (backward: the identity)."""
    return _Sum.apply(x, mesh) if is_group(mesh) else x
