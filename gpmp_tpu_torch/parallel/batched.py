# gpmp_tpu_torch/parallel/batched.py
"""Data-parallel batched criterion evaluation over a mesh.

Counterpart of gpmp_tpu/parallel/batched.py.  The batches are laid out as
a (num_batches, b, d) tensor; on a group mesh each rank holds its share of
the batches, evaluates the criterion on each of them in turn (the gram
kernels' Functions launch once per batch; the JAX package vmaps the
batches into one program instead), and the differentiable ``comm.psum``
sums the ranks' parts into the global batch-size-weighted mean.  The
gradient is one ``torch.autograd.grad`` of that mean: covparam enters each
rank's graph through ``comm.replicate``, so every rank returns the same
replicated value and gradient.  On the one-card mesh both collectives are
the identity.
"""

import torch

import gpmp_tpu_torch.num as gnp
from . import comm


def shard_batches(x, z, n_batches, mesh=None, axis_name="batch"):
    """Stack (x, z) into (n_batches, b, d) / (n_batches, b) batch tensors,
    truncating the remainder, on the mesh's device when a mesh is given
    (else the configured device).

    With a mesh, n_batches must be a multiple of its rank count; on a group
    mesh the result is this rank's share of the batches (consecutive
    batches, rank r holding the r-th block).
    """
    x = gnp.asarray(x)
    z = gnp.asarray(z).reshape(-1)
    n, d = x.shape
    b = n // n_batches
    if b == 0:
        raise ValueError("n_batches larger than number of points")
    xb = x[: n_batches * b].reshape(n_batches, b, d)
    zb = z[: n_batches * b].reshape(n_batches, b)
    if mesh is not None:
        if n_batches % mesh.size != 0:
            raise ValueError(
                "n_batches must be divisible by the mesh batch-axis size"
            )
        xb = comm.slab(xb.to(mesh.device), mesh)
        zb = comm.slab(zb.to(mesh.device), mesh)
    return xb, zb


def make_data_parallel_criterion(criterion_fn, mesh, axis_name="batch"):
    """(value, grad) of the mean per-point criterion over the mesh's batches.

    criterion_fn: f(p, x_batch, z_batch) -> scalar (e.g. the REML of one
    batch).  The total is sum_b f(p, xb, zb) * b_size / n, the semantics of
    gnp.BatchDifferentiableSelectionCriterion with reduction='mean'.

    Returns value_and_grad_fn(p, xb, zb) -> (value, grad), tensors, where
    xb is (local_batches, b, d): all the batches on the one-card mesh, this
    rank's share on a group mesh (shard_batches' output).
    """

    def value_and_grad(p, xb, zb):
        pt = gnp.asarray(p).detach().requires_grad_(True)
        pr = comm.replicate(pt, mesh)
        vals = torch.stack([criterion_fn(pr, xb[i], zb[i]).reshape(())
                            for i in range(xb.shape[0])])
        total = comm.psum(torch.sum(vals * xb.shape[1]), mesh)
        n_samples = xb.shape[0] * mesh.size * xb.shape[1]
        value = total / n_samples
        (g,) = torch.autograd.grad(value, pt)
        return value.detach(), g

    return value_and_grad
