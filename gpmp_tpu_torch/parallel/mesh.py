# gpmp_tpu_torch/parallel/mesh.py
"""Device-mesh helpers (counterpart of gpmp_tpu/parallel/mesh.py).

Two kinds of mesh:

- the one-card mesh: no process group; the sharded criteria, predict and
  LOO run on one device, on the resident branch (parallel/chol.py,
  parallel/mixed.py) or the streamed engine (parallel/streamed.py);
- the group mesh: one process per rank over the default
  ``torch.distributed`` process group, rank r holding rows
  [r n / R, (r + 1) n / R) of every n-row object (the JAX package's
  ``P(axis_name, None)``).  Its functions run the per-rank algorithms with
  the collectives of parallel/comm.py, also at one rank (gathers of one),
  and never stream.

A group mesh's device: on NCCL the card ``cuda:LOCAL_RANK`` (the launcher's
environment variable, else the rank); on gloo the configured device
(``config.get_device``), the CPU in tests or one card shared by the ranks.
"""

import os

import torch

from gpmp_tpu_torch.config import get_device


class Mesh:
    """A mesh: ``device`` (a torch.device), ``shape`` ({axis_name: size}),
    ``size``, ``rank`` and ``group`` (the process group; None for the
    one-card mesh)."""

    def __init__(self, device, axis_name="batch", group=None, rank=0, size=1):
        self.device = torch.device(device)
        self.shape = {axis_name: size}
        self.size = size
        self.rank = rank
        self.group = group

    @property
    def is_group(self):
        return self.group is not None

    def __repr__(self):
        kind = f", rank={self.rank}, group" if self.is_group else ""
        return f"Mesh(device={self.device}, shape={self.shape}{kind})"


def _group_device(backend, rank):
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return torch.device(get_device())


def make_mesh(n_devices=None, axis_name="batch"):
    """A mesh over the default process group when torch.distributed is
    initialized (``n_devices`` None or its world size), else the one-card
    mesh on the configured device (``n_devices`` None or 1)."""
    import torch.distributed as dist

    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1; got {n_devices}")
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"n_devices={n_devices} differs from the process group's "
                             f"world size {size}")
        rank = dist.get_rank()
        return Mesh(_group_device(dist.get_backend(), rank), axis_name,
                    group=dist.group.WORLD, rank=rank, size=size)
    if n_devices is not None and n_devices != 1:
        raise RuntimeError(
            f"a mesh of {n_devices} ranks runs one process per rank: start {n_devices} "
            "processes and call torch.distributed.init_process_group in each (world size "
            f"{n_devices}) before make_mesh")
    return Mesh(get_device(), axis_name)


def default_mesh(axis_name="batch"):
    """make_mesh(None): the process group's mesh, or the one-card mesh."""
    return make_mesh(None, axis_name)
