# gpmp_tpu_torch/parallel/mesh.py
"""Device-mesh helpers (counterpart of gpmp_tpu/parallel/mesh.py).

A mesh here is one card: the port's sharded criteria, predict and LOO run
on a single device, on the resident branch (parallel/chol.py,
parallel/mixed.py) or the streamed engine (parallel/streamed.py).  Meshes
of more than one card need torch.distributed/NCCL and are not ported yet
(ROADMAP queue 1 item 11).
"""

from gpmp_tpu_torch.config import get_device


class Mesh:
    """A one-device mesh: ``device`` (a torch.device) and ``shape``
    ({axis_name: 1}), the attributes the sharded functions read."""

    def __init__(self, device, axis_name="batch"):
        self.device = device
        self.shape = {axis_name: 1}
        self.size = 1

    def __repr__(self):
        return f"Mesh(device={self.device}, shape={self.shape})"


def make_mesh(n_devices=None, axis_name="batch"):
    """One-card mesh on the configured device (``config.get_device``).

    n_devices=None or 1; more raises NotImplementedError (multi-card meshes
    need NCCL, ROADMAP queue 1 item 11)."""
    if n_devices is not None and n_devices != 1:
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1; got {n_devices}")
        raise NotImplementedError(
            f"a mesh of {n_devices} devices is not ported yet: multi-card meshes need "
            "torch.distributed/NCCL (ROADMAP queue 1 item 11); use make_mesh(1)")
    return Mesh(get_device(), axis_name)


def default_mesh(axis_name="batch"):
    """The one-card mesh (all the devices the port drives today)."""
    return make_mesh(None, axis_name)
