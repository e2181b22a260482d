# gpmp_tpu_torch/interop.py
"""Parameters and datasets from the JAX package (or anywhere else) into
the port.

Takes numpy arrays only and imports no JAX: pass
``np.asarray(jax_model.covparam)``, or a JAX Dataset's shards as
``[np.asarray(s) for s in ds.x_list]``.
"""

import numpy as np
import torch


def params_from_numpy(covparam, meanparam=None, *, device, dtype):
    """(covparam, meanparam) as 1-D tensors on ``device`` in ``dtype``;
    meanparam stays None when it is None."""

    def conv(a):
        if isinstance(a, torch.Tensor):
            raise TypeError("params_from_numpy takes numpy arrays, not tensors")
        return torch.as_tensor(np.array(a, dtype=np.float64).reshape(-1),
                               dtype=dtype, device=device)

    return conv(covparam), (None if meanparam is None else conv(meanparam))


def dataset_from_numpy(x, z, *, device, dtype):
    """A gpmp_tpu_torch.dataloader.Dataset of ``x`` and ``z``, each one NumPy
    array or a list of shards (NumPy arrays), copied to ``device`` in
    ``dtype`` shard by shard."""
    from gpmp_tpu_torch.dataloader import Dataset

    def conv(a):
        if isinstance(a, torch.Tensor):
            raise TypeError("dataset_from_numpy takes numpy arrays, not tensors")
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)

    def shards(obj):
        return [conv(a) for a in obj] if isinstance(obj, (list, tuple)) else conv(obj)

    return Dataset(shards(x), shards(z))
