# gpmp_tpu_torch/interop.py
"""Parameters from the JAX package (or anywhere else) into the port.

Takes numpy arrays only and imports no JAX: pass
``np.asarray(jax_model.covparam)``.
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
