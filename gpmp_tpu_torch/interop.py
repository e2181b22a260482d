# gpmp_tpu_torch/interop.py
"""Parameters, datasets and MH sampler states from the JAX package (or
anywhere else) into the port.

Takes numpy arrays only and imports no JAX: pass
``np.asarray(jax_model.covparam)``, a JAX Dataset's shards as
``[np.asarray(s) for s in ds.x_list]``, or a JAX MetropolisHastings's
``get_state()``.
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


def mh_state_from_numpy(sampler, arrays, meta, *, seed):
    """Carry a gpmp_tpu MetropolisHastings state (its ``get_state()``:
    ``arrays`` as NumPy arrays, ``meta`` a dict) into the port's
    ``sampler`` (a gpmp_tpu_torch.mcmc.MetropolisHastings built with the
    same n_chains and dim): the positions, traces, proposal parameters,
    Haario factors, mode and counters.  The JAX PRNG key cannot be carried:
    the sampler's generator is seeded from ``seed`` instead."""
    import torch

    if meta.get("kind") != "MetropolisHastings":
        raise ValueError(f"Not an MH state: {meta.get('kind')!r}")
    if (meta["n_chains"], meta["dim"]) != (sampler.n_chains, sampler.dim):
        raise ValueError(
            "State shape mismatch: the sampler has "
            f"({sampler.n_chains}, {sampler.dim}), the state "
            f"({meta['n_chains']}, {meta['dim']}).")
    for name, value in arrays.items():
        if isinstance(value, torch.Tensor):
            raise TypeError(f"mh_state_from_numpy takes numpy arrays; {name} is a tensor")
    sampler._set_traces_and_adaptation(
        {k: np.asarray(v) for k, v in arrays.items() if k != "key"}, meta)
    sampler._generator = torch.Generator().manual_seed(int(seed))
    return sampler
