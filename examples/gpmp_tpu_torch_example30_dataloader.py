"""Large-n REMAP via DataLoader-batched criterion + LOO + performance.

The gpmp_tpu_torch twin of examples/gpmp_tpu_example30_dataloader.py (it
runs on the card unless the CPU is asked for: GPMP_DEVICE=cpu): ni=1000,
d=6, batch size 200; batched REMAP selection, then LOO diagnostics and
performance report on a subsample.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.dataloader import DataLoader, Dataset


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    return gp.kernel.maternp_covariance(x, y, 2, covparam, pairwise)


def generate_data(ni=1000, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(ni, dim))
    zi = np.asarray(gp.misc.testfunctions.hartmann6(xi))
    return xi, zi


def main(show=False, ni=1000, batch_size=200, seed=0):
    xi, zi = generate_data(ni=ni, seed=seed)

    dataset = Dataset(gnp.asarray(xi), gnp.asarray(zi))
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        seed=seed, drop_last=True)

    model = gp.Model(constant_mean, kernel)
    model, info = gp.kernel.select_parameters_with_remap(
        model, dataloader=loader, info=True
    )
    print("batched REMAP covparam:", np.round(gnp.to_np(model.covparam), 3))

    # LOO + performance on a subsample (full LOO is O(n^3) on one factor)
    n_eval = min(400, ni)
    xe, ze = xi[:n_eval], zi[:n_eval]
    zloo, s2loo, eloo = model.loo(xe, ze)
    gp.modeldiagnosis.perf(model, xe, ze,
                           loo_res=(zloo, s2loo, eloo))

    if show:
        gp.plot.plot_loo(ze, gnp.to_np(zloo), gnp.to_np(s2loo))
    return model, info


if __name__ == "__main__":
    main(show=True)
