"""n-D GP interpolation (Hartmann6) with REML selection and LOO check.

The gpmp_tpu_torch twin of examples/gpmp_tpu_example04_nd.py (it runs on the
card unless the CPU is asked for: GPMP_DEVICE=cpu); mirror of gpmp's
examples/gpmp_example04_nd.py.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    p = 2
    return gp.kernel.maternp_covariance(x, y, p, covparam, pairwise)


def main(show=False, ni=100, nt=500, seed=0):
    dim = 6
    box = [[0.0] * dim, [1.0] * dim]
    xi = gp.misc.designs.ldrandunif(dim, ni, box, seed=seed)
    zi = gp.misc.testfunctions.hartmann6(xi)
    xt = gp.misc.designs.ldrandunif(dim, nt, box, seed=seed + 1)
    zt = gp.misc.testfunctions.hartmann6(xt)

    model = gp.Model(constant_mean, kernel)
    model, info = gp.kernel.select_parameters_with_reml(model, xi, zi, info=True)

    zpm, zpv = model.predict(xi, zi, xt)
    gp.modeldiagnosis.perf(model, xi, zi, xtzt=(xt, zt), zpmzpv=(zpm, zpv))

    if show:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(zt, zpm, "ko", markersize=3)
        lo = min(zt.min(), zpm.min())
        hi = max(zt.max(), zpm.max())
        plt.plot([lo, hi], [lo, hi], "--")
        plt.xlabel("true")
        plt.ylabel("predicted")
        plt.title("Hartmann6 predictions")
        plt.show()
    return model, info


if __name__ == "__main__":
    main(show=True)
