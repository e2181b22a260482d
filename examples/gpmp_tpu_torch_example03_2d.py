"""2-D GP interpolation of the Branin-Hoo function with REML selection.

The gpmp_tpu_torch twin of examples/gpmp_tpu_example03_2d.py (it runs on the
card unless the CPU is asked for: GPMP_DEVICE=cpu); mirror of gpmp's
examples/gpmp_example03_2d.py.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp


def generate_data(seed=0):
    dim = 2
    box = [[-5.0, 0.0], [10.0, 15.0]]
    nt = 400
    xt = gp.misc.designs.regulargrid(dim, [20, 20], box)
    zt = gp.misc.testfunctions.braninhoo(xt)
    ni = 30
    xi = gp.misc.designs.maximinlhs(dim, ni, box, seed=seed, max_iter=200)
    zi = gp.misc.testfunctions.braninhoo(xi)
    return xt, zt, xi, zi


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    p = 2
    return gp.kernel.maternp_covariance(x, y, p, covparam, pairwise)


def main(show=False):
    xt, zt, xi, zi = generate_data()
    model = gp.Model(constant_mean, kernel)
    model, info = gp.kernel.select_parameters_with_reml(model, xi, zi, info=True)
    zpm, zpv = model.predict(xi, zi, xt)
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    print(f"2D Branin-Hoo RMSE = {rmse:.4f}")

    gp.modeldiagnosis.perf(model, xi, zi, xtzt=(xt, zt), zpmzpv=(zpm, zpv))

    if show:
        import matplotlib.pyplot as plt

        n = int(np.sqrt(xt.shape[0]))
        plt.figure()
        plt.contourf(
            xt[:, 0].reshape(n, n), xt[:, 1].reshape(n, n), zpm.reshape(n, n)
        )
        plt.plot(np.asarray(xi)[:, 0], np.asarray(xi)[:, 1], "rs")
        plt.colorbar()
        plt.title("Posterior mean (Branin-Hoo)")
        plt.show()
    return model, rmse


if __name__ == "__main__":
    main(show=True)
