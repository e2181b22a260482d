"""REMAP selection variation study on 1-D interpolation.

The gpmp_tpu_torch twin of
examples/gpmp_tpu_example20_1d_interpolation_variation_remap.py (it runs on
the card unless the CPU is asked for: GPMP_DEVICE=cpu): fit with REMAP for
several dataset draws and inspect the stability of the selected parameters.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)


def main(show=False, n_repeat=4, ni=8):
    box = [[-1], [1]]
    results = []
    for r in range(n_repeat):
        xi = gp.misc.designs.ldrandunif(1, ni, box, seed=100 + r)
        zi = gp.misc.testfunctions.twobumps(xi)
        model = gp.Model(constant_mean, kernel)
        model, info = gp.kernel.select_parameters_with_remap(
            model, xi, zi, info=True
        )
        results.append(gnp.to_np(model.covparam))
        print(
            f"draw {r}: covparam = {np.round(results[-1], 3)}, "
            f"J* = {info.fun:.4f}"
        )
    results = np.stack(results)
    print("covparam spread (std over draws):", np.round(results.std(axis=0), 3))

    if show:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(results[:, 0], results[:, 1], "o")
        plt.xlabel("log sigma2")
        plt.ylabel("log 1/rho")
        plt.title("REMAP selected parameters across dataset draws")
        plt.show()
    return results


if __name__ == "__main__":
    main(show=True)
