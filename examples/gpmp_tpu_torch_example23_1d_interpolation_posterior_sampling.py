"""Posterior sampling of covariance parameters after REMAP (MH + NUTS).

The gpmp_tpu_torch twin of
examples/gpmp_tpu_example23_1d_interpolation_posterior_sampling.py (it runs
on the card unless the CPU is asked for: GPMP_DEVICE=cpu): fit with REMAP,
then sample the covparam posterior with adaptive MH and with NUTS, and
compare the posterior clouds against the MAP estimate.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.kernel  # noqa: F401
import gpmp_tpu_torch.mcmc  # noqa: F401
import gpmp_tpu_torch.misc  # noqa: F401
import gpmp_tpu_torch.num as gnp


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)


def main(show=False, ni=10, n_steps_total=3000, burnin=1200, num_samples=400,
         num_warmup=300, seed=0):
    box = [[-1], [1]]
    xi = gp.misc.designs.ldrandunif(1, ni, box, seed=seed)
    zi = gp.misc.testfunctions.twobumps(xi)

    model = gp.Model(constant_mean, kernel)
    model, info = gp.kernel.select_parameters_with_remap(model, xi, zi,
                                                         info=True)
    map_p = np.asarray(info["covparam"])
    print("MAP covparam:", np.round(map_p, 3))

    samples_mh, mh = gp.mcmc.sample_from_selection_criterion_mh(
        info=info,
        n_steps_total=n_steps_total,
        burnin_period=burnin,
        n_chains=2,
        silent=True,
        plot_chains=show,
        plot_empirical_distributions=show,
        seed=seed,
    )
    s_mh = gnp.to_np(samples_mh).reshape(-1, map_p.shape[0])
    print("MH posterior mean:", np.round(s_mh.mean(axis=0), 3))

    samples_nuts, info_nuts = gp.mcmc.sample_from_selection_criterion_nuts(
        info=info,
        num_samples=num_samples,
        num_warmup=num_warmup,
        n_chains=2,
        seed=seed,
        progress=False,
        verbose=0,
        plot_diagnostics=show,
    )
    s_nuts = gnp.to_np(samples_nuts).reshape(-1, map_p.shape[0])
    print("NUTS posterior mean:", np.round(s_nuts.mean(axis=0), 3))
    print("NUTS divergence rate:", float(info_nuts["divergent"].mean()))

    if show:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(s_mh[:, 0], s_mh[:, 1], ".", alpha=0.2, label="MH")
        plt.plot(s_nuts[:, 0], s_nuts[:, 1], ".", alpha=0.2, label="NUTS")
        plt.plot(map_p[0], map_p[1], "r*", markersize=12, label="MAP")
        plt.xlabel("log sigma2")
        plt.ylabel("log 1/rho")
        plt.legend()
        plt.title("Posterior of covariance parameters")
        plt.show()
    return s_mh, s_nuts


if __name__ == "__main__":
    main(show=True)
