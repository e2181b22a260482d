"""n-D noisy regression with a custom noise kernel + low-level optimizer.

The gpmp_tpu_torch twin of examples/gpmp_tpu_example07_nd_regression.py (it runs on the
card unless the CPU is asked for: GPMP_DEVICE=cpu); mirror of gpmp's
examples/gpmp_example07_nd_regression.py: custom
kernel with covparam = [log sigma2, log noise_var, loginvrho...],
REML selection through the low-level autoselect_parameters routine,
diagnosis with the noisy Param layout.
"""

import numpy as np

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp


def choose_test_case(problem, seed=0):
    if problem == 1:
        name, f, dim = "Hartmann4", gp.misc.testfunctions.hartmann4, 4
        box = [[0.0] * 4, [1.0] * 4]
        ni, nt, noise_std = 80, 500, 0.2
    elif problem == 2:
        name, f, dim = "Hartmann6", gp.misc.testfunctions.hartmann6, 6
        box = [[0.0] * 6, [1.0] * 6]
        ni, nt, noise_std = 200, 500, 0.1
    elif problem == 4:
        name, f, dim = "detpep8d", gp.misc.testfunctions.detpep8d, 8
        box = [[0.0] * 8, [1.0] * 8]
        ni, nt, noise_std = 120, 500, 5.0
    else:
        raise ValueError("problem must be 1, 2 or 4")
    xi = gp.misc.designs.ldrandunif(dim, ni, box, seed=seed)
    xt = gp.misc.designs.ldrandunif(dim, nt, box, seed=seed + 1)
    return name, f, dim, box, ni, xi, nt, xt, noise_std


def constant_mean(x, _):
    return gnp.ones((x.shape[0], 1))


def kernel_ii_or_tt(x, param, pairwise=False):
    p = 2
    sigma2 = gnp.exp(param[0])
    noise_variance = gnp.exp(param[1])
    loginvrho = param[2:]
    if pairwise:
        return sigma2 * gnp.ones((x.shape[0],))
    K = gnp.scaled_distance(loginvrho, x, x)
    return sigma2 * gp.kernel.maternp_kernel(p, K) + noise_variance * gnp.eye(
        K.shape[0]
    )


def kernel_it(x, y, param, pairwise=False):
    p = 2
    sigma2 = gnp.exp(param[0])
    loginvrho = param[2:]
    if pairwise:
        K = gnp.scaled_distance_elementwise(loginvrho, x, y)
    else:
        K = gnp.scaled_distance(loginvrho, x, y)
    return sigma2 * gp.kernel.maternp_kernel(p, K)


def kernel(x, y, param, pairwise=False):
    if y is x or y is None:
        return kernel_ii_or_tt(x, param, pairwise)
    return kernel_it(x, y, param, pairwise)


def main(show=False, problem=1, seed=0):
    name, f, dim, box, ni, xi, nt, xt, noise_std = choose_test_case(problem, seed)
    rng = np.random.default_rng(seed)
    zi = np.asarray(f(xi)) + noise_std * rng.normal(size=ni)
    zt = np.asarray(f(xt))

    covparam0 = gnp.concatenate(
        (
            gnp.array([np.log(np.var(zi))]),
            gnp.array([2 * np.log(0.1) + np.log(np.var(zi))]),
            gnp.asarray(-np.log(np.std(xi, axis=0)).flatten()),
        )
    )
    model = gp.Model(constant_mean, kernel, None, covparam0)

    # low-level criterion + optimizer routine
    crit, crit_pre, crit_ng, grad = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi
    )
    covparam_reml, info = gp.kernel.autoselect_parameters(
        gnp.to_np(covparam0), crit_pre, grad, silent=True, info=True
    )

    model.covparam = gnp.asarray(covparam_reml)
    info["covparam0"] = gnp.to_np(covparam0)
    info["covparam"] = covparam_reml
    info["selection_criterion"] = crit
    info["selection_criterion_nograd"] = crit_ng

    gp.modeldiagnosis.diag(
        model, info, xi, zi, model_type="linear_mean_matern_anisotropic_noisy"
    )

    zpm, zpv = model.predict(xi, zi, xt)
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    print(f"{name}: test RMSE = {rmse:.4f} (noise_std = {noise_std})")

    if show:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(zt, zpm, "ko", markersize=3)
        lo, hi = min(zt.min(), zpm.min()), max(zt.max(), zpm.max())
        plt.plot([lo, hi], [lo, hi], "--")
        plt.title(name)
        plt.show()
    return model, info, rmse


if __name__ == "__main__":
    main(show=True, problem=4)
