"""1-D GP interpolation with REML covariance-parameter selection.

The gpmp_tpu_torch twin of examples/gpmp_tpu_example02_1d_interpolation.py (it runs on the
card unless the CPU is asked for: GPMP_DEVICE=cpu); mirror of gpmp's
examples/gpmp_example02_1d_interpolation.py:
twobumps data, constant mean (universal kriging), Matern p=3, REML fit,
prediction, diagnosis report.
"""

import gpmp_tpu_torch as gp
import gpmp_tpu_torch.num as gnp


def generate_data(seed=42):
    dim, nt, ni = 1, 200, 6
    box = [[-1], [1]]
    xt = gp.misc.designs.regulargrid(dim, nt, box)
    zt = gp.misc.testfunctions.twobumps(xt)
    xi = gp.misc.designs.ldrandunif(dim, ni, box, seed=seed)
    zi = gp.misc.testfunctions.twobumps(xi)
    return xt, zt, xi, zi


def constant_mean(x, param):
    return gnp.ones((x.shape[0], 1))


def kernel(x, y, covparam, pairwise=False):
    p = 3
    return gp.kernel.maternp_covariance(x, y, p, covparam, pairwise)


def main(show=False):
    xt, zt, xi, zi = generate_data()

    model = gp.Model(constant_mean, kernel)
    model, info = gp.kernel.select_parameters_with_reml(model, xi, zi, info=True)
    gp.modeldiagnosis.diag(model, info, xi, zi)

    zpm, zpv = model.predict(xi, zi, xt)

    if show:
        gp.modeldiagnosis.plot_selection_criterion_crosssections(
            info=info, delta=0.8, param_names=["sigma^2 (log)", "rho (log)"]
        )
        fig = gp.plot.Figure(isinteractive=True)
        fig.plot(xt, zt, "k", linewidth=1, linestyle=(0, (5, 5)))
        fig.plotdata(xi, zi)
        fig.plotgp(xt, zpm, zpv, colorscheme="simple")
        fig.xylabels("$x$", "$z$")
        fig.title("Posterior GP with parameters selected by ReML")
        fig.show(grid=True, xlim=[-1.0, 1.0], legend=True, legend_fontsize=9)
    return model, info, zpm, zpv


if __name__ == "__main__":
    main(show=True)
