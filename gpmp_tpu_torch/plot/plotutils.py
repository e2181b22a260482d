# gpmp_tpu_torch/plot/plotutils.py
"""Host-side plotting: Figure wrapper, GP credible bands, slice plots, LOO.

API parity surface (reference gpmp/plot/plotutils.py:20-420): ``Figure`` with
its plotting methods, ``plotgp`` credible-interval bands, ``crosssections``
1-D slices through a d-dimensional predictor, and ``plot_loo``.  Everything
here is pure matplotlib on NumPy arrays — device arrays are pulled to host
once at the boundary.  The Agg backend is forced in non-interactive sessions
so examples and CI run headless.
"""

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.stats

import matplotlib


def _running_in_repl() -> bool:
    """True when Python is interactive (a prompt exists or -i was passed)."""
    if getattr(sys, "ps1", None) is not None:
        return True
    return bool(sys.flags.interactive)


if not _running_in_repl():
    try:
        matplotlib.use("Agg", force=False)
    except Exception:
        pass

import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import interactive as _mpl_interactive  # noqa: E402

import gpmp_tpu_torch.num as gnp  # noqa: E402


def _host1d(x) -> np.ndarray:
    """Device/array-like -> flat float numpy vector on the host."""
    return np.asarray(gnp.to_np(x)).reshape(-1)


# ---------------------------------------------------------------------------
# Figure
# ---------------------------------------------------------------------------


class Figure:
    """Thin matplotlib wrapper: subplot grid, spine box-off, GP band plots.

    All draw methods target ``self.ax``, the currently selected subplot
    (changed with :meth:`subplot`, 1-based like matplotlib).
    """

    def __init__(self, nrows=1, ncols=1, isinteractive=True, boxoff=True, **kargs):
        self.interpreter = _running_in_repl()
        if isinteractive and self.interpreter:
            _mpl_interactive(True)

        self.boxoff = boxoff
        self.nrows, self.ncols = nrows, ncols
        self.fig = plt.figure(**kargs)
        self.axes = [
            self.fig.add_subplot(nrows, ncols, k) for k in range(1, nrows * ncols + 1)
        ]
        self.ax = self.axes[0]
        if boxoff:
            self.set_boxoff()

    def set_boxoff(self):
        """Hide the top/right spines of the current axes; ticks point in."""
        for spine in ("right", "top"):
            self.ax.spines[spine].set_visible(False)
        self.ax.tick_params(direction="in")

    def subplot(self, i):
        """Select subplot ``i`` (1-based) as the draw target."""
        self.ax = self.axes[i - 1]
        if self.boxoff:
            self.set_boxoff()

    def show(self, grid=None, legend=None, legend_fontsize=None, xlim=None):
        if grid:
            self.grid()
        if legend:
            kw = {} if legend_fontsize is None else {"fontsize": legend_fontsize}
            self.legend(**kw)
        if xlim is not None:
            self.xlim(xlim)
        plt.show()

    def plot(self, x, z, *args, **kargs):
        self.ax.plot(np.asarray(x), np.asarray(z), *args, **kargs)

    def plotdata(self, x, z, label="data"):
        """Observations as open red squares."""
        self.ax.plot(np.asarray(x), np.asarray(z), "rs", markersize=6,
                     markerfacecolor="none", label=label)

    def xlabel(self, s):
        self.ax.set_xlabel(s)

    def ylabel(self, s):
        self.ax.set_ylabel(s)

    def xylabels(self, sx="", sy=""):
        self.xlabel(sx)
        self.ylabel(sy)

    def title(self, s):
        self.ax.set_title(s)

    def legend(self, **kwargs):
        self.ax.legend(**kwargs)

    def grid(self, visible=True, which="major", linestyle=(0, (1, 5)),
             linewidth=0.5, **kwargs):
        self.ax.grid(visible, which, linestyle=linestyle, linewidth=linewidth,
                     **kwargs)

    def xlim(self, new_limits=None):
        if new_limits is None:
            return self.ax.get_xlim()
        self.ax.set_xlim(new_limits)
        return new_limits

    def ylim(self, new_limits=None):
        if new_limits is None:
            return self.ax.get_ylim()
        self.ax.set_ylim(new_limits)
        return new_limits

    def axhline(self, y, **kwargs):
        self.ax.axhline(y, **kwargs)

    def axvline(self, x, **kwargs):
        self.ax.axvline(x, **kwargs)

    def plotgp(self, x, mean, variance, colorscheme="default", rgb_hue=None,
               ax=None, fignum=None, mean_label="posterior mean",
               show_mean_label=True, ci=(0.95, 0.99, 0.999),
               ci_labels=("CI 95%", "CI 99%", "CI 99.9%"),
               show_ci_labels=True, **kwargs):
        """Posterior mean curve with nested Gaussian credible bands.

        colorscheme:
          - ``'default'``: three nested gray bands, red mean;
          - ``'simple'``: one gray band, red mean;
          - ``'bw'``: one white band with dashed black edges, black mean;
          - ``'hue'``: one band in the color given by ``rgb_hue`` (3 ints).
        """
        del ax, fignum  # accepted for API parity; draws on self.ax
        x = _host1d(x)
        mean = _host1d(mean)
        sd = np.sqrt(_host1d(variance))

        # z-scores of the two-sided coverage levels, e.g. 0.95 -> 1.96
        zs = [scipy.stats.norm.ppf(0.5 * (1.0 + lv)) for lv in ci]
        labels = list(ci_labels) if show_ci_labels else ["", "", ""]

        style = self._band_style(colorscheme, rgb_hue)
        if not style.nested:
            zs, labels = zs[:1], labels[:1]
        else:
            # draw widest band first so narrower ones sit on top
            zs, labels = zs[::-1], labels[::-1]
        if style.band_linewidth is not None:
            kwargs.setdefault("linewidth", style.band_linewidth)
        kwargs["alpha"] = style.alpha

        self.ax.plot(x, mean, style.mean_color, linewidth=2.0,
                     label=mean_label if show_mean_label else "")

        ring = np.concatenate([x, x[::-1]])
        for z, fill, lab in zip(zs, style.fills, labels):
            hi, lo = mean + z * sd, mean - z * sd
            self.ax.fill(ring, np.concatenate([hi, lo[::-1]]), color=fill,
                         label=lab, **kwargs)
            if style.dashed_edges:
                for edge in (hi, lo):
                    self.ax.plot(x, edge, color="#000000", linestyle="dashed",
                                 dashes=(10, 8), linewidth=0.5)

    @staticmethod
    def _band_style(colorscheme: str, rgb_hue) -> "_BandStyle":
        if colorscheme == "hue":
            hexcol = "#%02x%02x%02x" % tuple(rgb_hue)
            return _BandStyle(mean_color=hexcol, fills=[hexcol], alpha=0.5,
                              nested=False, band_linewidth=0.5)
        if colorscheme == "bw":
            return _BandStyle(mean_color="#000000", fills=["#F2F2F2"], alpha=0.0,
                              nested=False, dashed_edges=True)
        if colorscheme == "simple":
            return _BandStyle(mean_color="#F2404C", fills=["#BFBFBF"], alpha=0.8,
                              nested=False, band_linewidth=0.5)
        # 'default': widest-to-narrowest fill colors, light to dark
        return _BandStyle(mean_color="#F2404C",
                          fills=["#F2F2F2", "#D8D8D8", "#BFBFBF"], alpha=0.8,
                          nested=True, band_linewidth=0.5)


@dataclass
class _BandStyle:
    mean_color: str
    fills: List[str]
    alpha: float
    nested: bool
    dashed_edges: bool = False
    band_linewidth: Optional[float] = None


# ---------------------------------------------------------------------------
# Cross-sections
# ---------------------------------------------------------------------------


def _as_index_list(spec, n: int, values: np.ndarray) -> List[int]:
    """Normalize an anchor spec (None/'min'/'max'/int/sequence) to indices."""
    if spec is None or spec == "min":
        idx = [int(np.nanargmin(values))]
    elif spec == "max":
        idx = [int(np.nanargmax(values))]
    elif isinstance(spec, str):
        raise ValueError("ind_i must be None, 'min', 'max', an int, or a sequence.")
    elif np.isscalar(spec):
        idx = [int(spec)]
    else:
        idx = [int(k) for k in spec]
    for k in idx:
        if not 0 <= k < n:
            raise IndexError("ind_i contains an out-of-bounds observation index.")
    return idx


def _as_dim_list(spec, d: int) -> List[int]:
    if spec is None:
        dims = list(range(d))
    elif np.isscalar(spec):
        dims = [int(spec)]
    else:
        dims = [int(k) for k in spec]
    for k in dims:
        if not 0 <= k < d:
            raise IndexError("ind_dim contains an out-of-bounds dimension index.")
    return dims


def _slice_through(anchor: np.ndarray, dim: int, lo: float, hi: float,
                   nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """Points varying coordinate ``dim`` of ``anchor`` over [lo, hi].

    The anchor's own coordinate is inserted into the grid so the slice
    passes exactly through the observation.  Returns (t, xt) with t sorted.
    """
    t = np.sort(np.append(np.linspace(lo, hi, nt - 1), anchor[dim]))
    xt = np.broadcast_to(anchor, (nt, anchor.size)).copy()
    xt[:, dim] = t
    return t, xt


def crosssections(model, xi, zi, box, ind_i=None, ind_dim=None, nt=100,
                  show_data=True, figsize=None):
    """1-D posterior slices: vary one coordinate of an anchor observation
    across its box range and plot mean + credible bands along the slice.

    Grid: one row per dimension in ``ind_dim``, one column per anchor in
    ``ind_i`` ('min'/'max' pick the arg-extremum observation).
    """
    xi_np = np.asarray(gnp.to_np(gnp.asarray(xi)))
    zi_np = np.asarray(gnp.to_np(gnp.asarray(zi)))
    box = np.asarray(box, dtype=float)
    nt = int(nt)

    if xi_np.ndim != 2:
        raise ValueError("xi must have shape (n, d).")
    n, d = xi_np.shape
    if box.shape != (2, d):
        raise ValueError("box must have shape (2, d).")
    if zi_np.shape[0] != n or zi_np.size != n:
        raise ValueError("zi must be scalar-valued with shape (n,) or (n, 1).")
    if nt < 2:
        raise ValueError("nt must be >= 2.")
    z_vec = zi_np.reshape(-1)

    anchors = _as_index_list(ind_i, n, z_vec)
    dims = _as_dim_list(ind_dim, d)

    ncols, nrows = len(anchors), len(dims)
    fig = Figure(nrows, ncols,
                 figsize=figsize or (4.8 * ncols, 2.4 * nrows))

    for col, a in enumerate(anchors):
        for row, dim in enumerate(dims):
            t, xt = _slice_through(xi_np[a], dim, box[0, dim], box[1, dim], nt)
            pm, pv = model.predict(xi, zi, gnp.asarray(xt))
            pm = _host1d(pm)
            pv = np.clip(_host1d(pv), 0.0, None)

            fig.subplot(ncols * row + col + 1)
            lead = col == 0 and row == 0  # legend entries only once
            fig.plotgp(t, pm, pv, show_mean_label=lead, show_ci_labels=lead)
            if show_data:
                fig.ax.plot(xi_np[:, dim], z_vec, "ko", alpha=0.25, markersize=3,
                            label="projected observations" if lead else None)
                fig.ax.plot(xi_np[a, dim], z_vec[a], "ro", markersize=5,
                            label="anchor" if lead else None)
            fig.ax.axvline(xi_np[a, dim], color="k", linestyle=":", linewidth=1)
            fig.grid()
            fig.ax.set_xlabel(rf"$x_{dim:d}$")
            if col == 0:
                fig.ax.set_ylabel(rf"$z$ along $x_{dim:d}$")
            if row == 0:
                fig.ax.set_title(f"cross section {col + 1:d}")
            if lead and show_data:
                fig.ax.legend(fontsize=8)

    fig.fig.tight_layout()
    return fig


def plot_loo(zi, zloom, zloov):
    """Leave-one-out predicted-vs-observed scatter with 95% error bars and
    the y = x diagonal."""
    zi, zloom, zloov = (np.asarray(gnp.to_np(v)) for v in (zi, zloom, zloov))
    fig = Figure()
    fig.ax.errorbar(zi, zloom, 1.96 * np.sqrt(zloov), fmt="ko", ls="None")
    fig.xylabels("true values", "predicted")
    fig.title("LOO predictions with 95% coverage intervals")
    span = (min(*fig.xlim(), *fig.ylim()), max(*fig.xlim(), *fig.ylim()))
    fig.ax.plot(span, span, "--")
    fig.grid()
    fig.show()
