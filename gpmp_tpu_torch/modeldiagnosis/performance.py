# gpmp_tpu_torch/modeldiagnosis/performance.py
"""Predictive-performance metrics for GP models.

One metric engine serves both evaluation modes:

* leave-one-out ("loo_*" keys): squared-error sum is PRESS, skill score
  is Q2 = 1 - PRESS/TSS;
* held-out test set ("test_*" keys): squared-error sum is RSS, skill
  score is R2 = 1 - RSS/TSS.

TSS is the total sum of squares of the targets around their mean; RMSE
and RMSE/std(z) normalize the error energy.  PIT values (probability
integral transform through the Gaussian predictive cdf) are optional.

Behavioral parity surface: gpmp/modeldiagnosis/performance.py
(compute_performance key set and perf table layout).
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np

import gpmp_tpu_torch.num as gnp
from gpmp_tpu_torch.misc.dataframe import DataFrame


def _flat(x):
    return gnp.asarray(x).reshape(-1)


def _skill_metrics(targets, errors):
    """Shared metric block from a 1-D target vector and error vector.

    Returns (n, metrics) where metrics maps neutral names (std, tss,
    sse, sse_over_tss, log10_sse_over_tss, rmse, rmse_over_std, skill)
    to scalars; the caller renames them for its section.
    """
    n = int(targets.shape[0])
    tss = gnp.norm(targets - gnp.mean(targets), ord=2) ** 2
    sse = gnp.norm(errors, ord=2) ** 2
    ratio = sse / tss
    rmse = gnp.sqrt(sse / float(max(n, 1)))
    std = gnp.std(targets)
    return n, {
        "std": std,
        "tss": tss,
        "sse": sse,
        "sse_over_tss": ratio,
        "log10_sse_over_tss": gnp.log10(ratio),
        "rmse": rmse,
        "rmse_over_std": rmse / std,
        "skill": 1 - sse / tss,
    }


def _gaussian_pit(observed, mean, variance):
    """PIT values through the Gaussian predictive cdf (variance clipped >= 0)."""
    spread = gnp.sqrt(gnp.clip(gnp.asarray(variance), 0.0, gnp.inf))
    return gnp.normal.cdf(observed, loc=mean, scale=spread)


# Section-specific key spellings: neutral metric name -> published key.
_LOO_KEYS = {
    "sse": "loo_press",
    "sse_over_tss": "loo_press_over_tss",
    "log10_sse_over_tss": "loo_log10_press_over_tss",
    "skill": "loo_Q2",
}
_TEST_KEYS = {
    "sse": "test_rss",
    "sse_over_tss": "test_rss_over_tss",
    "log10_sse_over_tss": "test_log10_rss_over_tss",
    "skill": "test_R2",
}


def _publish(out, prefix, keymap, n, metrics):
    out[f"{prefix}_n"] = n
    for name, value in metrics.items():
        out[keymap.get(name, f"{prefix}_{name}")] = value


def compute_performance(
    model: Any,
    xi: Any,
    zi: Any,
    loo: bool = True,
    loo_res: Optional[Tuple[Any, Any, Any]] = None,
    xtzt: Optional[Tuple[Any, Any]] = None,
    zpmzpv: Optional[Tuple[Any, Any]] = None,
    compute_pit: bool = False,
) -> Dict[str, Any]:
    """LOO and optional test-set performance metrics as a dict.

    ``loo_res`` / ``zpmzpv`` accept precomputed ``model.loo`` /
    ``model.predict`` outputs to avoid recomputation.
    """
    xi = gnp.asarray(xi)
    zi_arr = gnp.asarray(zi)

    out: Dict[str, Any] = {}

    if loo:
        zloom, zloov, eloo = (
            model.loo(xi, zi_arr) if loo_res is None else loo_res
        )
        n, metrics = _skill_metrics(_flat(zi_arr), _flat(eloo))
        _publish(out, "loo", _LOO_KEYS, n, metrics)
        if compute_pit:
            out["loo_pit"] = _gaussian_pit(zi_arr, zloom, zloov)

    if xtzt is not None:
        xt, zt = xtzt
        zt_arr = gnp.asarray(zt)
        zpm, zpv = (
            model.predict(gnp.asarray(xi), zi_arr, gnp.asarray(xt))
            if zpmzpv is None
            else (gnp.asarray(zpmzpv[0]), gnp.asarray(zpmzpv[1]))
        )
        n, metrics = _skill_metrics(_flat(zt_arr), _flat(zt_arr) - _flat(zpm))
        _publish(out, "test", _TEST_KEYS, n, metrics)
        if compute_pit:
            out["test_pit"] = _gaussian_pit(zt_arr, zpm, zpv)

    return out


# ---------------------------------------------------------------------
# pretty-printing
# ---------------------------------------------------------------------

# (row label, neutral metric name) in display order
_TABLE_ROWS = (
    ("std(z)", "std"),
    ("tss", "tss"),
    (None, "sse"),  # label depends on the section (press / rss)
    (None, "sse_over_tss"),
    (None, "log10_sse_over_tss"),
    ("rmse", "rmse"),
    ("rmse/std(z)", "rmse_over_std"),
    (None, "skill"),
)


def _print_section(title, prefix, keymap, results):
    labels, values = [], []
    for label, name in _TABLE_ROWS:
        key = keymap.get(name, f"{prefix}_{name}")
        if label is None:
            # derive the label from the published key, e.g. test_rss_over_tss
            # -> rss/tss, loo_log10_press_over_tss -> log10(press/tss)
            stem = key[len(prefix) + 1 :]
            if stem.startswith("log10_"):
                a, _, b = stem[len("log10_") :].partition("_over_")
                label = f"log10({a}/{b})"
            elif "_over_" in stem:
                a, _, b = stem.partition("_over_")
                label = f"{a}/{b}"
            else:
                label = stem
        labels.append(label)
        values.append(float(gnp.to_np(gnp.asarray(results[key]))))
    table = DataFrame(
        np.asarray(values, dtype=float).reshape(-1, 1), ["value"], labels
    )
    print(f"{title} (n={int(results[prefix + '_n']):d})")
    print(table)


def perf(
    model: Any,
    xi: Any,
    zi: Any,
    loo: bool = True,
    loo_res: Optional[Tuple[Any, Any, Any]] = None,
    xtzt: Optional[Tuple[Any, Any]] = None,
    zpmzpv: Optional[Tuple[Any, Any]] = None,
) -> None:
    """Print :func:`compute_performance` results as aligned tables (no PIT)."""
    results = compute_performance(
        model, xi, zi,
        loo=loo, loo_res=loo_res, xtzt=xtzt, zpmzpv=zpmzpv,
        compute_pit=False,
    )
    print("[Prediction performances]")
    if loo and "loo_press" in results:
        _print_section("  LOO", "loo", _LOO_KEYS, results)
    if xtzt is not None and "test_rss" in results:
        _print_section("  Test", "test", _TEST_KEYS, results)


__all__ = ["compute_performance", "perf"]
