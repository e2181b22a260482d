# gpmp_tpu_torch/parameter/param.py
"""Structured parameter objects (naming / normalization / display).

Counterpart of gpmp_tpu/parameter/param.py (API parity with
gpmp/parameter/param.py:34-383).  These are host-side introspection
objects (the core/kernel layers operate on tensors); values are stored as
a mutable NumPy vector.
"""

from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from gpmp_tpu_torch.misc.dataframe import ftos


class Normalization(Enum):
    LOG = "log"
    LOG_INV = "log_inv"
    NONE = "none"


# internal-scale transform and its inverse, keyed by normalization
_FWD = {
    Normalization.LOG: np.log,
    Normalization.LOG_INV: lambda v: -np.log(v),
    Normalization.NONE: lambda v: v,
}
_INV = {
    Normalization.LOG: np.exp,
    Normalization.LOG_INV: lambda v: np.exp(-v),
    Normalization.NONE: lambda v: v,
}


def _parse_one(norm) -> Normalization:
    if isinstance(norm, Normalization):
        return norm
    if isinstance(norm, str):
        try:
            return Normalization(norm.lower())
        except ValueError:
            raise ValueError(f"Unknown normalization: {norm}") from None
    raise TypeError("Normalization must be a str or Normalization enum.")


def _match_indices(paths, query, prefix_match):
    """Positions whose path equals `query` (or starts with it)."""
    if prefix_match:
        k = len(query)
        return [i for i, p in enumerate(paths) if p[:k] == query]
    return [i for i, p in enumerate(paths) if p == query]


class Param:
    """Named, normalized parameter vector with hierarchical paths.

    Each entry has a name, a path (list of strings), a normalization
    (LOG / LOG_INV / NONE), and optional informative bounds.
    """

    def __init__(self, values=None, paths=None, normalizations=None, names=None,
                 bounds=None, name_prefix="param_", dim=None):
        if values is None:
            self._values = np.zeros(dim or 0)
        else:
            self._values = np.asarray(values, dtype=float).reshape(-1).copy()
        k = self._values.size
        self.dim = k
        # per-entry metadata: plain mutable lists (report.py and user
        # code assign into them in place)
        self.paths: List[List[str]] = (
            [["param"] for _ in range(k)] if paths is None else paths
        )
        if names is None:
            names = [name_prefix + str(i) for i in range(k)]
        self.names: List[str] = names
        if normalizations is None:
            self.normalizations = [Normalization.NONE for _ in range(k)]
        else:
            self.normalizations = [_parse_one(x) for x in normalizations]
        self.bounds: List[Optional[Tuple[float, float]]] = (
            [None] * k if bounds is None else bounds
        )
        self._check_consistency()

    def _check_consistency(self):
        lengths = {
            len(self.paths), len(self.names),
            len(self.normalizations), len(self.bounds), self.dim,
        }
        if len(lengths) != 1:
            raise ValueError(
                "All parameter fields must have the same length as the "
                "number of parameters."
            )

    # -------------------------------------------------------------- values
    @property
    def values(self) -> np.ndarray:
        return self._values

    @values.setter
    def values(self, new_values):
        self._values = np.asarray(new_values, dtype=float).reshape(-1).copy()
        self.dim = self._values.size

    @staticmethod
    def _normalize(value, normalization):
        return _FWD[normalization](value)

    @staticmethod
    def _denormalize(value, normalization):
        return _INV[normalization](value)

    @property
    def denormalized_values(self) -> np.ndarray:
        out = np.empty(self.dim)
        for i, norm in enumerate(self.normalizations):
            out[i] = _INV[norm](self._values[i])
        return out

    @denormalized_values.setter
    def denormalized_values(self, new_values):
        new_values = np.asarray(new_values, dtype=float)
        if new_values.size != self.dim:
            raise ValueError("Mismatch in size for denormalized values.")
        self._values = np.array(
            [_FWD[norm](v) for norm, v in zip(self.normalizations, new_values)]
        )

    # ------------------------------------------------------------ accessors
    def get_paths(self, prefix=None):
        """All unique paths, or those matching a prefix."""
        if prefix is None:
            return list({tuple(p) for p in self.paths})
        return [self.paths[i]
                for i in _match_indices(self.paths, prefix, True)]

    def indices_by_path_prefix(self, prefix):
        return _match_indices(self.paths, prefix, True)

    def names_by_path_prefix(self, prefix):
        return [self.names[i] for i in _match_indices(self.paths, prefix, True)]

    def select_by_path_prefix(self, prefix, return_view=False):
        return self.get_by_path(prefix, prefix_match=True, return_view=return_view)

    def get_by_name(self, name, return_view=False):
        i = self.names.index(name)
        if return_view:
            return self._values[i : i + 1]
        return self._values[i]

    def set_by_name(self, name, new_value):
        self._values[self.names.index(name)] = new_value

    def get_by_path(self, path, prefix_match=False, return_view=False):
        idx = np.asarray(_match_indices(self.paths, path, prefix_match),
                         dtype=int)
        if not return_view:
            return self._values[idx].copy()
        if idx.size and not np.array_equal(
            idx, np.arange(idx[0], idx[0] + idx.size)
        ):
            raise ValueError(
                "Requested path does not map to a contiguous block -- "
                "cannot return view."
            )
        return self._values[idx[0] : idx[-1] + 1]

    def set_by_path(self, path, new_values, prefix_match=False):
        idx = _match_indices(self.paths, path, prefix_match)
        if len(idx) != len(new_values):
            raise ValueError(
                f"Expected {len(idx)} values, got {len(new_values)}."
            )
        self._values[np.asarray(idx, dtype=int)] = np.asarray(
            new_values, dtype=float
        )

    def set_from_unnormalized(self, **kwargs):
        for name, val in kwargs.items():
            i = self.names.index(name)
            self._values[i] = _FWD[self.normalizations[i]](val)

    def check_bounds(self):
        """Per-entry bound satisfaction on denormalized values."""
        dv = self.denormalized_values
        out = []
        for i, b in enumerate(self.bounds):
            out.append(True if b is None else bool(b[0] <= dv[i] <= b[1]))
        return out

    # ------------------------------------------------------------- algebra
    def __getitem__(self, index):
        if isinstance(index, slice):
            index = range(self.dim)[index]
        elif isinstance(index, int):
            index = (index,)
        pick = lambda field: [field[i] for i in index]
        return Param(
            values=self._values[list(index)],
            paths=pick(self.paths),
            normalizations=pick(self.normalizations),
            names=pick(self.names),
            bounds=pick(self.bounds),
        )

    def __add__(self, other):
        return Param.concat(self, other)

    @staticmethod
    def concat(*params):
        def chained(field):
            out = []
            for p in params:
                out.extend(getattr(p, field))
            return out

        return Param(
            np.concatenate([p.values for p in params]),
            chained("paths"),
            chained("normalizations"),
            chained("names"),
            chained("bounds"),
        )

    # ------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        dv = self.denormalized_values
        out = {}
        for i, name in enumerate(self.names):
            out[name] = {
                "value": self._values[i],
                "path": self.paths[i],
                "normalization": self.normalizations[i].value,
                "denormalized": dv[i],
                "bounds": self.bounds[i],
            }
        return out

    def to_simple_dict(self) -> dict:
        return dict(zip(self.names, self.denormalized_values))

    def __repr__(self) -> str:
        header = ("Name:", "Path", "Norm", "Bounds", "Value", "Denorm")
        dv = self.denormalized_values
        rows = []
        for i in range(self.dim):
            b = self.bounds[i]
            rows.append((
                self.names[i] + ":",
                "->".join(self.paths[i]),
                self.normalizations[i].value,
                "(-inf, inf)" if b is None
                else f"[{b[0]:.4g}, {b[1]:.4g}]",
                ftos(self._values[i]),
                ftos(dv[i]),
            ))
        widths = [
            max(len(h), *(len(r[j]) for r in rows)) if rows else len(h)
            for j, h in enumerate(header)
        ]

        def fmt(row):
            return "    ".join(c.rjust(w) for c, w in zip(row, widths))

        return "\n".join([fmt(header)] + [fmt(r) for r in rows])


def _aniso_fields(d, name_prefix, head_names, head_norms, head_bounds,
                  loginvrho_bounds):
    """names/paths/normalizations/bounds for [head..., rho_0..rho_{d-1}]
    anisotropic layouts (head = variance-like log-scale entries)."""
    names = [name_prefix + nm for nm in head_names]
    names += [f"{name_prefix}rho_{i}" for i in range(d)]
    paths = [["covparam", "variance"]] * len(head_names)
    paths += [["covparam", "lengthscale"]] * d
    norms = list(head_norms) + [Normalization.LOG_INV] * d
    bnds = list(head_bounds) + [loginvrho_bounds] * d
    return dict(names=names, paths=paths, normalizations=norms, bounds=bnds)


def make_anisotropic_param(d=None, values=None, logsigma2_bounds=None,
                           loginvrho_bounds=None, name_prefix=""):
    """Param for anisotropic covariance [sigma2, rho_0, ..., rho_{d-1}]
    with [log, log_inv, ...] normalization."""
    if values is not None:
        values = np.asarray(values, dtype=float)
        d = values.size - 1
    elif d is not None:
        values = np.concatenate([[0.0], np.full(d, -1.0)])
    else:
        raise ValueError("Must provide either `values` or `d`.")
    fields = _aniso_fields(d, name_prefix, ["sigma2"], [Normalization.LOG],
                           [logsigma2_bounds], loginvrho_bounds)
    return Param(values=values, **fields)


def param_from_covparam_anisotropic(covparam, logsigma2_bounds=None,
                                    loginvrho_bounds=None, name_prefix=""):
    """Param view of a plain covparam = [log sigma2, loginvrho...] vector."""
    covparam = np.asarray(covparam, dtype=float)
    fields = _aniso_fields(covparam.size - 1, name_prefix, ["sigma2"],
                           [Normalization.LOG], [logsigma2_bounds],
                           loginvrho_bounds)
    return Param(values=covparam, **fields)


def param_from_covparam_anisotropic_noisy(covparam, logsigma2_bounds=None,
                                          logsigma2_noise_bounds=None,
                                          loginvrho_bounds=None, name_prefix=""):
    """Param view for noisy models: [sigma2, sigma2_noise, rho...]."""
    covparam = np.asarray(covparam, dtype=float)
    fields = _aniso_fields(covparam.size - 2, name_prefix,
                           ["sigma2", "sigma2_noise"],
                           [Normalization.LOG, Normalization.LOG],
                           [logsigma2_bounds, logsigma2_noise_bounds],
                           loginvrho_bounds)
    return Param(values=covparam, **fields)
