# gpmp_tpu_torch/misc/dataframe.py
"""Tiny labeled table for reports (host-side NumPy).

Counterpart of gpmp_tpu/misc/dataframe.py (API parity with
gpmp/misc/dataframe.py:15-123).
"""

import math

import numpy as np

import gpmp_tpu_torch.num as gnp


def ftos(x, fp=3):
    """Compact float-to-string formatter used by report tables."""
    if gnp.isarray(x):
        x = gnp.to_scalar(x)
    if x == float("inf"):
        return "+Inf"
    if x == float("-inf"):
        return "-Inf"
    if isinstance(x, float) and math.isnan(x):
        return "NaN"
    if x == 0:
        return "0.0"
    abs_x = abs(x)
    if 0.1 <= abs_x < 1000:
        return f"{x:.{fp}f}"
    if 0.01 <= abs_x < 0.1:
        return f"{x:.{fp + 1}f}"
    exponent = int(math.floor(math.log10(abs_x)))
    coeff = x / 10**exponent
    return f"{coeff:.{fp}f}e{exponent}"


class DataFrame:
    """Labeled 2-D table with row/column name indexing and aligned printing."""

    def __init__(self, data, colnames, rownames):
        self.data = np.array(data)
        self.rownames = list(rownames)
        self.colnames = list(colnames)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            row_key, col_key = key
            if isinstance(row_key, slice) and isinstance(col_key, slice):
                return DataFrame(
                    self.data[row_key, col_key],
                    self.colnames[col_key],
                    self.rownames[row_key],
                )
            if isinstance(row_key, slice):
                j = self.colnames.index(col_key)
                return DataFrame(self.data[row_key, j], [col_key],
                                 self.rownames[row_key])
            if isinstance(col_key, slice):
                i = self.rownames.index(row_key)
                return DataFrame(self.data[i, col_key],
                                 self.colnames[col_key], [row_key])
            return self.data[self.rownames.index(row_key),
                             self.colnames.index(col_key)]
        if isinstance(key, str):
            if key in self.rownames:
                return DataFrame(self.data[self.rownames.index(key), :],
                                 self.colnames, [key])
            if key in self.colnames:
                return DataFrame(self.data[:, self.colnames.index(key)],
                                 [key], self.rownames)
            raise KeyError(f"Key '{key}' not found in row or column names")
        raise TypeError("Invalid key type. Must be a tuple or a string.")

    def __setitem__(self, key, value):
        if isinstance(key, tuple):
            row_key, col_key = key
            ri = row_key if isinstance(row_key, slice) else self.rownames.index(row_key)
            ci = col_key if isinstance(col_key, slice) else self.colnames.index(col_key)
            self.data[ri, ci] = value
            return
        if isinstance(key, str):
            if key in self.rownames:
                self.data[self.rownames.index(key), :] = value
                return
            if key in self.colnames:
                self.data[:, self.colnames.index(key)] = value
                return
            raise KeyError(f"Key '{key}' not found in row or column names")
        raise TypeError("Invalid key type. Must be a tuple or a string.")

    def __repr__(self):
        data = np.atleast_2d(self.data)
        header = [[""] + self.colnames]
        rows = header + [
            [self.rownames[i] + ":"]
            + [ftos(data[i, j]) for j in range(data.shape[1])]
            for i in range(data.shape[0])
        ]
        min_width = 8
        col_widths = [
            max(min_width, max(len(str(rows[i][j])) for i in range(len(rows))))
            for j in range(len(rows[0]))
        ]
        formatted = [
            " ".join(str(rows[i][j]).rjust(col_widths[j]) for j in range(len(rows[0])))
            for i in range(len(rows))
        ]
        return "\n".join(formatted)

    def append_row(self, row_data, row_name):
        self.data = np.vstack([self.data, row_data])
        self.rownames.append(row_name)

    def append_col(self, col_data, col_name):
        self.data = np.hstack([self.data, np.atleast_2d(col_data).T])
        self.colnames.append(col_name)

    def concat(self, other, axis=0):
        if axis == 0:
            if self.colnames != other.colnames:
                raise ValueError(
                    "DataFrames must have the same column names to concatenate "
                    "vertically"
                )
            return DataFrame(
                np.concatenate([self.data, other.data], axis=0),
                self.colnames,
                self.rownames + other.rownames,
            )
        if axis == 1:
            if self.rownames != other.rownames:
                raise ValueError(
                    "DataFrames must have the same row names to concatenate "
                    "horizontally"
                )
            return DataFrame(
                np.concatenate([self.data, other.data], axis=1),
                self.colnames + other.colnames,
                self.rownames,
            )
        raise ValueError("Axis must be 0 or 1")
