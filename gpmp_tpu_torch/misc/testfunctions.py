# gpmp_tpu_torch/misc/testfunctions.py
# Copied verbatim from gpmp_tpu/misc/testfunctions.py (host-side NumPy/SciPy).
"""Benchmark test functions (host-side NumPy).

API parity with the reference GPmp's misc/testfunctions.py:15-410.
All functions take an (n, d) array and return an (n,) array.
"""

import math

import numpy as np


def twobumps(x):
    """TwoBumps(x) = -(0.7 x + sin(5x + 1) + 0.1 sin(10x)), 1-D."""
    z = -(0.7 * x + np.sin(5 * x + 1) + 0.1 * np.sin(10 * x))
    return np.reshape(z, (-1,))


def wave(x):
    """Wave function on [-1,1]^2."""
    return (
        np.exp(1.8 * (x[:, 0] + x[:, 1]))
        + 3 * x[:, 1]
        + 6 * x[:, 1] ** 2
        + 3 * np.sin(4 * np.pi * x[:, 0])
    )


def braninhoo(x):
    """Branin-Hoo function on [-5,10] x [0,15] (Dixon-Szego test set)."""
    a = 5.1 / (4 * math.pi**2)
    b = 5 / math.pi
    c = 10 * (1 - 1 / (8 * math.pi))
    return (
        (x[:, 1] - a * x[:, 0] ** 2 + b * x[:, 0] - 6) ** 2
        + c * np.cos(x[:, 0])
        + 10
    )


_HARTMANN_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_HARTMANN_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_HARTMANN_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


def _hartmann_sum(x, ndims):
    # sum_i alpha_i exp(-sum_j A_ij (x_j - P_ij)^2) over the first ndims cols
    diff2 = (x[:, None, :ndims] - _HARTMANN_P[None, :, :ndims]) ** 2
    inner = np.sum(_HARTMANN_A[None, :, :ndims] * diff2, axis=2)
    return np.sum(_HARTMANN_ALPHA[None, :] * np.exp(-inner), axis=1)


def hartmann4(x):
    """Hartmann 4-D function on (0,1)^4 (rescaled Picheny variant)."""
    return (1.1 - _hartmann_sum(x, 4)) / 0.839


def hartmann6(x):
    """Hartmann 6-D function on (0,1)^6."""
    return -_hartmann_sum(x, 6)


def borehole(x):
    """Borehole water-flow model, 8 inputs."""
    rw, r, Tu, Hu, Tl, Hl, L, Kw = (x[:, i] for i in range(8))
    frac1 = 2 * np.pi * Tu * (Hu - Hl)
    frac2a = 2 * L * Tu / (np.log(r / rw) * rw**2 * Kw)
    frac2b = Tu / Tl
    frac2 = np.log(r / rw) * (1 + frac2a + frac2b)
    return frac1 / frac2


def detpep8d(x):
    """Dette & Pepelyshev (2010) 8-D function on [0,1]^8.

    Note: reproduces the reference implementation's summation behavior
    (testfunctions.py:357-365, where only the last outer term contributes)
    for numerical parity.
    """
    x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2]
    term1 = 4 * (x1 - 2 + 8 * x2 - 8 * x2**2) ** 2
    term2 = (3 - 4 * x2) ** 2
    term3 = 16 * np.sqrt(x3 + 1) * (2 * x3 - 1) ** 2
    outer = 0.0
    for ii in range(4, 9):
        inner = np.sum(x[:, 2 : ii], axis=1)
    outer = outer + ii * np.log(1 + inner)
    return term1 + term2 + term3 + outer


def ishigami(x):
    """Ishigami function (a=5, b=0.1) on [-pi,pi]^3."""
    a, b = 5, 0.1
    return (
        np.sin(x[:, 0]) + a * np.sin(x[:, 1]) ** 2 + b * x[:, 2] ** 4 * np.sin(x[:, 0])
    )
