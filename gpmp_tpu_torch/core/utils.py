# gpmp_tpu_torch/core/utils.py
"""Shape/type validation helpers (counterpart of gpmp_tpu/core/utils.py)."""

import gpmp_tpu_torch.num as gnp


def ensure_shapes_and_type(*, xi=None, zi=None, xt=None, convert=True):
    """Validate shapes of (xi, zi, xt) and optionally convert to tensors.

    - xi, xt must be 2-D; zi 1-D or single-column 2-D (reshaped to 1-D);
    - row/column consistency is asserted.
    """
    if xi is not None:
        assert len(xi.shape) == 2, "xi should be a 2D array"

    if zi is not None:
        if len(zi.shape) == 2:
            assert zi.shape[1] == 1, "zi should only have one column if it's a 2D array"
            zi = zi.reshape(-1)
        else:
            assert len(zi.shape) == 1, "zi should be 1D or a 2D column array"

    if xt is not None:
        assert len(xt.shape) == 2, "xt should be a 2D array"

    if xi is not None and zi is not None:
        assert xi.shape[0] == zi.shape[0], "xi and zi must have the same number of rows"
    if xi is not None and xt is not None:
        assert (
            xi.shape[1] == xt.shape[1]
        ), "xi and xt must have the same number of columns"

    if convert:
        if xi is not None:
            xi = gnp.asarray(xi)
        if zi is not None:
            zi = gnp.asarray(zi)
        if xt is not None:
            xt = gnp.asarray(xt)

    return xi, zi, xt


def meanparam_of(model):
    """The model's meanparam as a tensor (``gnp._tensor``), None kept: the
    attribute may hold a NumPy array or a Python scalar."""
    return None if model.meanparam is None else gnp._tensor(model.meanparam)


def validate_model_mean(meantype, mean, meanparam):
    """Validate the (meantype, mean, meanparam) combination at Model init."""
    if meantype not in {"zero", "parameterized", "linear_predictor"}:
        raise ValueError(
            "meantype must be one of 'zero', 'parameterized', or 'linear_predictor'"
        )
    if meantype == "zero" and mean is not None:
        raise ValueError("For meantype 'zero', mean must be None")
    if meantype in ["parameterized", "linear_predictor"] and not callable(mean):
        raise TypeError(
            "For meantype 'parameterized' or 'linear_predictor', "
            "mean must be a callable function"
        )
