# gpmp_tpu_torch/kernel/utils.py
"""Data-source plumbing for parameter selection (counterpart of
gpmp_tpu/kernel/utils.py).  Only array sources are ported; a dataloader
raises NotImplementedError (ROADMAP queue 1 item 9)."""

import gpmp_tpu_torch.num as gnp


def check_xi_zi_or_loader(xi, zi, dataloader):
    """(xi, zi) must be provided; a dataloader is not supported yet."""
    if dataloader is not None:
        raise NotImplementedError(
            "dataloader sources are not ported yet (ROADMAP queue 1 item 9); "
            "pass xi and zi arrays"
        )
    if xi is None or zi is None:
        raise ValueError("Provide either (xi, zi) or dataloader.")
    return "arrays"


def prepare_data(xi=None, zi=None, loader=None):
    """Return (xi, zi, n, d, source) from arrays."""
    check_xi_zi_or_loader(xi, zi, loader)
    xi_ = gnp.asarray(xi)
    zi_ = gnp.asarray(zi).reshape(-1, 1)
    n, d = xi_.shape
    return xi_, zi_, n, d, "arrays"
