"""Seconds of the regression's prediction a fit (``models/gpr.py``: the conditional
mean and the diagonal predictive variance at every row): the synced span around
``fit.drivers._gpr_tail``, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("gpr_predict")
