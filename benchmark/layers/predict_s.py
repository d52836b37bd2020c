"""Seconds of the predict layer a fit (``inference/pg_gibbs.py`` and the
Laplace moments): the synced span around the drivers' tail (``_gpc_tail``, or
``_mult_tail`` for several classes), the mean over the traced window's fits."""


def read(run):
    return run.span_mean("predict")
