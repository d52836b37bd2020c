"""Seconds of the train layer a fit (``models/gpc.py`` under
``inference/optimize.py``): the synced span around the drivers' training call
(``_train_gpc``, or ``_train_mult`` for several classes), the mean over the
traced window's fits."""


def read(run):
    return run.span_mean("train")
