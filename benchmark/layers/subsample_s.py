"""Seconds of the subsample layer a fit (``ops/kmeans.py``): the synced span
around ``fit.spectral.subsample``, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("subsample")
