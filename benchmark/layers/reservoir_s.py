"""Seconds of the reservoir pass a fit (``fit/streaming.py:reservoir_sample``:
Algorithm R over every row of the file, on the host, the sample's k-means
input): the synced span around it, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("reservoir")
