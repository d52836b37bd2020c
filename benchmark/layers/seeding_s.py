"""Seconds of k-means‖'s seeding a fit (``ops/kmeans.py:_kmeanspar_rows``, inside the
subsample layer: its four candidate rounds, the 1-NN weighting, the weighted k-means++
reduction of the candidates and the polish; Lloyd's rounds are not in it): the synced
span around each call, which ``kmeans`` looks up at each call, the mean over the traced
window's fits."""


def read(run):
    return run.span_mean("seeding")
