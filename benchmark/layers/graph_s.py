"""Seconds of the graph layer a fit (``ops/knn.py``, ``ops/lae.py``): the synced
spans around ``fit.spectral.knn`` and ``lae_weights``, the mean over the traced
window's fits."""


def read(run):
    knn, lae = run.span_mean("knn"), run.span_mean("lae_weights")
    return None if knn is None or lae is None else knn + lae
