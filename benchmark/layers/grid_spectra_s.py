"""Seconds of the SE grid's spectra a fit (``fit/spectral.py:se_spectrum_at``: the
bandwidth's weights, the cluster-normalized graph, ``ops/spectrum.py:spectrum_from_Z``'s
ordered column sums, dense gram, ``eigh`` and K9), summed over the grid's bandwidths:
the synced span around each call, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("grid_spectra")
