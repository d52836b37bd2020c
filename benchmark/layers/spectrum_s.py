"""Seconds of the spectrum layer a fit (``ops/spectrum.py``): the synced span
around ``fit.spectral.spectrum_fused``, the mean over the traced window's fits."""


def read(run):
    return run.span_mean("spectrum")
