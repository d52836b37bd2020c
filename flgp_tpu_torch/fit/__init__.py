"""Fit drivers and spectral-basis construction."""
