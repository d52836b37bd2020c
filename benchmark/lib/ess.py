"""Effective sample size: a frozen copy of ``flgp_tpu_torch/inference/
diagnostics.py:ess`` (bulk ESS per dimension, Geyer initial monotone
sequence, on the host in float64), the yardstick of a sampling cell."""

from __future__ import annotations

import numpy as np


def ess(draws, max_lag: int | None = None) -> np.ndarray:
    """ESS per dimension of draws (n_samples, n_chains, dim)."""
    x = np.asarray(draws, dtype=np.float64)
    n, c, d = x.shape
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    out = np.zeros(d)
    m = 1 << (2 * n - 1).bit_length()
    for j in range(d):
        xc = x[:, :, j] - x[:, :, j].mean(0)
        f = np.fft.rfft(xc, n=m, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=m, axis=0)[:n].real / n
        rho = acov.mean(1) / acov[0].mean()
        tau = 1.0
        k = 1
        prev_pair = np.inf
        while k + 1 < max_lag:
            pair = rho[k] + rho[k + 1]
            if pair < 0:
                break
            pair = min(pair, prev_pair)
            tau += 2.0 * pair
            prev_pair = pair
            k += 2
        out[j] = n * c / tau
    return out
