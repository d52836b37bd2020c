"""MCMC diagnostics: split-R̂ and effective sample size.

The split-R̂ and Geyer initial-monotone-sequence ESS of the Stan reference
manual / Vehtari et al. 2021, as ``flgp_tpu.inference.diagnostics`` computes
them.  Draws are (n_samples, n_chains, dim).
"""

from __future__ import annotations

import numpy as np
import torch


def split_rhat(draws) -> torch.Tensor:
    """Split-R̂ per dimension for draws (n_samples, n_chains, dim), a tensor
    or an array; the result is a tensor on the draws' device."""
    draws = torch.as_tensor(draws)
    n = draws.shape[0]
    half = n // 2
    x = torch.cat([draws[:half], draws[half:2 * half]], dim=1)        # (half, 2c, d)
    n = x.shape[0]
    chain_mean = torch.mean(x, dim=0)                                   # (2c, d)
    chain_var = torch.var(x, dim=0, correction=1)                       # (2c, d)
    B = n * torch.var(chain_mean, dim=0, correction=1)                  # (d,)
    W = torch.mean(chain_var, dim=0)                                    # (d,)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / W)


def ess(draws, max_lag: int | None = None) -> np.ndarray:
    """Bulk ESS per dimension (Geyer initial monotone sequence), on the host
    in float64: diagnostics run on summaries, not in the sampler's loop."""
    if isinstance(draws, torch.Tensor):
        draws = draws.detach().cpu().numpy()
    x = np.asarray(draws, dtype=np.float64)
    n, c, d = x.shape
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    out = np.zeros(d)
    m = 1 << (2 * n - 1).bit_length()
    for j in range(d):
        xc = x[:, :, j] - x[:, :, j].mean(0)
        # FFT autocovariance per chain, averaged
        f = np.fft.rfft(xc, n=m, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=m, axis=0)[:n].real / n
        rho = acov.mean(1) / acov[0].mean()
        # Geyer pairs, made monotone
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
