"""Synthetic datasets, generated on the host with NumPy.

``torus_rings`` is a copy of ``flgp_tpu.datasets.torus_rings`` (same seed,
same arrays), kept here so that the port runs without the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Split(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray


def torus_rings(n: int = 4800, n_rings: int = 6, m_train: int = 100, seed: int = 1234) -> Split:
    """Six concentric rings with alternating binary labels.

    Points are standardized per column then scaled by 1/√d."""
    rng = np.random.default_rng(seed)
    n_each = n // n_rings
    thetas = rng.uniform(0.0, 2.0 * np.pi, size=n)
    X = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    Y = np.zeros(n)
    for i in range(n_rings):
        sl = slice(i * n_each, (i + 1) * n_each)
        X[sl] *= 0.5 + 0.1 * i
        Y[sl] = float((-1) ** i > 0)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    X = X / np.sqrt(X.shape[1])
    idx = rng.permutation(n)
    tr, te = idx[:m_train], idx[m_train:]
    return Split(X[tr], Y[tr], X[te], Y[te])
