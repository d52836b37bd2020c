"""Frozen copy of the spiral generator the regression cells draw their data from.

``spiral`` is a copy of the function of the same name in
``flgp_tpu_torch/datasets.py`` as it stood when the cell was defined (same
seed, same arrays), kept here so that a later change to the port cannot change
the benchmark's traffic.  The data are made on the host in float64, as users
pass them.
"""

from __future__ import annotations

import numpy as np

from lib.datasets import Split


def spiral(n: int = 4000, m_train: int = 200, noise_sd: float = 1.0, seed: int = 1234) -> Split:
    """Archimedean-style spiral regression: targets are a smooth function of
    the arc parameter; train targets are observed with N(0, σ²) noise."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 8.0 * np.pi, size=n)
    radius = (theta + 4.0) ** 0.7
    X = np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=1)
    Y = 3.0 * np.sin(theta / 10.0) + 3.0 * np.cos(theta / 2.0) + 4.0 * np.sin(4.0 * theta / 5.0)
    idx = rng.permutation(n)
    tr, te = idx[:m_train], idx[m_train:]
    y_train = Y[tr] + rng.normal(0.0, noise_sd, size=m_train)
    return Split(X[tr], y_train, X[te], Y[te])


def make(spec: dict, seed: int) -> Split:
    """The data a configuration's ``data`` group names, drawn from ``seed``."""
    if spec["generator"] != "spiral":
        raise KeyError(f"lib/spiral.py makes spiral data, not {spec['generator']!r}")
    return spiral(seed=seed, **{k: v for k, v in spec.items() if k != "generator"})
