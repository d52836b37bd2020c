"""Frozen copies of the generators the cells draw their data from.

``torus_rings`` and ``mnist_like`` are copies of the functions of the same
names in ``flgp_tpu_torch/datasets.py`` as they stood when the benchmark was
defined (same seed, same arrays), kept here so that a later change to the
port cannot change the benchmark's traffic.  The data are made on the host in
float64, as users pass them.
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


def mnist_like(n: int = 70_000, n_classes: int = 10, d: int = 16, d_intrinsic: int = 2,
               m_train: int = 500, noise_sd: float = 0.05, seed: int = 0) -> Split:
    """Multiclass manifold data at MNIST scale: each class a distinct 2-D
    nonlinear surface (a random quadratic embedding of a unit square) in d
    ambient dimensions plus isotropic noise."""
    rng = np.random.default_rng(seed)
    n_each = n // n_classes
    X = np.empty((n_each * n_classes, d))
    Y = np.repeat(np.arange(n_classes), n_each).astype(float)
    for j in range(n_classes):
        u = rng.uniform(-1.0, 1.0, size=(n_each, d_intrinsic))
        A = rng.normal(0.0, 1.0, size=(d_intrinsic, d))
        B = rng.normal(0.0, 0.5, size=(d_intrinsic, d))
        c = rng.normal(0.0, 2.0, size=(d,))
        X[j * n_each:(j + 1) * n_each] = u @ A + (u**2) @ B + c
    X += rng.normal(0.0, noise_sd, size=X.shape)
    X = (X - X.mean(0)) / X.std(0, ddof=1) / np.sqrt(d)
    idx = rng.permutation(len(Y))
    tr, te = idx[:m_train], idx[m_train:]
    return Split(X[tr], Y[tr], X[te], Y[te])


GENERATORS = {"torus_rings": torus_rings, "mnist_like": mnist_like}


def make(spec: dict, seed: int) -> Split:
    """The data a configuration's ``data`` group names, drawn from ``seed``."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](seed=seed, **kw)
