"""Datasets, generated on the host with NumPy.

``torus_rings``, ``spiral``, ``torus_rings_r``, ``spiral_r``,
``spiral_r_anchors``, ``gaussian_blobs``, ``mnist_like``, ``digits`` and
``digits_large`` are copies of the functions of the same names in
``flgp_tpu.datasets`` (same seed, same arrays), kept here so that the port
runs without the JAX package.  The three ``_r`` functions replay the R
session of the reference R package's README examples (``utils.r_rng``,
``utils.r_kmeans``), so a fit runs on the data, and with the anchors, its
golden numbers were committed on.  ``digits`` and ``digits_large`` read the
handwritten-digits images bundled with scikit-learn, which they import when
called.
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


def torus_rings_r(seed: int = 1234) -> Split:
    """The README classification example bit for bit: the same R stream
    (set.seed(1234), runif thetas, rejection-method sample.int split)."""
    from .utils.r_rng import RRng

    n, n_each, m = 4800, 800, 100
    r = RRng(seed)
    thetas = r.runif(n, 0.0, 2.0 * np.pi)
    X = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    Y = np.zeros(n)
    for i in range(6):
        sl = slice(i * n_each, (i + 1) * n_each)
        X[sl] *= 0.5 + 0.1 * i
        Y[sl] = float((-1) ** i > 0)
    X = (X - X.mean(0)) / X.std(0, ddof=1)
    X = X / np.sqrt(X.shape[1])
    tr = r.sample_int(n, m) - 1
    te = np.setdiff1d(np.arange(n), tr)
    return Split(X[tr], Y[tr], X[te], Y[te])


def spiral_r(seed: int = 1234, return_rng: bool = False):
    """The README regression example bit for bit: the same R stream for
    theta, the train/test split and the N(0, 1) observation noise.

    ``return_rng=True`` also returns the RRng where the README script's first
    fit call begins: the anchor draws of its ``stats::kmeans`` calls go on
    from there."""
    from .utils.r_rng import RRng

    n, m = 4000, 200
    r = RRng(seed)
    theta = r.runif(n, 0.0, 8.0 * np.pi)
    radius = (theta + 4.0) ** 0.7
    X = np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=1)
    Y = 3.0 * np.sin(theta / 10.0) + 3.0 * np.cos(theta / 2.0) + 4.0 * np.sin(4.0 * theta / 5.0)
    tr = r.sample_int(n, m) - 1
    te = np.setdiff1d(np.arange(n), tr)
    y_train = Y[tr] + r.rnorm(m, 0.0, 1.0)
    split = Split(X[tr], y_train, X[te], Y[te])
    return (split, r) if return_rng else split


def spiral_r_anchors(seed: int = 1234, s: int = 500):
    """The anchor sets (centers, cluster sizes) the README regression fits
    used, by replaying the R session: data, split, noise, then the SE fit's
    and the LAE fit's ``stats::kmeans(X_all, s, iter.max=100)`` (one
    ``sample.int(n, s)`` draw each, then deterministic Hartigan–Wong).
    Returns ``{"se": (centers, sizes), "lae": (centers, sizes)}`` with X_all
    in the drivers' [train; test] row order."""
    from .utils.r_kmeans import r_kmeans

    ds, rng = spiral_r(seed, return_rng=True)
    X_all = np.concatenate([ds.x_train, ds.x_test])
    out = {}
    out["se"] = r_kmeans(rng, X_all, s, iter_max=100)
    out["lae"] = r_kmeans(rng, X_all, s, iter_max=100)
    return out


def gaussian_blobs(
    n_per_class: int = 50, n_classes: int = 3, d: int = 3, sep: float = 5.0, seed: int = 0
) -> Split:
    """Well-separated Gaussian blobs for multiclass smoke tests (mirrors the
    roxygen examples at R/Fit.R:286-298)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, sep, size=(n_classes, d))
    X = np.concatenate(
        [rng.normal(centers[j], 1.0, size=(n_per_class, d)) for j in range(n_classes)]
    )
    Y = np.repeat(np.arange(n_classes), n_per_class).astype(float)
    idx = rng.permutation(len(Y))
    half = len(Y) // 2
    tr, te = idx[:half], idx[half:]
    return Split(X[tr], Y[tr], X[te], Y[te])


def mnist_like(
    n: int = 70_000,
    n_classes: int = 10,
    d: int = 16,
    d_intrinsic: int = 2,
    m_train: int = 500,
    noise_sd: float = 0.05,
    seed: int = 0,
) -> Split:
    """Large-n multiclass manifold data at MNIST scale (n=7e4, 10 classes).

    Each class is a distinct 2-D nonlinear surface (random quadratic
    embedding of a unit square) in d ambient dims plus isotropic noise —
    clustered low-intrinsic-dimension structure like image manifolds, which
    is the regime FLGP's graph-Laplacian prior targets.  Used for the
    BASELINE n=7e4 multiclass config where real MNIST is unavailable offline.
    """
    rng = np.random.default_rng(seed)
    n_each = n // n_classes
    X = np.empty((n_each * n_classes, d))
    Y = np.repeat(np.arange(n_classes), n_each).astype(float)
    for j in range(n_classes):
        u = rng.uniform(-1.0, 1.0, size=(n_each, d_intrinsic))
        # random affine + quadratic lift, distinct per class
        A = rng.normal(0.0, 1.0, size=(d_intrinsic, d))
        B = rng.normal(0.0, 0.5, size=(d_intrinsic, d))
        c = rng.normal(0.0, 2.0, size=(d,))
        X[j * n_each:(j + 1) * n_each] = u @ A + (u**2) @ B + c
    X += rng.normal(0.0, noise_sd, size=X.shape)
    X = (X - X.mean(0)) / X.std(0, ddof=1) / np.sqrt(d)
    idx = rng.permutation(len(Y))
    tr, te = idx[:m_train], idx[m_train:]
    return Split(X[tr], Y[tr], X[te], Y[te])


def digits(m_train: int = 300, seed: int = 0) -> Split:
    """The scikit-learn handwritten-digits set (1797 8×8 images, 10 classes;
    bundled with sklearn — no download).  Real image-manifold multiclass data
    for the fit_*_logit_mult drivers; the BASELINE "MNIST-subset" stand-in
    available without network egress.  Pixels are scaled to [0, 1] and the
    split is transductive: train labels on ``m_train`` rows, predict the rest.
    """
    from sklearn.datasets import load_digits

    data = load_digits()
    X = data.data.astype(np.float64) / 16.0
    Y = data.target.astype(np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(Y))
    tr, te = idx[:m_train], idx[m_train:]
    return Split(X[tr], Y[tr], X[te], Y[te])


def digits_large(
    n: int = 70_000,
    m_train: int = 500,
    seed: int = 0,
    shift_max: float = 1.0,
    noise_sd: float = 0.02,
) -> Split:
    """REAL image data at MNIST scale: the 1797 sklearn handwritten digits
    replicated to ``n`` rows by documented augmentation — each replica is a
    random source image resampled at a uniform sub-pixel translation
    (bilinear, |shift| ≤ ``shift_max`` px, border-clamped) plus
    N(0, ``noise_sd``²) pixel noise.

    This is the BASELINE config-3 "MNIST-subset" dataset (real image
    manifold, no network egress needed): translations move points *along*
    the digit manifold, so the class structure the graph-Laplacian prior
    exploits is genuine, unlike a synthetic surface.  Pixels in [0, 1],
    transductive split as in the reference fit drivers
    (src/Fit.cpp:123-126 of the R package)."""
    from sklearn.datasets import load_digits

    data = load_digits()
    imgs = data.images.astype(np.float64) / 16.0  # (1797, 8, 8)
    labels = data.target.astype(np.float64)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, len(labels), size=n)
    dx = rng.uniform(-shift_max, shift_max, size=n)
    dy = rng.uniform(-shift_max, shift_max, size=n)
    # vectorized bilinear resample of image src[k] at grid (i+dy[k], j+dx[k])
    ii = np.arange(8, dtype=np.float64)
    gy = ii[None, :, None] + dy[:, None, None]  # (n, 8, 1)
    gx = ii[None, None, :] + dx[:, None, None]  # (n, 1, 8)
    y0 = np.clip(np.floor(gy).astype(np.int64), 0, 7)
    x0 = np.clip(np.floor(gx).astype(np.int64), 0, 7)
    y1 = np.minimum(y0 + 1, 7)
    x1 = np.minimum(x0 + 1, 7)
    fy = np.clip(gy - y0, 0.0, 1.0)
    fx = np.clip(gx - x0, 0.0, 1.0)
    I = imgs[src]  # (n, 8, 8)
    k = np.arange(n)[:, None, None]
    out = (
        (1 - fy) * (1 - fx) * I[k, y0, x0]
        + (1 - fy) * fx * I[k, y0, x1]
        + fy * (1 - fx) * I[k, y1, x0]
        + fy * fx * I[k, y1, x1]
    )
    X = out.reshape(n, 64) + rng.normal(0.0, noise_sd, size=(n, 64))
    Y = labels[src]
    idx = rng.permutation(n)
    tr, te = idx[:m_train], idx[m_train:]
    return Split(X[tr], Y[tr], X[te], Y[te])
