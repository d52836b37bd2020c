"""Covariance-only and dimension-reduction entry points:
``heat_kernel_covariance`` and ``lae_eigenmap``, the port of
``flgp_tpu.fit.extras``.

Both follow the defaults the reference's R wrapper exposes (the
cluster-normalized Laplacian, ``root=True``).  Each takes a
``torch.Generator`` for the subsampler's draws and runs on the CUDA device
unless the caller passes ``device="cpu"``; the inputs keep their dtype, so
float32 points run the graph stage through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import GraphConfig, LaplacianType, Subsample
from ..ops.heat_kernel import heat_kernel
from ..ops.kmeans import subsample
from ..ops.spectrum import cross_similarity_lae, spectrum_from_Z
from . import spectral
from .drivers import _start


def heat_kernel_covariance(generator: torch.Generator, X, X_new, t,
                           g: GraphConfig = GraphConfig(), device=None) -> torch.Tensor:
    """(n, m) heat-kernel covariance between all n points [X; X_new] and the
    m rows of X, on the device."""
    device = _start(generator, device)
    X = torch.as_tensor(X, device=device)
    X_all = torch.cat([X, torch.as_tensor(X_new, dtype=X.dtype, device=device)], dim=0)
    m, n = X.shape[0], X_all.shape[0]
    eig, _ = spectral.build_spectrum(generator, X_all, g)
    K = min(g.resolved_K(), g.s, n)
    return heat_kernel(eig, torch.as_tensor(t, dtype=X.dtype, device=device), K,
                       slice(0, n), slice(0, m))


def lae_eigenmap(generator: torch.Generator, X, s: int, r: int, ndim: int,
                 method: Subsample = Subsample.KMEANS,
                 norm: LaplacianType = LaplacianType.CLUSTER_NORMALIZED, nstart: int = 1,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Laplacian-eigenmap embedding of the rows of X: the ``ndim`` smallest
    Laplacian eigenvalues 1 − λ (ascending) and the √n-scaled eigenvectors
    (n, ndim), on the device."""
    device = _start(generator, device)
    X = torch.as_tensor(X, device=device)
    sub = subsample(generator, X, s, Subsample(method), nstart)
    Z = cross_similarity_lae(X, sub.centers, r, LaplacianType(norm), sub.counts)
    eig = spectrum_from_Z(Z, ndim, True)
    return 1.0 - eig.values, eig.vectors
