"""Heat-kernel covariance from a spectral pair.

H = V·diag(exp(−t·(1−λ)))·Vᵀ restricted to row subsets.  ``t`` may be a
scalar or a batch of diffusion times; a batch of B times gives a leading
batch axis of size B on every result (the batch dimension written out where
the JAX package vmaps over t).
"""

from __future__ import annotations

import torch

from ..types import EigenPair


def heat_kernel_weights(eigenpair: EigenPair, t, K: int) -> torch.Tensor:
    """exp(−t·(1−λ_k)) for the top-K spectrum, shape t.shape + (K,)."""
    lam = eigenpair.laplacian_eigenvalues(K)
    t = torch.as_tensor(t, dtype=lam.dtype, device=lam.device)
    return torch.exp(-t[..., None] * lam)


def heat_kernel(eigenpair: EigenPair, t, K: int, idx0, idx1) -> torch.Tensor:
    """H[idx0, idx1], shape t.shape + (len(idx0), len(idx1)).  The row
    selections may be index tensors or slices."""
    w = heat_kernel_weights(eigenpair, t, K)
    V0 = eigenpair.vectors[idx0, :K]
    V1 = eigenpair.vectors[idx1, :K]
    return (V0 * w[..., None, :]) @ V1.T


def heat_kernel_diag(eigenpair: EigenPair, t, K: int, idx) -> torch.Tensor:
    """diag(H[idx, idx]) without materializing the full block."""
    w = heat_kernel_weights(eigenpair, t, K)
    V = eigenpair.vectors[idx, :K]
    return torch.einsum("ik,...k->...i", V * V, w)
