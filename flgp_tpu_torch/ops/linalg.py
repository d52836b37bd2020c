"""Batched dense linear-algebra helpers shared by the model layer.

Every function takes any leading batch dimensions.
"""

from __future__ import annotations

import torch

from ..config import EPS


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """matmul; float32 runs at full precision (``config.pin_full_precision``)."""
    return torch.matmul(a, b)


def cholesky(C: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN-filled (not raising) where C is not
    positive definite, so a failed lane of a batch poisons only itself."""
    L, info = torch.linalg.cholesky_ex(C)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve C x = B given L = chol(C) (lower)."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def chol_logdet_half(L: torch.Tensor) -> torch.Tensor:
    """Σ log(diag(L) + 1e-9): half log-determinant with the jitter."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1) + EPS), dim=-1)


def add_diag(C: torch.Tensor, d) -> torch.Tensor:
    """C + diag(d) (d scalar or vector), as a new tensor."""
    out = C.clone()
    diag = torch.diagonal(out, dim1=-2, dim2=-1)
    diag += d
    return out


def woodbury_solve_terms(V: torch.Tensor, lam_sqrt: torch.Tensor, z_inv: torch.Tensor,
                         Y: torch.Tensor):
    """Woodbury solve for C = V·diag(lam)·Vᵀ + diag(1/z_inv).

    Returns (alpha, L_Q) with alpha = C⁻¹Y and L_Q = chol(Q),
    Q = Λ^{1/2}·Vᵀ·diag(z_inv)·V·Λ^{1/2} + I.  V (m, K); lam_sqrt (..., K);
    z_inv (..., m), the elementwise inverse of the diagonal noise; Y (m, q).
    The homoscedastic model is the z_inv = const special case.
    """
    VtZiV = pdot(V.mT, z_inv[..., :, None] * V)
    Q = add_diag(lam_sqrt[..., :, None] * VtZiV * lam_sqrt[..., None, :], 1.0)
    L_Q = cholesky(Q)
    ZiY = z_inv[..., :, None] * Y
    inner = chol_solve(L_Q, lam_sqrt[..., :, None] * pdot(V.mT, ZiY))
    alpha = ZiY - z_inv[..., :, None] * pdot(V, lam_sqrt[..., :, None] * inner)
    return alpha, L_Q
