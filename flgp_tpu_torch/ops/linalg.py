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
