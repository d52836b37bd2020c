"""Pairwise squared-Euclidean distances by the ‖x‖² − 2x·u + ‖u‖² expansion."""

from __future__ import annotations

import torch


def sqdist(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """All-pairs squared Euclidean distances, shape (n, s).

    Keeps the expansion's small negative values from cancellation; callers
    that need nonnegativity clamp.  The cross term must run at full f32
    precision (see ``config.pin_full_precision``).
    """
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    u2 = torch.sum(U * U, dim=1, keepdim=True)
    return x2 - 2.0 * (X @ U.T) + u2.T


def sqdist_blocked(X: torch.Tensor, U: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """Row-blocked variant for large n (bounds the live (block, s) tile)."""
    n = X.shape[0]
    if n <= block:
        return sqdist(X, U)
    return torch.cat([sqdist(X[i:i + block], U) for i in range(0, n, block)], dim=0)
