"""Blocked LOBPCG eigensolver for large symmetric operators.

One operator application per iteration on a whole (n, 3K) block, and a small
(3K, 3K) ``eigh`` for the Rayleigh-Ritz step.  Soft-locking variant with
Cholesky-QR orthonormalization (twice, for float32).  A Python loop of
``iters`` steps; nothing in it reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]  # (n, k) -> (n, k)


def _chol_qr(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormalize columns by Cholesky-QR, twice.  Returns the block and
    whether a Cholesky factorization failed (a 0-d bool tensor; checked once
    by the caller, after its loop)."""
    failed = torch.zeros((), dtype=torch.bool, device=X.device)
    for _ in range(2):
        G = X.T @ X
        G = G + 1e-9 * torch.trace(G) / G.shape[0] * torch.eye(
            G.shape[0], dtype=X.dtype, device=X.device)
        L, info = torch.linalg.cholesky_ex(G)
        failed = failed | (info != 0)
        X = torch.linalg.solve_triangular(L, X.T, upper=False).T
    return X, failed


class LobpcgResult(NamedTuple):
    eigenvalues: torch.Tensor   # (K,) descending
    eigenvectors: torch.Tensor  # (n, K)
    residual_norms: torch.Tensor


def lobpcg_standard(matvec: MatVec, X0: torch.Tensor, iters: int = 60) -> LobpcgResult:
    """Largest-K eigenpairs of a symmetric operator.

    X0: (n, K) initial block (random normal is fine).  Fixed iteration
    count; the last iteration's residual norms are reported.  Raises if the
    Gram matrix of a search block was not positive definite (only the
    1e-9·trace/3K ridge keeps it so once pairs have converged)."""
    k = X0.shape[1]
    X, failed = _chol_qr(X0)
    AX = matvec(X)
    P = torch.zeros_like(X)
    res = torch.zeros((k,), dtype=X.dtype, device=X.device)

    for _ in range(iters):
        theta = torch.sum(X * AX, dim=0)            # Rayleigh quotients
        R = AX - X * theta[None, :]
        # subspace S = [X, R, P]; the first iteration has P = 0 and the
        # Gram ridge keeps the Rayleigh-Ritz problem solvable regardless
        S, bad = _chol_qr(torch.cat([X, R, P], dim=1))
        failed = failed | bad
        AS = matvec(S)
        H = S.T @ AS
        w, C = torch.linalg.eigh(0.5 * (H + H.T))
        C = C[:, torch.argsort(-w, stable=True)[:k]]
        X_new = S @ C
        AX_new = AS @ C
        # implicit P: the component of the new X outside the old X span
        P = X_new - X @ (X.T @ X_new)
        res = torch.linalg.norm(R, dim=0)
        X, AX = X_new, AX_new

    if bool(failed):
        raise RuntimeError(
            "lobpcg_standard: a Cholesky-QR Gram matrix was not positive definite"
        )
    theta = torch.sum(X * AX, dim=0)
    order = torch.argsort(-theta, stable=True)
    return LobpcgResult(theta[order], X[:, order], res[order])
