"""Gaussian-process regression on the spectral heat-kernel representation.

Closed-form Gaussian marginal likelihood in the m ≤ K direct and m > K
Woodbury forms, exact conditioning for prediction and the diagonal
posterior covariance.  Plain functions on tensors: ``torch.autograd``
differentiates them in ``t`` and ``noise``.

``t`` may be a scalar or a batch of diffusion times; ``noise`` then has
``t``'s shape (one homoscedastic value per lane) or one more trailing axis of
length m (per-point noise), and every result gains ``t``'s batch shape (the
batch dimension written out where the JAX package vmaps).  In ``gpr_nmll``
and ``gpr_nmll_posterior`` the spectral pair may be batched as well (one pair
per lane of a bandwidth grid, see ``ops.heat_kernel``), with ``t`` one value
per lane.
"""

from __future__ import annotations

import torch

from ..config import EPS
from ..ops import linalg
from ..ops.heat_kernel import heat_kernel, heat_kernel_weights
from ..types import EigenPair


def _as_2d(Y: torch.Tensor) -> torch.Tensor:
    return Y[:, None] if Y.dim() == 1 else Y


def _noise_diag(t, noise, sigma: float, m: int, like: torch.Tensor):
    """(t, z) as tensors of ``like``'s dtype and device, z = noise + σ
    broadcast to t.shape + (m,)."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    noise = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    if noise.dim() == t.dim():
        noise = noise[..., None]
    return t, (noise + sigma).expand(*t.shape, m)


def gpr_nmll(eigenpair: EigenPair, Y: torch.Tensor, idx, K: int, t, noise,
             sigma: float) -> torch.Tensor:
    """Negative marginal log likelihood.

    ``noise`` is homoscedastic (t's shape) or per-point (t.shape + (m,)).
    The branch m ≤ K is chosen by shape."""
    Y = _as_2d(Y)
    m, q = Y.shape
    t, z = _noise_diag(t, noise, sigma, m, Y)

    if m <= K:
        C = linalg.add_diag(heat_kernel(eigenpair, t, K, idx, idx), z)
        L = linalg.cholesky(C)
        alpha = linalg.chol_solve(L, Y)
        return 0.5 * torch.sum(Y * alpha, dim=(-2, -1)) / q + linalg.chol_logdet_half(L)

    lam = eigenpair.laplacian_eigenvalues(K)
    lam_sqrt = torch.exp(-0.5 * t[..., None] * lam)
    V = eigenpair.vectors[..., idx, :K]
    alpha, L_Q = linalg.woodbury_solve_terms(V, lam_sqrt, 1.0 / z, Y)
    nmll = 0.5 * torch.sum(Y * alpha, dim=(-2, -1)) / q + linalg.chol_logdet_half(L_Q)
    return nmll + 0.5 * torch.sum(torch.log(z + EPS), dim=-1)


def t_log_prior(t, p: float, q: float, tau: float):
    """Negative log prior penalty on the diffusion time:
    p·log(t + 1e-9) + (t/τ)^(−q)."""
    return p * torch.log(t + EPS) + (t / tau) ** (-q)


def noise_log_prior(noise, sigma: float, alpha: float, beta: float, per_point: bool = False):
    """Inverse-gamma penalty on (noise + σ), averaged over the points when
    the noise is per-point (trailing axis of length m)."""
    z = noise + sigma
    pr = (alpha + 1.0) * torch.log(z) + beta / z
    return torch.mean(pr, dim=-1) if per_point else pr


def gpr_nmll_posterior(eigenpair: EigenPair, Y: torch.Tensor, idx, K: int, t, noise,
                       sigma: float, p: float = 1.0, q: float = 10.0, tau: float = 2.0,
                       alpha: float = 1e-1, beta: float = 1e-3) -> torch.Tensor:
    """NMLL plus priors: the "posterior" empirical-Bayes objective."""
    t = torch.as_tensor(t, dtype=Y.dtype, device=Y.device)
    noise = torch.as_tensor(noise, dtype=Y.dtype, device=Y.device)
    nmll = gpr_nmll(eigenpair, Y, idx, K, t, noise, sigma)
    return nmll + t_log_prior(t, p, q, tau) + noise_log_prior(
        noise, sigma, alpha, beta, per_point=noise.dim() > t.dim())


def gpr_mll(eigenpair: EigenPair, Y: torch.Tensor, idx, K: int, t, noise,
            sigma: float) -> torch.Tensor:
    """Marginal log likelihood; equals −gpr_nmll for q = 1."""
    return -gpr_nmll(eigenpair, _as_2d(Y), idx, K, t, noise, sigma)


def gpr_predict(eigenpair: EigenPair, Y: torch.Tensor, idx0, idx1, K: int, t, noise,
                sigma: float) -> torch.Tensor:
    """Posterior-mean prediction at idx1 given observations at idx0 (scalar
    t; scalar or (m,) noise)."""
    Y2 = _as_2d(Y)
    m = Y2.shape[0]
    t, z = _noise_diag(t, noise, sigma, m, Y2)

    if m <= K:
        C = linalg.add_diag(heat_kernel(eigenpair, t, K, idx0, idx0), z)
        alpha = linalg.chol_solve(linalg.cholesky(C), Y2)
        pred = linalg.pdot(heat_kernel(eigenpair, t, K, idx1, idx0), alpha)
    else:
        lam_sqrt = torch.exp(-0.5 * t * eigenpair.laplacian_eigenvalues(K))
        V = eigenpair.vectors[idx0, :K]
        alpha, _ = linalg.woodbury_solve_terms(V, lam_sqrt, 1.0 / z, Y2)
        w = heat_kernel_weights(eigenpair, t, K)
        pred = linalg.pdot(eigenpair.vectors[idx1, :K], w[:, None] * linalg.pdot(V.T, alpha))
    return pred[:, 0] if Y.dim() == 1 else pred


def gpr_posterior_cov(eigenpair: EigenPair, idx0, idx1, K: int, t, noise,
                      sigma: float) -> torch.Tensor:
    """Diagonal predictive covariance at idx1 given the observations at idx0.

    Adds (noise + σ) to the predictive variance and takes the homoscedastic
    noise scalar, as the reference does."""
    vectors = eigenpair.vectors
    V1 = vectors[idx0, :K]
    m = V1.shape[0]
    t = torch.as_tensor(t, dtype=vectors.dtype, device=vectors.device)
    z = torch.as_tensor(noise, dtype=vectors.dtype, device=vectors.device) + sigma
    w = heat_kernel_weights(eigenpair, t, K)
    V2 = vectors[idx1, :K]

    if m <= K:
        K11 = linalg.add_diag(heat_kernel(eigenpair, t, K, idx0, idx0), z)
        C21 = heat_kernel(eigenpair, t, K, idx1, idx0)
        alpha = linalg.chol_solve(linalg.cholesky(K11), C21.T).T
        beta = torch.sum(C21 * alpha, dim=1)
    else:
        lam_sqrt = torch.exp(-0.5 * t * eigenpair.laplacian_eigenvalues(K))
        VtV = linalg.pdot(V1.T, V1)
        Q = linalg.add_diag(lam_sqrt[:, None] * VtV * lam_sqrt[None, :], z)
        L_Q = linalg.cholesky(Q)
        inner = VtV - linalg.pdot(
            VtV, lam_sqrt[:, None] * linalg.chol_solve(L_Q, lam_sqrt[:, None] * VtV))
        A = (1.0 / z) * (w[:, None] * inner * w[None, :])
        beta = torch.sum(V2 * linalg.pdot(V2, A), dim=1)

    prior = torch.sum((V2 * w[None, :]) * V2, dim=1)
    return prior + z - beta
