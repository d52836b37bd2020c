"""Gaussian-process classification: Laplace approximation on the heat kernel.

Newton mode-finding (GPML Alg 3.1 with the binomial-count generalization
W = N·π·(1−π)) and the Laplace-approximate marginal likelihood, plus Laplace
posterior moments (GPML Alg 3.2).  Tolerance 1e-5, at most 100 iterations.

Every function takes a leading batch of lanes (one per diffusion time t when
the 1-D optimizer evaluates a grid).  The batched Newton loop stops when no
lane is still running and freezes each lane the moment its own condition
(``it < max_iter and delta >= tol``) fails: the frozen lane's state, its
iteration count included, is exactly what running it alone would give.
Deciding whether to go on is one host sync a round (``utils.metrics.to_host``);
each round of Newton steps counts one ``newton_rounds``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..config import EPS
from ..ops import linalg
from ..ops.heat_kernel import heat_kernel, heat_kernel_diag
from ..types import EigenPair
from ..utils.metrics import count, to_host


class NewtonState(NamedTuple):
    it: torch.Tensor            # (...,) int32 iterations taken
    f: torch.Tensor             # (..., m) latent mode
    a: torch.Tensor             # (..., m) C⁻¹f
    logdet_half: torch.Tensor   # (...,) ½ log det B of the last factorization
    delta: torch.Tensor         # (...,) last Σ|Δf|


def _initial_state(batch: torch.Size, m: int, like: torch.Tensor) -> NewtonState:
    f0 = like.new_zeros(batch + (m,))
    return NewtonState(
        torch.zeros(batch, dtype=torch.int32, device=like.device), f0, f0,
        like.new_zeros(batch), like.new_full(batch, float("inf")),
    )


def _iterate_lanes(body: Callable[[NewtonState], NewtonState], state: NewtonState,
                   tol: float, max_iter: int) -> NewtonState:
    """Run ``body`` on every lane until none is active; a lane whose
    condition is false keeps its state (``torch.where`` on every field).
    One host sync per round decides whether to go on."""
    while True:
        active = (state.it < max_iter) & (state.delta >= tol)
        if not to_host(torch.any(active)):
            return state
        count("newton_rounds")
        new = body(state)
        state = NewtonState(*(
            torch.where(active.reshape(active.shape + (1,) * (old.dim() - active.dim())), nw, old)
            for nw, old in zip(new, state)
        ))


def _newton_mode(C: torch.Tensor, Y: torch.Tensor, N: torch.Tensor, tol: float,
                 max_iter: int) -> NewtonState:
    """Posterior mode of the logit model for C of shape (..., m, m).

    ``logdet_half`` is Σ log(diag(chol B)+1e-9) for B = I + √W·C·√W at the
    pre-update f, the last iteration's factorization."""
    def body(st: NewtonState) -> NewtonState:
        pi = torch.sigmoid(st.f)
        W = N * pi * (1.0 - pi)
        sqrt_W = torch.sqrt(W)
        L_B = linalg.cholesky(linalg.add_diag(sqrt_W[..., :, None] * C * sqrt_W[..., None, :], 1.0))
        b = W * st.f + (Y - N * pi)
        Cb = linalg.pdot(C, b[..., None])[..., 0]
        a = b - sqrt_W * linalg.chol_solve(L_B, (sqrt_W * Cb)[..., None])[..., 0]
        f_new = linalg.pdot(C, a[..., None])[..., 0]
        delta = torch.sum(torch.abs(st.f - f_new), dim=-1)
        return NewtonState(st.it + 1, f_new, a, linalg.chol_logdet_half(L_B), delta)

    return _iterate_lanes(body, _initial_state(C.shape[:-2], C.shape[-1], C), tol, max_iter)


def _laplace_marginal(st: NewtonState, Y: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    amll = -0.5 * torch.sum(st.a * st.f, dim=-1)
    amll = amll + torch.sum(Y * F.logsigmoid(st.f) + (N - Y) * F.logsigmoid(-st.f), dim=-1)
    return amll - st.logdet_half


def gpc_marginal_log_likelihood(C, Y, N, tol: float = 1e-5, max_iter: int = 100) -> torch.Tensor:
    """Laplace-approximate marginal log likelihood of the binomial-logit GP
    (C includes the σ ridge); ``flgp_tpu.models.gpc.gpc_marginal_log_likelihood``."""
    return gpc_marginal_log_likelihood_status(C, Y, N, tol, max_iter)[0]


def gpc_marginal_log_likelihood_status(C, Y, N, tol: float = 1e-5, max_iter: int = 100):
    """Laplace-approximate marginal log likelihood of the binomial-logit GP
    (C includes the σ ridge), with the Newton status (iterations, final
    Σ|Δf|)."""
    st = _newton_mode(C, Y, N, tol, max_iter)
    return _laplace_marginal(st, Y, N), st.it, st.delta


def gpc_marginal_log_likelihood_lowrank(Phi, Y, N, sigma: float, tol: float = 1e-5,
                                        max_iter: int = 100) -> torch.Tensor:
    """The Laplace marginal for C = ΦΦᵀ + σI by the K-dim Woodbury dual
    (below); ``flgp_tpu.models.gpc.gpc_marginal_log_likelihood_lowrank``."""
    return gpc_marginal_log_likelihood_lowrank_status(Phi, Y, N, sigma, tol, max_iter)[0]


def gpc_marginal_log_likelihood_lowrank_status(Phi, Y, N, sigma: float, tol: float = 1e-5,
                                               max_iter: int = 100):
    """Laplace marginal for C = ΦΦᵀ + σI, Φ of shape (..., m, K), via the
    whitened K-dim Woodbury dual — the same value as the dense form, but each
    Newton step costs O(mK² + K³):

        B = I + √W·C·√W = D + ΨΨᵀ,  D = diag(1+σW),  Ψ = √W·Φ
        B⁻¹ = D⁻¹ − D⁻¹Ψ·S⁻¹·ΨᵀD⁻¹,  S = I_K + ΨᵀD⁻¹Ψ
        log det B = Σ log d + log det S
    """
    K = Phi.shape[-1]
    eyeK = torch.eye(K, dtype=Phi.dtype, device=Phi.device)
    PhiT = Phi.mT

    def cov_vec(v):
        return linalg.pdot(Phi, linalg.pdot(PhiT, v[..., None]))[..., 0] + sigma * v

    def body(st: NewtonState) -> NewtonState:
        f = st.f
        pi = torch.sigmoid(f)
        W = N * pi * (1.0 - pi)
        sqrt_W = torch.sqrt(W)
        d = 1.0 + sigma * W
        b = W * f + (Y - N * pi)
        h = sqrt_W * cov_vec(b)
        S = eyeK + linalg.pdot(PhiT, (W / d)[..., None] * Phi)
        L_S = linalg.cholesky(S)
        rhs = linalg.pdot(PhiT, (sqrt_W * h / d)[..., None])
        sol = linalg.chol_solve(L_S, rhs)
        u = h / d - (sqrt_W / d) * linalg.pdot(Phi, sol)[..., 0]
        a = b - sqrt_W * u
        f_new = cov_vec(a)
        logdet_half = 0.5 * torch.sum(torch.log(d), dim=-1) + linalg.chol_logdet_half(L_S)
        delta = torch.sum(torch.abs(f - f_new), dim=-1)
        return NewtonState(st.it + 1, f_new, a, logdet_half, delta)

    st = _iterate_lanes(body, _initial_state(Phi.shape[:-2], Phi.shape[-2], Phi), tol, max_iter)
    return _laplace_marginal(st, Y, N), st.it, st.delta


def gpc_nmll_objective_status(eigenpair: EigenPair, Y, N, idx, K: int, t, sigma: float,
                              tol: float = 1e-5, max_iter: int = 100):
    """−marginal as a function of t (scalar or a batch of times), with the
    Newton status.  m > K takes the exact K-dim Woodbury dual, m ≤ K the
    dense m×m form.  ``idx`` selects the m training rows (tensor or slice)."""
    m = Y.shape[-1]
    t = torch.as_tensor(t, dtype=eigenpair.vectors.dtype, device=eigenpair.vectors.device)
    if m > K:
        lam = eigenpair.laplacian_eigenvalues(K)
        Phi = eigenpair.vectors[idx, :K] * torch.exp(-0.5 * t[..., None] * lam)[..., None, :]
        amll, it, delta = gpc_marginal_log_likelihood_lowrank_status(Phi, Y, N, sigma, tol,
                                                                      max_iter)
        return -amll, it, delta
    C = linalg.add_diag(heat_kernel(eigenpair, t, K, idx, idx), sigma)
    amll, it, delta = gpc_marginal_log_likelihood_status(C, Y, N, tol, max_iter)
    return -amll, it, delta


def gpc_nmll_objective(eigenpair: EigenPair, Y, N, idx, K: int, t, sigma: float,
                       tol: float = 1e-5, max_iter: int = 100) -> torch.Tensor:
    """−marginal: the GPC empirical-Bayes objective as a function of t."""
    return gpc_nmll_objective_status(eigenpair, Y, N, idx, K, t, sigma, tol, max_iter)[0]


def gpc_nlp_objective(eigenpair: EigenPair, Y, N, idx, K: int, t, sigma: float,
                      p: float = 1e-2, q: float = 10.0, tau: float = 2.0,
                      tol: float = 1e-5, max_iter: int = 100) -> torch.Tensor:
    """−marginal + t-prior  p·log t + (t/τ)^(−q): the "posterior" objective."""
    nm = gpc_nmll_objective(eigenpair, Y, N, idx, K, t, sigma, tol, max_iter)
    t = torch.as_tensor(t, dtype=nm.dtype, device=nm.device)
    return nm + p * torch.log(t + EPS) + (t / tau) ** (-q)


def gpc_posterior_moments(C11, C21, C22_diag, Y, tol: float = 1e-5, max_iter: int = 100
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Laplace predictive mean/variance at test points (GPML Alg 3.2),
    Bernoulli counts (N = 1).  A leading batch axis (one lane per class) on
    every argument gives one Newton run over the lanes."""
    m = Y.shape[-1]
    N = torch.ones((m,), dtype=C11.dtype, device=C11.device)
    st = _newton_mode(C11, Y, N, tol, max_iter)
    pi = torch.sigmoid(st.f)
    sqrt_W = torch.sqrt(pi * (1.0 - pi))
    L_B = linalg.cholesky(linalg.add_diag(sqrt_W[..., :, None] * C11 * sqrt_W[..., None, :], 1.0))
    mean = linalg.pdot(C21, (Y - pi)[..., None])[..., 0]
    Binv = linalg.chol_solve(L_B, torch.eye(m, dtype=C11.dtype, device=C11.device))
    beta = sqrt_W[..., :, None] * Binv * sqrt_W[..., None, :]
    cov = C22_diag - torch.sum(linalg.pdot(C21, beta) * C21, dim=-1)
    return mean, cov


def gpc_posterior_from_spectrum(eigenpair: EigenPair, Y, idx0, idx1, K: int, t, sigma: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble (C11 + σI, C21, diag C22 + σ) from the spectrum and return the
    Laplace moments at the rows ``idx1``; ``flgp_tpu.models.gpc.
    gpc_posterior_from_spectrum``.  A batch of times t (J,) with labels Y
    (J, m) gives (J, len(idx1)) moments."""
    C11 = linalg.add_diag(heat_kernel(eigenpair, t, K, idx0, idx0), sigma)
    C21 = heat_kernel(eigenpair, t, K, idx1, idx0)
    C22 = heat_kernel_diag(eigenpair, t, K, idx1) + sigma
    return gpc_posterior_moments(C11, C21, C22, Y)
