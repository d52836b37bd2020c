"""Posteriors over the heat-kernel diffusion time t.

The reference point-optimizes t against the Laplace-approximate marginal
likelihood; here θ = log t gets a full posterior (``flgp_tpu.inference.
hyperparam``): by tempered SMC with random-walk mutations (the marginal's
Newton loop has no gradient), a scalar for binary GPC and a (J,)-vector for
one-vs-rest multiclass, and, since each class's factor is 1-D, exactly by
quadrature over a grid.

Where the JAX package maps over classes to spare TPU memory, every marginal
here is ONE batched Newton solve: Φ of shape (P, J, m, K) for P particles ×
J classes, or (J, G, m, K) for J classes × G grid points, each lane stopping
on its own condition (``models.gpc``).  At P = 64, J = 10, m = 500, K = 100
Φ is 128 MB in float32, the quadrature's 10 × 256 lanes 512 MB.

Each evaluation of the likelihood over all particles counts one
``smc_likelihood_evals`` and its lanes (particles × classes) in
``smc_lanes`` (``utils.metrics``); the Newton solves count ``newton_rounds``.

Prior: the reference's t-penalty p·log t + (t/τ)^(−q) is an improper density
on (0, ∞), so θ gets a proper lognormal base N(μ0, s0²) and the penalty is
folded into the tempered term: at β = 1 the target is
p(t | Y) ∝ p(Y | t)·penalty(t)·lognormal(t).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import resolve_device
from ..models.gpc import gpc_marginal_log_likelihood_lowrank
from ..models.latent import _same_device, t_log_prior_density
from ..types import EigenPair
from ..utils.metrics import count
from .smc import SmcResult, run_smc, run_smc_chunked


class TPosterior(NamedTuple):
    t: torch.Tensor              # (n_particles,) or (n_particles, J) samples of t
    t_mean: torch.Tensor         # posterior mean of t (scalar or (J,))
    t_sd: torch.Tensor           # posterior sd of t (population sd)
    log_evidence: torch.Tensor   # log ∫ p(Y|t)·penalty(t)·lognormal(t) dt estimate
    smc: SmcResult


class TQuadrature(NamedTuple):
    t_mean: torch.Tensor         # exact posterior mean of t, (J,)
    t_sd: torch.Tensor           # exact posterior sd of t, (J,)
    log_evidence: torch.Tensor   # log ∫ p(Y|t)·penalty(t)·lognormal(t) dt
    # the largest normalized weight of the coarse pass over classes: near 1
    # the coarse grid collapsed onto one cell and the refined pass did all
    # the work
    coarse_max_weight: torch.Tensor


def _q0_logpdf(theta: torch.Tensor, mu0: float, s0: float) -> torch.Tensor:
    """The lognormal base prior's density in θ, summed over the last axis."""
    z = (theta - mu0) / s0
    return torch.sum(-0.5 * z * z - math.log(s0) - 0.5 * math.log(2.0 * math.pi), dim=-1)


def _penalty_tilt(t: torch.Tensor, p: float, q: float, tau: float) -> torch.Tensor:
    """The reference's t-penalty as a likelihood tilt, summed over the last
    axis (no Jacobian: the base prior is already a density in θ)."""
    return torch.sum(t_log_prior_density(t, p, q, tau), dim=-1)


def _features(eigenpair: EigenPair, idx, K: int, device):
    """(V at the rows idx, Laplacian eigenvalues) on ``device``; the pair
    must live there."""
    device = resolve_device(device, "the hyperposteriors")
    if not _same_device(eigenpair.vectors.device, device):
        raise ValueError(f"the eigenpair is on {eigenpair.vectors.device}, not on {device}")
    idx = torch.as_tensor(idx, dtype=torch.int64, device=eigenpair.vectors.device)
    return eigenpair.vectors[idx, :K], eigenpair.laplacian_eigenvalues(K)


def _phi(V_idx: torch.Tensor, lam: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Φ = V·diag(exp(−t·λ/2)) for every t: shape t.shape + (m, K)."""
    return V_idx * torch.exp(-0.5 * t[..., None] * lam)[..., None, :]


def _count_evaluation(theta: torch.Tensor) -> None:
    """One likelihood evaluation over the particles θ (P, J): P·J lanes."""
    count("smc_likelihood_evals")
    count("smc_lanes", theta.numel())


def _smc_posterior(generator, log_like, x0, mu0, s0, n_mutation_steps: int,
                   stages_per_dispatch) -> SmcResult:
    def log_prior(theta):
        return _q0_logpdf(theta, mu0, s0)

    kw = dict(n_mutation_steps=n_mutation_steps, mutation="rwm", step_size=0.5)
    if stages_per_dispatch is None:
        return run_smc(generator, log_prior, log_like, x0, **kw)
    return run_smc_chunked(generator, log_prior, log_like, x0,
                           stages_per_dispatch=stages_per_dispatch, **kw)


def gpc_t_posterior(generator: torch.Generator, eigenpair: EigenPair, Y, idx, K: int,
                    sigma: float, *, N=None, n_particles: int = 64, n_mutation_steps: int = 5,
                    p: float = 1e-2, q: float = 10.0, tau: float = 2.0, mu0: float = 2.3,
                    s0: float = 1.5, newton_tol: float = 1e-5, newton_max_iter: int = 100,
                    device=None) -> TPosterior:
    """Tempered-SMC posterior over log t for binary heat-kernel GPC.

    Y: (m,) 0/1 labels (or binomial counts of N trials) at the rows ``idx``
    of the eigenvectors.  Returns samples and moments of t and the log
    evidence.  ``device``: the CUDA device unless the caller names one; the
    eigenpair and the generator must live there."""
    V_idx, lam = _features(eigenpair, idx, K, device)
    dtype, dev = V_idx.dtype, V_idx.device
    m = V_idx.shape[0]
    Y = torch.as_tensor(Y, dtype=dtype, device=dev)
    Nv = (torch.ones((m,), dtype=dtype, device=dev) if N is None
          else torch.as_tensor(N, dtype=dtype, device=dev))

    def log_like(theta):                                  # (P, 1) -> (P,)
        _count_evaluation(theta)
        t = torch.exp(theta)
        mll = gpc_marginal_log_likelihood_lowrank(_phi(V_idx, lam, t[:, 0]), Y, Nv, sigma,
                                                  newton_tol, newton_max_iter)
        return mll + _penalty_tilt(t, p, q, tau)

    x0 = mu0 + s0 * torch.randn((n_particles, 1), generator=generator, dtype=dtype, device=dev)
    smc = _smc_posterior(generator, log_like, x0, mu0, s0, n_mutation_steps, None)
    t = torch.exp(smc.particles[:, 0])
    return TPosterior(t, torch.mean(t), torch.std(t, correction=0), smc.log_evidence, smc)


def mult_t_posterior(generator: torch.Generator, eigenpair: EigenPair, aug_y, idx, K: int,
                     sigma: float, *, n_particles: int = 64, n_mutation_steps: int = 5,
                     p: float = 1e-2, q: float = 10.0, tau: float = 2.0, mu0: float = 2.3,
                     s0: float = 1.5, newton_tol: float = 1e-5, newton_max_iter: int = 100,
                     stages_per_dispatch=None, device=None) -> TPosterior:
    """Joint SMC posterior over per-class log t for one-vs-rest multiclass.

    aug_y: (m, J) one-hot labels (``fit.multiclass.one_hot_labels``).  All
    particles × classes are the lanes of one Newton solve.
    ``stages_per_dispatch``: when set, the ladder runs through
    :func:`run_smc_chunked` (the same bits)."""
    V_idx, lam = _features(eigenpair, idx, K, device)
    dtype, dev = V_idx.dtype, V_idx.device
    aug_y = torch.as_tensor(aug_y, dtype=dtype, device=dev)
    m, J = aug_y.shape
    Nv = torch.ones((m,), dtype=dtype, device=dev)
    Yt = aug_y.T.contiguous()                             # (J, m)

    def log_like(theta):                                  # (P, J) -> (P,)
        _count_evaluation(theta)
        t = torch.exp(theta)
        mll = gpc_marginal_log_likelihood_lowrank(_phi(V_idx, lam, t), Yt, Nv, sigma,
                                                  newton_tol, newton_max_iter)
        return torch.sum(mll, dim=-1) + _penalty_tilt(t, p, q, tau)

    x0 = mu0 + s0 * torch.randn((n_particles, J), generator=generator, dtype=dtype, device=dev)
    smc = _smc_posterior(generator, log_like, x0, mu0, s0, n_mutation_steps,
                         stages_per_dispatch)
    t = torch.exp(smc.particles)
    return TPosterior(t, torch.mean(t, dim=0), torch.std(t, dim=0, correction=0),
                      smc.log_evidence, smc)


def _moments(logw: torch.Tensor, thetas: torch.Tensor):
    """Per-class (log Z, t-mean, t-var, θ-mean, θ-sd, weights) from (J, G)
    log-weights over per-class grids (J, G)."""
    dtheta = thetas[:, 1] - thetas[:, 0]
    lse = torch.logsumexp(logw, dim=1)
    log_z = lse + torch.log(dtheta)
    w = torch.exp(logw - lse[:, None])
    ts = torch.exp(thetas)
    t_mean = torch.sum(w * ts, dim=1)
    t_var = torch.sum(w * (ts - t_mean[:, None]) ** 2, dim=1)
    th_mean = torch.sum(w * thetas, dim=1)
    th_sd = torch.sqrt(torch.sum(w * (thetas - th_mean[:, None]) ** 2, dim=1))
    return log_z, t_mean, t_var, th_mean, th_sd, w


def mult_t_quadrature(eigenpair: EigenPair, aug_y, idx, K: int, sigma: float, *,
                      n_grid: int = 256, half_width_sds: float = 5.0, p: float = 1e-2,
                      q: float = 10.0, tau: float = 2.0, mu0: float = 2.3, s0: float = 1.5,
                      newton_tol: float = 1e-5, newton_max_iter: int = 100,
                      device=None) -> TQuadrature:
    """Exact per-class t-posterior moments by 1-D quadrature over θ = log t:
    the ground truth :func:`mult_t_posterior` is held to.  The prior and tilt
    are the SMC target's own ``_q0_logpdf`` and ``_penalty_tilt``.

    Two passes guard the resolution: the coarse pass spans
    ±``half_width_sds``·s0 around the prior mean; a refined pass re-grids
    each class over its coarse posterior mean ± 8 coarse sd (at least one
    coarse cell), so a posterior narrower than a coarse cell is resolved with
    the full ``n_grid`` budget.  Each pass is one Newton solve over the
    J × n_grid lanes."""
    V_idx, lam = _features(eigenpair, idx, K, device)
    dtype, dev = V_idx.dtype, V_idx.device
    aug_y = torch.as_tensor(aug_y, dtype=dtype, device=dev)
    m, J = aug_y.shape
    Nv = torch.ones((m,), dtype=dtype, device=dev)
    Yt = aug_y.T[:, None, :]                              # (J, 1, m)

    def logw_at(thetas):                                  # (J, G) -> (J, G)
        t = torch.exp(thetas)
        mll = gpc_marginal_log_likelihood_lowrank(_phi(V_idx, lam, t), Yt, Nv, sigma,
                                                  newton_tol, newton_max_iter)
        return (mll + _penalty_tilt(t[..., None], p, q, tau)
                + _q0_logpdf(thetas[..., None], mu0, s0))

    coarse = torch.linspace(mu0 - half_width_sds * s0, mu0 + half_width_sds * s0, n_grid,
                            dtype=dtype, device=dev)
    coarse_j = coarse.expand(J, n_grid)
    _, _, _, th_mean, th_sd, w0 = _moments(logw_at(coarse_j), coarse_j)

    half = torch.clamp(8.0 * th_sd, min=coarse[1] - coarse[0])
    steps = torch.linspace(0.0, 1.0, n_grid, dtype=dtype, device=dev)
    fine_j = (th_mean - half)[:, None] + (2.0 * half)[:, None] * steps[None, :]
    log_z, t_mean, t_var, _, _, _ = _moments(logw_at(fine_j), fine_j)
    return TQuadrature(t_mean, torch.sqrt(t_var), torch.sum(log_z), torch.max(w0))
