"""Adaptive tempered Sequential Monte Carlo with HMC or random-walk mutations.

Particles live on the flattened parameter space of the HMC/NUTS/SVI stack
and are the batch axis of one batched density, ``(n, dim) -> (n,)`` (the
convention of ``models.latent``).  The tempering schedule is chosen
adaptively by bisecting on effective sample size; resampling is systematic.
One ``torch.Generator`` on the particles' device drives every random draw.

Two drivers over ONE stage body, as in ``flgp_tpu.inference.smc``:

- :func:`run_smc` — the whole tempering ladder;
- :func:`run_smc_chunked` — the same ladder in runs of at most
  ``stages_per_dispatch`` stages, the small :class:`SmcState` handed from
  one run to the next (the place to checkpoint it).

Both apply the identical stage body in the identical order, so their results
are the same bits.  A stage makes no host read but the one of β that decides
whether the ladder goes on (``utils.metrics.to_host``, so ``host_syncs``
counts it); the ESS bisection is a fixed 30 steps on device tensors.  The
ladder runs in the recorder's span ``smc`` and counts ``smc_stages``, one a
tempering stage.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils.metrics import count, span, to_host
from .hmc import check_placement, hmc_kernel, init_state

LogProbFn = Callable[[torch.Tensor], torch.Tensor]

ACCEPT_TARGET = {"hmc": 0.65, "rwm": 0.3}
BISECTION_STEPS = 30


class SmcResult(NamedTuple):
    particles: torch.Tensor      # (n_particles, dim) final posterior particles
    log_evidence: torch.Tensor   # log-normalizing-constant estimate
    n_stages: int
    temperatures: torch.Tensor   # (max_stages,) padded with 1.0


class SmcState(NamedTuple):
    """The whole tempering state but the generator's."""

    particles: torch.Tensor
    beta: torch.Tensor
    log_Z: torch.Tensor
    stage: int
    step: torch.Tensor
    temps: torch.Tensor


def _systematic_resample(generator: torch.Generator, log_w: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling indices.  A float32 cumulative sum may end below
    the last position; the index is clamped to n − 1 there (JAX's gather
    clamps it silently, a torch index would fault)."""
    u = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    positions = (u + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return _resample_index(torch.cumsum(torch.softmax(log_w, dim=0), dim=0), positions)


def _resample_index(cum: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.searchsorted(cum, positions), max=cum.shape[0] - 1)


def _ess_from_logw(log_w: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_w, dim=-1)
    return 1.0 / torch.sum(w * w, dim=-1)


def _next_beta(ll: torch.Tensor, beta: torch.Tensor, min_ess: float) -> torch.Tensor:
    """The next temperature: 1 if the incremental ESS allows it, else the
    bisected increment whose incremental ESS meets ``min_ess``."""
    one = torch.ones_like(beta)
    lo, hi = beta, one
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = _ess_from_logw((mid - beta) * ll) >= min_ess
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    full_ok = _ess_from_logw((one - beta) * ll) >= min_ess
    return torch.where(full_ok, one, lo)


def _mutate_hmc(generator, target: LogProbFn, x, step, n_steps: int, n_leapfrog: int):
    state = init_state(target, x)
    ap = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(n_steps):
        state, ap = hmc_kernel(target, generator, state, step, 1.0, n_leapfrog)
    return state.x, ap


def _mutate_rwm(generator, target: LogProbFn, x, lp, step, n_steps: int):
    ap = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(n_steps):
        prop = x + step * torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                      device=x.device)
        lp_prop = target(prop)
        log_u = torch.log(torch.rand(x.shape[:1], generator=generator, dtype=x.dtype,
                                     device=x.device))
        ap = torch.clamp(torch.exp(lp_prop - lp), max=1.0)
        take = log_u < lp_prop - lp
        x = torch.where(take[:, None], prop, x)
        lp = torch.where(take, lp_prop, lp)
    return x, ap


def _stage(generator, log_prior, log_like, st: SmcState, n_mutation_steps: int,
           n_leapfrog: int, target_ess_frac: float, mutation: str) -> SmcState:
    """One tempering stage: pick β by ESS bisection, reweight, resample,
    mutate, and move the step size toward the mutation's target acceptance
    by the acceptance of the last mutation step (the reference's scan
    returns the final step's)."""
    count("smc_stages")
    n = st.particles.shape[0]
    ll = log_like(st.particles)
    beta_new = _next_beta(ll, st.beta, target_ess_frac * n)
    log_w = (beta_new - st.beta) * ll
    log_Z = st.log_Z + torch.logsumexp(log_w, dim=0) - math.log(n)

    idx = _systematic_resample(generator, log_w, n)
    particles = st.particles[idx]

    def target(x):
        return log_prior(x) + beta_new * log_like(x)

    if mutation == "hmc":
        xs, ap = _mutate_hmc(generator, target, particles, st.step, n_mutation_steps, n_leapfrog)
    else:
        # the resampled particles' likelihoods are ll[idx]: no evaluation
        lp = log_prior(particles) + beta_new * ll[idx]
        xs, ap = _mutate_rwm(generator, target, particles, lp, st.step, n_mutation_steps)
    step = st.step * torch.exp(torch.mean(ap) - ACCEPT_TARGET[mutation])
    temps = st.temps.clone()
    temps[st.stage] = beta_new
    return SmcState(xs, beta_new, log_Z, st.stage + 1, step, temps)


def smc_init(x0: torch.Tensor, step_size: float = 0.1, max_stages: int = 50) -> SmcState:
    def scalar(v):                  # a fill on the device: no upload
        return torch.full((), v, dtype=x0.dtype, device=x0.device)

    return SmcState(x0, scalar(0.0), scalar(0.0), 0, scalar(step_size),
                    torch.ones((max_stages,), dtype=x0.dtype, device=x0.device))


def _check_mutation(mutation: str) -> None:
    if mutation not in ACCEPT_TARGET:
        raise ValueError(f"unknown mutation kernel {mutation!r}")


def _run_stages(generator, log_prior, log_like, st: SmcState, limit: int, **kw) -> tuple:
    """Stages from a state with β < 1 while β < 1 and stage < limit: (the
    state, whether β reached 1).  One host read of β a stage, after it."""
    done = False
    while not done and st.stage < limit:
        st = _stage(generator, log_prior, log_like, st, **kw)
        done = to_host(st.beta) >= 1.0
    return st, done


def _result(st: SmcState) -> SmcResult:
    return SmcResult(st.particles, st.log_Z, st.stage, st.temps)


def run_smc(generator: torch.Generator, log_prior: LogProbFn, log_like: LogProbFn,
            x0: torch.Tensor, n_mutation_steps: int = 5, n_leapfrog: int = 8,
            target_ess_frac: float = 0.5, max_stages: int = 50, step_size: float = 0.1,
            mutation: str = "hmc") -> SmcResult:
    """Temper from the prior to prior·likelihood.

    x0: (n_particles, dim) draws from the prior; ``log_prior`` and
    ``log_like`` map (n, dim) to (n,).  Each stage's mutation targets
    log_prior + β·log_like with a shared step size rescaled by the previous
    stage's acceptance.

    mutation: "hmc" (unit inverse mass; ``torch.autograd`` of the tempered
    density) or "rwm" (Gaussian random-walk Metropolis, for likelihoods that
    run through solvers without a gradient, such as the Laplace GPC
    marginal's Newton loop).  The generator and any model must live on x0's
    device."""
    _check_mutation(mutation)
    check_placement(generator, log_like, x0)
    with span("smc"):
        st = smc_init(x0, step_size, max_stages)
        st, _ = _run_stages(generator, log_prior, log_like, st, max_stages,
                            n_mutation_steps=n_mutation_steps, n_leapfrog=n_leapfrog,
                            target_ess_frac=target_ess_frac, mutation=mutation)
        return _result(st)


def run_smc_chunked(generator: torch.Generator, log_prior: LogProbFn, log_like: LogProbFn,
                    x0: torch.Tensor, stages_per_dispatch: int = 4, n_mutation_steps: int = 5,
                    n_leapfrog: int = 8, target_ess_frac: float = 0.5, max_stages: int = 50,
                    step_size: float = 0.1, mutation: str = "hmc") -> SmcResult:
    """The :func:`run_smc` ladder in runs of at most ``stages_per_dispatch``
    stages, each run bounded by ``stage < stage_at_entry +
    stages_per_dispatch`` (and β < 1, read once a stage).  The bound only
    truncates the loop :func:`run_smc` runs, so the stage bodies, and the
    result, are the same bits."""
    _check_mutation(mutation)
    check_placement(generator, log_like, x0)
    kw = dict(n_mutation_steps=n_mutation_steps, n_leapfrog=n_leapfrog,
              target_ess_frac=target_ess_frac, mutation=mutation)
    with span("smc"):
        st, done = smc_init(x0, step_size, max_stages), False
        while not done and st.stage < max_stages:
            st, done = _run_stages(generator, log_prior, log_like, st,
                                   min(st.stage + stages_per_dispatch, max_stages), **kw)
        return _result(st)
