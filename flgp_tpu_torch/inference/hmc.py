"""Hamiltonian Monte Carlo with dual-averaging and mass adaptation.

Leapfrog HMC over a differentiable log posterior (the whitened spectral GP
models of ``models.latent``), as ``flgp_tpu.inference.hmc`` runs it.  The
JAX package writes one chain and vmaps it; here every function is batched
over chains by construction: the state is (C, dim), the step size (C,), the
diagonal inverse mass (C, dim), the dual-averaging state (C,) a field, and
an accept is a mask.  An HMC transition makes no host sync (its leapfrog
count is a Python int), so it could be captured as a CUDA graph.

Warmup follows the Stan schedule: dual-averaging step size (Nesterov 2009 /
Hoffman & Gelman 2014) plus windowed diagonal mass-matrix estimation.  Every
random draw comes from the ``torch.Generator`` the caller passes, which must
live on the chains' device, as must the model.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..models.latent import _same_device

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


class HmcState(NamedTuple):
    x: torch.Tensor       # (C, dim)
    logp: torch.Tensor    # (C,)
    grad: torch.Tensor    # (C, dim)


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor        # (C,) each
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def value_and_grad(logprob: LogProbFn):
    """x (C, dim) -> (log density (C,), gradient (C, dim)): the model's own
    analytic gradient when it has one, else ``torch.autograd`` of the sum of
    the batched density."""
    analytic = getattr(logprob, "value_and_grad", None)
    if analytic is not None:
        return analytic

    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            lp = logprob(xg)
            (grad,) = torch.autograd.grad(lp.sum(), xg)
        return lp.detach(), grad

    return vg


def check_placement(generator: torch.Generator, logprob, x0: torch.Tensor) -> None:
    """Raise unless the generator and the model live on the chains' device;
    nothing is moved."""
    if not _same_device(generator.device, x0.device):
        raise ValueError(f"generator is on {generator.device}, the chains on {x0.device}")
    model_device = getattr(logprob, "device", None)
    if model_device is not None and not _same_device(model_device, x0.device):
        raise ValueError(f"the model is on {model_device}, the chains on {x0.device}")


def _like(a, x: torch.Tensor, shape, name: str) -> torch.Tensor:
    """``a`` (a number, an array or a tensor on x's device) broadcast to
    ``shape`` in x's dtype."""
    if isinstance(a, torch.Tensor) and not _same_device(a.device, x.device):
        raise ValueError(f"{name} is on {a.device}, the chains on {x.device}")
    return torch.as_tensor(a, dtype=x.dtype, device=x.device).expand(shape)


def init_state(logprob: LogProbFn, x0: torch.Tensor) -> HmcState:
    logp, grad = value_and_grad(logprob)(x0)
    return HmcState(x0, logp, grad)


def _leapfrog(vg, state: HmcState, p, step, inv_mass, n_steps: int):
    h = step[:, None]
    x, logp, grad = state
    for _ in range(n_steps):
        p_half = p + 0.5 * h * grad
        x = x + h * inv_mass * p_half
        logp, grad = vg(x)
        p = p_half + 0.5 * h * grad
    return HmcState(x, logp, grad), p


def leapfrog(logprob: LogProbFn, state: HmcState, p: torch.Tensor, step, inv_mass,
             n_steps: int) -> Tuple[HmcState, torch.Tensor]:
    """n_steps leapfrog steps (velocity Verlet) of every chain; step (C,) or
    a scalar, inv_mass (C, dim) or (dim,)."""
    C, dim = state.x.shape
    return _leapfrog(value_and_grad(logprob), state, p, _like(step, state.x, (C,), "step"),
                     _like(inv_mass, state.x, (C, dim), "inv_mass"), n_steps)


def _hmc_transition(vg, state: HmcState, p0, u, step, inv_mass, n_steps: int):
    """One HMC transition from pre-drawn momenta p0 (C, dim) and uniforms
    u (C,): (state, acceptance probability (C,))."""
    new, p1 = _leapfrog(vg, state, p0, step, inv_mass, n_steps)
    ke0 = 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    ke1 = 0.5 * torch.sum(inv_mass * p1 * p1, dim=-1)
    log_accept = (new.logp - ke1) - (state.logp - ke0)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             torch.full_like(log_accept, -torch.inf))
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    take = u < accept_prob
    out = HmcState(torch.where(take[:, None], new.x, state.x),
                   torch.where(take, new.logp, state.logp),
                   torch.where(take[:, None], new.grad, state.grad))
    return out, accept_prob


def hmc_kernel(logprob: LogProbFn, generator: torch.Generator, state: HmcState, step, inv_mass,
               n_steps: int) -> Tuple[HmcState, torch.Tensor]:
    """One HMC transition of every chain; returns (state, acceptance
    probability (C,))."""
    x = state.x
    C, dim = x.shape
    step = _like(step, x, (C,), "step")
    inv_mass = _like(inv_mass, x, (C, dim), "inv_mass")
    z = torch.randn((C, dim), generator=generator, dtype=x.dtype, device=x.device)
    u = torch.rand((C,), generator=generator, dtype=x.dtype, device=x.device)
    return _hmc_transition(value_and_grad(logprob), state, z / torch.sqrt(inv_mass), u, step,
                           inv_mass, n_steps)


def da_init(step0: torch.Tensor) -> DualAveragingState:
    log_step = torch.log(step0)
    return DualAveragingState(log_step, log_step, torch.zeros_like(step0), torch.log(10.0 * step0),
                              torch.zeros_like(step0))


def da_update(da: DualAveragingState, accept_prob: torch.Tensor, target: float = 0.8
              ) -> DualAveragingState:
    """Nesterov dual-averaging step-size update (NUTS paper, Alg 5)."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = da.count + 1.0
    eta_h = 1.0 / (count + t0)
    h_sum = (1.0 - eta_h) * da.h_sum + eta_h * (target - accept_prob)
    log_step = da.mu - torch.sqrt(count) / gamma * h_sum
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * da.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_sum, da.mu, count)


class HmcRun(NamedTuple):
    samples: torch.Tensor        # (n_samples, n_chains, dim)
    accept_prob: torch.Tensor    # (n_samples, n_chains)
    step: torch.Tensor           # (n_chains,)
    inv_mass: torch.Tensor       # (n_chains, dim)


def stan_windows(n_warmup: int, init_frac: float = 0.15, term_frac: float = 0.10,
                 base: int = 25):
    """Stan's warmup schedule: a fast init buffer (step size only), expanding
    slow windows (metric estimation), and a fast terminal buffer.  The last
    slow window absorbs the remainder when the next doubling would not fit."""
    init_b = max(int(n_warmup * init_frac), 1)
    term_b = max(int(n_warmup * term_frac), 1)
    middle = n_warmup - init_b - term_b
    if middle < base:
        return init_b, ([middle] if middle > 0 else []), term_b
    wins = []
    rem, w = middle, base
    while rem > 0:
        cur = rem if 2 * w >= rem else w
        wins.append(cur)
        rem -= cur
        w *= 2
    return init_b, wins, term_b


def windowed_warmup(kernel, logprob: LogProbFn, generator: torch.Generator, state: HmcState,
                    n_warmup: int, target_accept: float, dtype,
                    inv_mass0: Optional[torch.Tensor] = None):
    """Stan-style windowed warmup of every chain.

    ``kernel(generator, state, step, inv_mass) -> (state, accept_stat)`` is
    the transition (HMC or NUTS).  After every slow window each chain's
    diagonal inverse mass is re-estimated from that window's draws
    (regularized, Stan-style) and dual averaging restarts from a fresh
    reasonable step under the new metric, so the final averaged step matches
    the final metric.  The last segment runs at a fixed step and corrects it
    in closed form through the Gaussian energy-error model
    accept = 2Φ(−√(ΔH/2)), ΔH ∝ ε⁴ (Neal 2011 §5.2):
    ε* = ε·√(Φ⁻¹(a*/2)/Φ⁻¹(â/2)), which removes dual averaging's short-buffer
    bias toward small steps.  ``inv_mass0`` (dim,) or (C, dim) seeds the
    metric (default ones).  Returns (state, step (C,), inv_mass (C, dim))."""
    x = state.x
    C, dim = x.shape
    inv_mass = (torch.ones((C, dim), dtype=dtype, device=x.device) if inv_mass0 is None
                else _like(inv_mass0, x, (C, dim), "inv_mass0").to(dtype))
    da = da_init(_find_reasonable_step(logprob, state, inv_mass, generator, dtype))
    calib = min(32, max(n_warmup // 8, 1))
    init_b, wins, term_b = stan_windows(n_warmup - calib)

    def adapt_seg(state, da, length, keep):
        draws = []
        for _ in range(length):
            state, ap = kernel(generator, state, torch.exp(da.log_step), inv_mass)
            da = da_update(da, ap, target_accept)
            if keep:
                draws.append(state.x)
        return state, da, draws

    if init_b:
        state, da, _ = adapt_seg(state, da, init_b, False)
    for wlen in wins:
        state, da, draws = adapt_seg(state, da, wlen, True)
        var = torch.var(torch.stack(draws), dim=0, correction=0)
        inv_mass = (wlen / (wlen + 5.0)) * var + 1e-3 * (5.0 / (wlen + 5.0))
        da = da_init(_find_reasonable_step(logprob, state, inv_mass, generator, dtype))
    if term_b:
        state, da, _ = adapt_seg(state, da, term_b, False)
    step = torch.exp(da.log_step_avg)

    # fixed-step calibration segment + closed-form bias correction
    aps = []
    for _ in range(calib):
        state, ap = kernel(generator, state, step, inv_mass)
        aps.append(ap)
    a_hat = torch.clamp(torch.mean(torch.stack(aps), dim=0), 0.05, 0.99)
    target = torch.full_like(a_hat, target_accept)
    ratio = torch.special.ndtri(target / 2.0) / torch.special.ndtri(a_hat / 2.0)
    step = step * torch.clamp(torch.sqrt(ratio), 0.5, 2.0)
    return state, step, inv_mass


def _find_reasonable_step(logprob, state: HmcState, inv_mass, generator, dtype) -> torch.Tensor:
    """Coarse initial step of every chain: double or halve until the
    one-leapfrog acceptance crosses 0.5 (NUTS paper Alg 4), each chain
    stopping at its own crossing, at most 20 rounds; (C,)."""
    C = state.x.shape[0]

    def accept_at(step):
        return hmc_kernel(logprob, generator, state, step, inv_mass, 1)[1]

    step = torch.ones((C,), dtype=dtype, device=state.x.device)
    ap = accept_at(step)
    direction = torch.where(ap > 0.5, 1.0, -1.0).to(dtype)
    active = torch.ones((C,), dtype=torch.bool, device=step.device)
    for _ in range(20):
        crossed = torch.where(direction > 0, ap < 0.5, ap > 0.5)
        active = active & ~crossed
        if not bool(active.any()):
            break
        step_new = step * torch.exp2(direction)
        ap_new = accept_at(step_new)
        step = torch.where(active, step_new, step)
        ap = torch.where(active, ap_new, ap)
    return step


def _sample(logprob, generator, state: HmcState, step, inv_mass, n_samples: int,
            n_leapfrog: int, jitter_steps: bool):
    """n_samples fixed-parameter transitions: draws (n_samples, C, dim) and
    accept probabilities (n_samples, C), written in place, no host sync."""
    x = state.x
    C, dim = x.shape
    draws = x.new_empty((n_samples, C, dim))
    aps = x.new_empty((n_samples, C))
    for i in range(n_samples):
        scale = 1.0
        if jitter_steps:
            # uniform step-size jitter in [0.8, 1) breaks periodic-orbit
            # resonance and keeps the trajectory's leapfrog count fixed
            scale = 0.8 + 0.2 * torch.rand((C,), generator=generator, dtype=x.dtype,
                                           device=x.device)
        state, ap = hmc_kernel(logprob, generator, state, step * scale, inv_mass, n_leapfrog)
        draws[i] = state.x
        aps[i] = ap
    return draws, aps


def run_hmc(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor,
            n_warmup: int = 500, n_samples: int = 1000, n_leapfrog: int = 16,
            target_accept: float = 0.8, jitter_steps: bool = True,
            inv_mass0: Optional[torch.Tensor] = None,
            on_warmup_end: Optional[Callable[[], None]] = None) -> HmcRun:
    """Adaptive HMC for a batch of chains, x0 (n_chains, dim).

    Warmup adapts each chain's step size (dual averaging) and diagonal
    inverse mass (:func:`windowed_warmup`); ``inv_mass0`` (dim,) seeds the
    metric.  ``on_warmup_end``, if given, is called between warmup and
    sampling (a timer's hook).  The generator and the model must live on
    x0's device."""
    check_placement(generator, logprob, x0)
    state = init_state(logprob, x0)

    def kernel(g, st, step, im):
        return hmc_kernel(logprob, g, st, step, im, n_leapfrog)

    state, step, inv_mass = windowed_warmup(kernel, logprob, generator, state, n_warmup,
                                            target_accept, x0.dtype, inv_mass0)
    if on_warmup_end is not None:
        on_warmup_end()
    draws, aps = _sample(logprob, generator, state, step, inv_mass, n_samples, n_leapfrog,
                         jitter_steps)
    return HmcRun(draws, aps, step, inv_mass)


def run_hmc_fixed(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor, step,
                  inv_mass, n_samples: int = 1000, n_leapfrog: int = 16,
                  jitter_steps: bool = True) -> HmcRun:
    """Steady-state sampling with a fixed per-chain (step, inv_mass), e.g.
    the adapted values of a prior :func:`run_hmc`: the sampling phase alone,
    whose ESS/s is what a long production chain converges to.
    x0 (n_chains, dim); step (n_chains,); inv_mass (n_chains, dim)."""
    check_placement(generator, logprob, x0)
    C, dim = x0.shape
    step = _like(step, x0, (C,), "step")
    inv_mass = _like(inv_mass, x0, (C, dim), "inv_mass")
    draws, aps = _sample(logprob, generator, init_state(logprob, x0), step, inv_mass, n_samples,
                         n_leapfrog, jitter_steps)
    return HmcRun(draws, aps, step, inv_mass)
