"""ChEES-HMC: cross-chain adaptive trajectory lengths at a fixed batch shape.

Vmapped NUTS runs every chain of a batch to the slowest chain's tree depth;
fixed-trajectory HMC leaves mixing unused because nothing tunes its
trajectory length.  ChEES (Hoffman, Radul & Sountsov, AISTATS 2021) adapts
the length with one jittered leapfrog count per iteration shared by every
chain, so the whole batch integrates in lockstep by construction, as
``flgp_tpu.inference.chees`` runs it:

- the iteration's leapfrog count n_t = ceil(h_t·τ/ε), h_t a base-2 Halton
  point: a host integer, read once per warmup iteration (ε and τ move
  there) and computed for the whole sampling phase at once (ε and τ are
  frozen), so sampling makes no host sync;
- step size by dual averaging on the harmonic-mean acceptance (target
  0.651), trajectory length by Adam ascent on the ChEES criterion gradient,
  the diagonal metric from a bias-corrected EMA of the cross-chain
  interquartile range;
- the criterion maximizes E[(‖x⁺−x̄‖² − ‖x−x̄‖²)²]; its per-iteration
  gradient in the trajectory length, accept-weighted across chains, is
  ĝ = h_t · Σ_c α_c·ΔD_c·⟨x⁺_c − x̄⁺, v⁺_c⟩ / Σ_c α_c with v⁺ = M⁻¹p⁺.

``axis_name``: when the chains are sharded over processes, the chain axis's
``parallel.mesh.Mesh``; every cross-chain mean is then the mean over all
ranks' chains (one all-reduce each), so every rank adapts the same
(ε, τ, M⁻¹) and draws the same leapfrog counts.  The quartiles of the
metric are each rank's own, averaged over the ranks, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import _like, check_placement, da_init, da_update, value_and_grad

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


def halton2(i, dtype=torch.float64) -> torch.Tensor:
    """Base-2 radical inverse (van der Corput / Halton) of integers ≥ 1, the
    low-discrepancy trajectory jitter of the ChEES paper: the 32-bit reversal
    by a 5-stage butterfly, in (0, 1) for i ≥ 1."""
    u = torch.as_tensor(i).to(torch.int64) & 0xFFFFFFFF
    u = ((u & 0x55555555) << 1) | ((u >> 1) & 0x55555555)
    u = ((u & 0x33333333) << 2) | ((u >> 2) & 0x33333333)
    u = ((u & 0x0F0F0F0F) << 4) | ((u >> 4) & 0x0F0F0F0F)
    u = ((u & 0x00FF00FF) << 8) | ((u >> 8) & 0x00FF00FF)
    u = ((u << 16) | (u >> 16)) & 0xFFFFFFFF
    return u.to(dtype) * (1.0 / 4294967296.0)


def _check_axis(axis_name) -> None:
    if axis_name is not None and not (hasattr(axis_name, "psum") and hasattr(axis_name, "size")):
        raise TypeError(f"axis_name must be a parallel.mesh.Mesh or None, got {axis_name!r}")


def _pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The mean over the ranks of the chain axis's mesh (x without one)."""
    return x if axis_name is None else axis_name.psum(x) / axis_name.size


class _BatchState(NamedTuple):
    x: torch.Tensor      # (C, dim)
    logp: torch.Tensor   # (C,)
    grad: torch.Tensor   # (C, dim)


def _batched_leapfrog(vg, st: _BatchState, p, step, inv_mass, n_steps: int):
    """n_steps leapfrog steps of every chain at one shared step size."""
    for _ in range(n_steps):
        p_half = p + 0.5 * step * st.grad
        x_new = st.x + step * inv_mass[None, :] * p_half
        logp, grad = vg(x_new)
        p = p_half + 0.5 * step * grad
        st = _BatchState(x_new, logp, grad)
    return st, p


def _chees_transition(vg, st: _BatchState, p0, u, step, inv_mass, n_steps: int):
    """One batched jittered-HMC transition, shared by warmup and sampling,
    from pre-drawn momenta p0 (C, dim) and uniforms u (C,).  Returns (new
    state, proposal state, final momentum, accept probabilities)."""
    prop, p1 = _batched_leapfrog(vg, st, p0, step, inv_mass, n_steps)
    ke0 = 0.5 * torch.sum(inv_mass[None, :] * p0 * p0, dim=1)
    ke1 = 0.5 * torch.sum(inv_mass[None, :] * p1 * p1, dim=1)
    log_accept = (prop.logp - ke1) - (st.logp - ke0)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             torch.full_like(log_accept, -torch.inf))
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    take = u < accept_prob
    new = _BatchState(torch.where(take[:, None], prop.x, st.x),
                      torch.where(take, prop.logp, st.logp),
                      torch.where(take[:, None], prop.grad, st.grad))
    return new, prop, p1, accept_prob


def _draw(generator, st: _BatchState, inv_mass):
    """Momenta N(0, M) and accept uniforms of every chain."""
    x = st.x
    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype, device=x.device)
    return z / torch.sqrt(inv_mass)[None, :], u


def _chees_grad(st, prop, p1, accept_prob, inv_mass, h, axis_name=None):
    """Accept-weighted ChEES criterion gradient in the trajectory length.

    Divergent proposals (non-finite x⁺ or p⁺, a too-long float32 trajectory
    through a steep region) are excluded by zeroing their accept weight and
    their values: the criterion reads proposals directly, and one NaN chain
    would otherwise poison the cross-chain means and pin τ at NaN."""
    finite = torch.all(torch.isfinite(prop.x), dim=1) & torch.all(torch.isfinite(p1), dim=1)
    zero = torch.zeros((), dtype=st.x.dtype, device=st.x.device)
    a = torch.where(finite, accept_prob.to(st.x.dtype), zero)
    xp = torch.where(finite[:, None], prop.x, zero)
    p1 = torch.where(finite[:, None], p1, zero)
    a_sum = torch.clamp(_pmean(torch.mean(a), axis_name), min=1e-6)
    # centred on cross-chain means: current states plainly, proposals
    # accept-weighted (rejected proposals can sit arbitrarily far out)
    xbar = _pmean(torch.mean(st.x, dim=0), axis_name)
    xbar_p = _pmean(torch.mean(a[:, None] * xp, dim=0), axis_name) / a_sum
    dx = st.x - xbar[None, :]
    dxp = xp - xbar_p[None, :]
    dD = torch.sum(dxp * dxp, dim=1) - torch.sum(dx * dx, dim=1)
    v1 = inv_mass[None, :] * p1
    per_chain = dD * torch.sum(dxp * v1, dim=1)
    g = h * _pmean(torch.mean(a * per_chain), axis_name) / a_sum
    return torch.where(torch.isfinite(g), g, zero)


class CheesRun(NamedTuple):
    samples: torch.Tensor       # (n_samples, C, dim)
    accept_prob: torch.Tensor   # (n_samples, C)
    step: torch.Tensor          # () shared adapted step size
    traj_len: torch.Tensor      # () shared adapted trajectory length τ
    inv_mass: torch.Tensor      # (dim,) shared adapted diagonal inverse mass
    n_leapfrog_total: int       # leapfrog steps of the sampling phase


def _n_steps(h, step, traj_len, max_steps: int) -> torch.Tensor:
    """clip(ceil(h·τ/ε), 1, max_steps) on the device, as int64; a NaN counts 1."""
    n = torch.nan_to_num(torch.ceil(h * traj_len / step), nan=1.0)
    return torch.clamp(n, 1, max_steps).to(torch.int64)


def run_chees(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor,
              n_warmup: int = 500, n_samples: int = 1000, target_accept: float = 0.651,
              init_step: float = 0.1, init_traj_len: float = 1.0, max_steps: int = 256,
              adam_lr: float = 0.025, axis_name=None,
              inv_mass0: Optional[torch.Tensor] = None,
              on_warmup_end: Optional[Callable[[], None]] = None) -> CheesRun:
    """Adaptive ChEES-HMC on a batch of chains (x0: (C, dim)).

    Warmup makes exactly ``n_warmup`` transitions and jointly adapts
    (ε, τ, M⁻¹) from cross-chain statistics; dual averaging restarts from the
    current step after the first 60% of them (its average otherwise still
    carries the early find-the-scale transient); sampling runs at the frozen
    triple with Halton-jittered trajectory lengths.  ``inv_mass0`` (dim,)
    seeds the metric (``models.latent.whitened_inv_mass0``).
    ``on_warmup_end`` is called between warmup and sampling.  ``axis_name``:
    the chain axis's mesh when the chains are sharded over processes."""
    _check_axis(axis_name)
    check_placement(generator, logprob, x0)
    C, dim = x0.shape
    dtype, dev = x0.dtype, x0.device
    vg = value_and_grad(logprob)
    st = _BatchState(x0, *vg(x0))

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    da = da_init(scalar(init_step))
    ema_decay = 0.95
    log_tau = torch.log(scalar(init_traj_len))
    adam_m = scalar(0.0)
    adam_v = scalar(0.0)
    ema_v = torch.zeros((dim,), dtype=dtype, device=dev)
    n_updates = 0
    inv_mass = (torch.ones((dim,), dtype=dtype, device=dev) if inv_mass0 is None
                else _like(inv_mass0, x0, (dim,), "inv_mass0").clone())
    # metric updates start after the init buffer: before it the chains still
    # huddle around x0 and their spread would collapse the metric
    init_buffer = max(int(0.15 * n_warmup), 1)
    quartiles = torch.tensor([0.25, 0.75], dtype=dtype, device=dev)
    log_max_steps = math.log(float(max_steps))
    n1 = int(0.6 * n_warmup)
    b1, b2 = 0.9, 0.999
    for t in range(n_warmup):
        if t == n1 and n1 > 0:
            da = da_init(torch.exp(da.log_step))
        step = torch.exp(da.log_step)
        tau = torch.exp(log_tau)
        h = halton2(t + 1, dtype).to(dev)
        n_steps = int(_n_steps(h, step, tau, max_steps))          # the iteration's host read
        p0, u = _draw(generator, st, inv_mass)
        new, prop, p1, ap = _chees_transition(vg, st, p0, u, step, inv_mass, n_steps)
        # harmonic-mean acceptance punishes stragglers, which keeps the shared
        # step honest across many chains; the 0.05 floor bounds one diverged
        # chain's weight to 20x a typical one's
        hmean = 1.0 / torch.clamp(
            _pmean(torch.mean(1.0 / torch.clamp(ap, min=0.05)), axis_name), min=1e-6)
        da_next = da_update(da, hmean, target_accept)

        # ChEES gradient, Adam ascent on log τ, τ kept in [ε, max_steps·ε]
        g = _chees_grad(st, prop, p1, ap, inv_mass, h, axis_name) * tau
        adam_m = b1 * adam_m + (1 - b1) * g
        adam_v = b2 * adam_v + (1 - b2) * g * g
        mhat = adam_m / (1 - b1 ** (t + 1))
        vhat = adam_v / (1 - b2 ** (t + 1))
        log_tau = log_tau + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        log_tau = torch.minimum(torch.maximum(log_tau, da.log_step), da.log_step + log_max_steps)

        # metric from a robust cross-chain dispersion, the interquartile range
        # as a variance ((q75 − q25)/1.349)², EMA-smoothed and bias-corrected:
        # a few chains stuck far out in the burn-in transit inflate a plain
        # cross-chain variance many times and wedge the warmup at a tiny step
        if t >= init_buffer:
            q25, q75 = torch.quantile(new.x, quartiles, dim=0)
            v_rob = _pmean(((q75 - q25) / 1.349) ** 2, axis_name)
            ema_v = ema_decay * ema_v + (1 - ema_decay) * v_rob
            n_updates += 1
            if n_updates > 3:
                corr = max(1.0 - ema_decay ** n_updates, 1e-6)
                inv_mass = ema_v / corr + 1e-6
        da = da_next
        st = new
    step = torch.exp(da.log_step_avg)
    traj_len = torch.exp(log_tau)
    if on_warmup_end is not None:
        on_warmup_end()
    return _run_fixed_from(generator, vg, st, step, traj_len, inv_mass, n_samples, max_steps)


def _run_fixed_from(generator, vg, st: _BatchState, step, traj_len, inv_mass, n_samples: int,
                    max_steps: int) -> CheesRun:
    x = st.x
    C, dim = x.shape
    h = halton2(torch.arange(1, n_samples + 1), x.dtype).to(x.device)
    schedule = _n_steps(h, step, traj_len, max_steps).tolist()    # one host read
    draws = x.new_empty((n_samples, C, dim))
    aps = x.new_empty((n_samples, C))
    for t, n_steps in enumerate(schedule):
        p0, u = _draw(generator, st, inv_mass)
        st, _, _, ap = _chees_transition(vg, st, p0, u, step, inv_mass, n_steps)
        draws[t] = st.x
        aps[t] = ap
    return CheesRun(draws, aps, step, traj_len, inv_mass, int(sum(schedule)))


def run_chees_fixed(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor, step,
                    traj_len, inv_mass, n_samples: int = 1000, max_steps: int = 256,
                    axis_name=None) -> CheesRun:
    """Steady-state ChEES sampling at a frozen (ε, τ, M⁻¹) from a prior
    :func:`run_chees`: tile the adapted scalars over any chain count and every
    iteration stays one batched leapfrog.  x0 (C, dim); step and traj_len
    scalars; inv_mass (dim,).  ``axis_name`` is accepted for the signature
    of the JAX package: sampling at a frozen triple has no cross-chain
    statistic."""
    _check_axis(axis_name)
    check_placement(generator, logprob, x0)
    vg = value_and_grad(logprob)
    dim = x0.shape[1]
    return _run_fixed_from(generator, vg, _BatchState(x0, *vg(x0)), _like(step, x0, (), "step"),
                           _like(traj_len, x0, (), "traj_len"),
                           _like(inv_mass, x0, (dim,), "inv_mass"), n_samples, max_steps)
