"""No-U-Turn sampler, iterative and batched over chains in lockstep.

Recursion-free NUTS with multinomial trajectory sampling (Betancourt 2017)
and the O(log depth) checkpoint scheme for sub-tree U-turn checks (Phan &
Pradhan, numpyro's iterative algorithm), as ``flgp_tpu.inference.nuts``
runs it.  XLA runs the JAX package's vmapped ``while_loop``s in lockstep
until every lane is done; here that lockstep is written out.  Each chain
carries an ``active`` mask; all active chains sit at the same tree depth and
the same leaf index, so the leaf's checkpoint slots (popcount and trailing
ones of the leaf index) are host integers shared by the batch.  Every
chain's direction, multinomial proposal (log-space weights), checkpoint
stacks (C, max_depth + 1, dim), divergence and U-turn flags are its own, and
its leapfrog count is its own steps, not the lockstep count.  The host asks
``any()`` once per doubling and once per leaf after a subtree's first;
:data:`STATS` counts those syncs and the lockstep leaves.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.metrics import CounterView, count, to_host
from .hmc import (
    HmcState,
    _like,
    check_placement,
    init_state,
    value_and_grad,
    windowed_warmup,
)

LogProbFn = Callable[[torch.Tensor], torch.Tensor]

# host syncs (``any()`` reads), lockstep leaves (leapfrog steps of the whole
# batch) and transitions since the last reset_stats(): a view of the counters
# ``nuts:<name>`` of the recorder's store
STATS = CounterView("nuts:", ("host_syncs", "lockstep_leaves", "transitions"))


def reset_stats() -> None:
    STATS.reset()


def _any(mask: torch.Tensor) -> bool:
    count("nuts:host_syncs")
    return to_host(mask.any())


class _Phase(NamedTuple):
    """Full phase-space point of every chain."""

    x: torch.Tensor       # (C, dim)
    p: torch.Tensor       # (C, dim)
    logp: torch.Tensor    # (C,)
    grad: torch.Tensor    # (C, dim)


def _select(mask: torch.Tensor, a: NamedTuple, b: NamedTuple):
    """Chain by chain, ``a`` where ``mask`` else ``b``."""
    return type(a)(*(torch.where(mask.view((-1,) + (1,) * (x.ndim - 1)), x, y)
                     for x, y in zip(a, b)))


def _leapfrog1(vg, ph: _Phase, step, inv_mass) -> _Phase:
    h = step[:, None]
    p_half = ph.p + 0.5 * h * ph.grad
    x_new = ph.x + h * inv_mass * p_half
    logp, grad = vg(x_new)
    p_new = p_half + 0.5 * h * grad
    return _Phase(x_new, p_new, logp, grad)


def _energy(ph: _Phase, inv_mass) -> torch.Tensor:
    return -ph.logp + 0.5 * torch.sum(inv_mass * ph.p * ph.p, dim=-1)


def _is_turning(p_sharp_left, p_sharp_right, p_sum) -> torch.Tensor:
    """Generalized U-turn criterion on the momentum sum, over the last axis."""
    return (torch.sum(p_sharp_left * p_sum, dim=-1) <= 0) | (
        torch.sum(p_sharp_right * p_sum, dim=-1) <= 0)


def _popcount(v: int) -> int:
    return bin(v).count("1")


def _trailing_ones(v: int) -> int:
    n = 0
    while v & 1:
        v >>= 1
        n += 1
    return n


class _Subtree(NamedTuple):
    frontier: _Phase
    prop: HmcState
    p_sum: torch.Tensor
    log_weight: torch.Tensor
    sum_accept: torch.Tensor
    n_steps: torch.Tensor
    invalid: torch.Tensor


def _build_subtree(vg, generator, frontier: _Phase, step, inv_mass, h0, n_leaves: int,
                   active: torch.Tensor, ckpt_p, ckpt_psum) -> _Subtree:
    """Integrate up to n_leaves leaves from each active chain's frontier
    (``step`` signed by the chain's direction), each chain stopping at its
    own divergence or U-turn."""
    x = frontier.x
    C = x.shape[0]
    dtype, dev = x.dtype, x.device
    prop = HmcState(torch.zeros_like(x), torch.full((C,), -torch.inf, dtype=dtype, device=dev),
                    torch.zeros_like(x))
    p_sum = torch.zeros_like(x)
    log_weight = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
    sum_accept = torch.zeros((C,), dtype=dtype, device=dev)
    n_steps = torch.zeros((C,), dtype=torch.int64, device=dev)
    diverged = torch.zeros((C,), dtype=torch.bool, device=dev)
    turning = torch.zeros_like(diverged)
    live = active
    for i in range(n_leaves):
        if i > 0 and not _any(live):
            break
        count("nuts:lockstep_leaves")
        ph = _leapfrog1(vg, frontier, step, inv_mass)
        log_w = h0 - _energy(ph, inv_mass)
        finite = torch.isfinite(log_w)
        div = ~finite | (log_w < -1000.0)
        # a NaN-energy leaf counts as accept 0, not a poisoned sum (Stan's
        # convention for divergent leaves)
        accept = torch.where(finite, torch.clamp(torch.exp(torch.clamp(log_w, max=0.0)), max=1.0),
                             torch.zeros_like(log_w))

        # multinomial proposal update within the subtree
        new_logw = torch.logaddexp(log_weight, log_w)
        u = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        take = live & (torch.log(u) < log_w - new_logw)
        prop = _select(take, HmcState(ph.x, ph.logp, ph.grad), prop)
        p_sum_new = p_sum + ph.p

        # checkpoints: leaf i's slots end at popcount(i >> 1); an even leaf
        # stores its momentum and the momentum sum before it, an odd leaf
        # closes one subtree per trailing 1-bit of i and checks each
        idx_max = _popcount(i >> 1)
        if i % 2 == 0:
            ckpt_p[:, idx_max] = torch.where(live[:, None], ph.p, ckpt_p[:, idx_max])
            ckpt_psum[:, idx_max] = torch.where(live[:, None], p_sum_new - ph.p,
                                                ckpt_psum[:, idx_max])
            turn = torch.zeros_like(live)
        else:
            lo = idx_max - _trailing_ones(i) + 1
            span = p_sum_new[:, None, :] - ckpt_psum[:, lo:idx_max + 1]
            turn = torch.any(_is_turning(inv_mass[:, None, :] * ckpt_p[:, lo:idx_max + 1],
                                         (inv_mass * ph.p)[:, None, :], span), dim=1)

        frontier = _select(live, ph, frontier)
        p_sum = torch.where(live[:, None], p_sum_new, p_sum)
        log_weight = torch.where(live, new_logw, log_weight)
        sum_accept = torch.where(live, sum_accept + accept, sum_accept)
        n_steps = n_steps + live
        diverged = diverged | (live & div)
        turning = turning | (live & turn)
        live = live & ~(div | turn)
    return _Subtree(frontier, prop, p_sum, log_weight, sum_accept, n_steps, diverged | turning)


def _nuts_transition(vg, generator, state: HmcState, p0, step, inv_mass, max_depth: int):
    """One NUTS transition of every chain from pre-drawn momenta p0."""
    x = state.x
    C, dim = x.shape
    dtype, dev = x.dtype, x.device
    count("nuts:transitions")
    start = _Phase(x, p0, state.logp, state.grad)
    h0 = _energy(start, inv_mass)
    left = right = start
    prop = state
    p_sum = p0
    log_weight = torch.zeros((C,), dtype=dtype, device=dev)
    sum_accept = torch.zeros((C,), dtype=dtype, device=dev)
    n_steps = torch.zeros((C,), dtype=torch.int64, device=dev)
    active = torch.ones((C,), dtype=torch.bool, device=dev)
    ckpt_p = x.new_zeros((C, max_depth + 1, dim))
    ckpt_psum = x.new_zeros((C, max_depth + 1, dim))
    for depth in range(max_depth):
        if depth > 0 and not _any(active):
            break
        go_right = torch.rand((C,), generator=generator, dtype=dtype, device=dev) < 0.5
        direction = torch.where(go_right, 1.0, -1.0).to(dtype)
        sub = _build_subtree(vg, generator, _select(go_right, right, left), direction * step,
                             inv_mass, h0, 1 << depth, active, ckpt_p, ckpt_psum)

        # biased progressive sampling: take the new subtree's proposal with
        # probability min(1, w_new / w_old)
        u = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        take = active & ~sub.invalid & (torch.log(u) < sub.log_weight - log_weight)
        prop = _select(take, sub.prop, prop)

        left = _select(active & ~go_right, sub.frontier, left)
        right = _select(active & go_right, sub.frontier, right)
        p_sum_new = p_sum + sub.p_sum
        turning_total = _is_turning(inv_mass * left.p, inv_mass * right.p, p_sum_new)
        merged = torch.logaddexp(log_weight, torch.where(sub.invalid, -torch.inf, sub.log_weight))
        log_weight = torch.where(active, merged, log_weight)
        p_sum = torch.where(active[:, None], p_sum_new, p_sum)
        sum_accept = torch.where(active, sum_accept + sub.sum_accept, sum_accept)
        n_steps = n_steps + sub.n_steps
        active = active & ~(sub.invalid | turning_total)
    accept_stat = sum_accept / torch.clamp(n_steps.to(dtype), min=1.0)
    return prop, (accept_stat, n_steps)


def nuts_kernel(logprob: LogProbFn, generator: torch.Generator, state: HmcState, step, inv_mass,
                max_depth: int = 8) -> Tuple[HmcState, Tuple[torch.Tensor, torch.Tensor]]:
    """One NUTS transition of every chain.  Returns (new state, (mean
    acceptance statistic (C,), leapfrog steps (C,) int64)); the proposal
    carries the gradient of the leaf it came from, so no gradient is
    evaluated again.

    Iterative doubling: the direction is drawn per chain per doubling; the
    new subtree of 2^depth leaves is integrated leaf by leaf with
    checkpointed U-turn checks at power-of-two boundaries."""
    x = state.x
    C, dim = x.shape
    step = _like(step, x, (C,), "step")
    inv_mass = _like(inv_mass, x, (C, dim), "inv_mass")
    z = torch.randn((C, dim), generator=generator, dtype=x.dtype, device=x.device)
    return _nuts_transition(value_and_grad(logprob), generator, state, z / torch.sqrt(inv_mass),
                            step, inv_mass, max_depth)


class NutsRun(NamedTuple):
    samples: torch.Tensor
    accept_stat: torch.Tensor
    step: torch.Tensor
    inv_mass: torch.Tensor
    # (n_samples, n_chains) leapfrog steps per transition, the chain's own:
    # the gradient count for ESS-per-gradient metrics and dispatch budgets
    n_leapfrog: torch.Tensor


def _sample(logprob, generator, state, step, inv_mass, n_samples: int, max_depth: int):
    x = state.x
    C, dim = x.shape
    draws = x.new_empty((n_samples, C, dim))
    aps = x.new_empty((n_samples, C))
    nss = torch.empty((n_samples, C), dtype=torch.int64, device=x.device)
    for i in range(n_samples):
        state, (ap, ns) = nuts_kernel(logprob, generator, state, step, inv_mass, max_depth)
        draws[i] = state.x
        aps[i] = ap
        nss[i] = ns
    return draws, aps, nss


def run_nuts(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor,
             n_warmup: int = 500, n_samples: int = 1000, max_depth: int = 8,
             target_accept: float = 0.8, inv_mass0: Optional[torch.Tensor] = None,
             on_warmup_end: Optional[Callable[[], None]] = None) -> NutsRun:
    """Adaptive NUTS for a batch of chains (x0: (n_chains, dim)), with the
    windowed warmup of ``hmc.windowed_warmup``; ``inv_mass0`` (dim,) seeds
    the metric.  ``on_warmup_end`` is called between warmup and sampling."""
    check_placement(generator, logprob, x0)
    state = init_state(logprob, x0)

    def kernel(g, st, step, im):
        st, (ap, _) = nuts_kernel(logprob, g, st, step, im, max_depth)
        return st, ap

    state, step, inv_mass = windowed_warmup(kernel, logprob, generator, state, n_warmup,
                                            target_accept, x0.dtype, inv_mass0)
    if on_warmup_end is not None:
        on_warmup_end()
    draws, aps, nss = _sample(logprob, generator, state, step, inv_mass, n_samples, max_depth)
    return NutsRun(draws, aps, step, inv_mass, nss)


def run_nuts_fixed(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor, step,
                   inv_mass, n_samples: int = 1000, max_depth: int = 8) -> NutsRun:
    """Steady-state NUTS with a fixed per-chain (step, inv_mass) from a prior
    adaptive run: the sampling phase alone (see ``hmc.run_hmc_fixed``)."""
    check_placement(generator, logprob, x0)
    C, dim = x0.shape
    step = _like(step, x0, (C,), "step")
    inv_mass = _like(inv_mass, x0, (C, dim), "inv_mass")
    draws, aps, nss = _sample(logprob, generator, init_state(logprob, x0), step, inv_mass,
                              n_samples, max_depth)
    return NutsRun(draws, aps, step, inv_mass, nss)


def _synchronize(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def run_nuts_fixed_chunked(generator: torch.Generator, logprob: LogProbFn, x0: torch.Tensor,
                           step, inv_mass, n_samples: int = 1000, max_depth: int = 8,
                           max_dispatch_seconds: float = 20.0, calibration_draws: int = 4
                           ) -> NutsRun:
    """Steady-state NUTS in dispatches of bounded worst-case wall.

    A wide batch whose chains run deep trees in lockstep can outlast an
    executor's watchdog; the budget that matters is sequential leapfrog
    steps × the wall of one.  This driver (a) runs ``calibration_draws``
    draws untimed (the first call's cuBLAS and allocator set-up stays out of
    the calibration), (b) times as many more and turns their lockstep step
    count (per draw, the slowest chain's tree) into seconds per sequential
    step, (c) sizes every later dispatch so that its worst case, every tree
    full (2^max_depth − 1 steps a draw), stays under ``max_dispatch_seconds``,
    and carries only the chain states across dispatches.  One generator
    drives every dispatch in turn."""
    check_placement(generator, logprob, x0)
    C, dim = x0.shape
    step = _like(step, x0, (C,), "step")
    inv_mass = _like(inv_mass, x0, (C, dim), "inv_mass")
    cal = min(calibration_draws, n_samples)
    outs = [run_nuts_fixed(generator, logprob, x0, step, inv_mass, cal, max_depth)]
    done = cal
    draws_per_dispatch = cal
    if done < n_samples:
        ns = min(cal, n_samples - done)
        _synchronize(x0)
        t0 = time.perf_counter()
        timed = run_nuts_fixed(generator, logprob, outs[-1].samples[-1], step, inv_mass, ns,
                               max_depth)
        _synchronize(x0)
        cal_wall = time.perf_counter() - t0
        outs.append(timed)
        done += ns
        # lockstep sequential steps: per draw, the slowest chain's tree
        seq_steps = float(torch.sum(torch.max(timed.n_leapfrog, dim=1).values))
        sec_per_step = cal_wall / max(seq_steps, 1.0)
        worst_per_draw = (1 << max_depth) - 1
        draws_per_dispatch = max(int(max_dispatch_seconds / (worst_per_draw * sec_per_step)), 1)
    while done < n_samples:
        ns = min(draws_per_dispatch, n_samples - done)
        outs.append(run_nuts_fixed(generator, logprob, outs[-1].samples[-1], step, inv_mass, ns,
                                   max_depth))
        done += ns
    return NutsRun(torch.cat([o.samples for o in outs]), torch.cat([o.accept_stat for o in outs]),
                   step, inv_mass, torch.cat([o.n_leapfrog for o in outs]))
