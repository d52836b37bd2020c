"""Particle-parallel tempered SMC over processes.

The particle axis shards over the mesh; each stage's collectives are
all-gathers of one number a particle (the log-likelihoods, the last mutation
step's acceptances) and of the particles for the resample:

1. the adaptive-tempering ESS bisection and the evidence increment run on
   the gathered log-likelihoods, in global particle order, with
   ``inference.smc``'s own functions;
2. systematic resampling draws its one uniform from the shared generator
   and indexes the gathered particles; each rank keeps its slice;
3. the mutation (HMC or random-walk Metropolis) runs on the local slice,
   its noise drawn for all n particles from the shared generator in global
   particle order and sliced, so a rank's draws are the ones
   ``inference.smc.run_smc`` gives its particles.

So every rank sees the same β, evidence and step size, runs the same
number of stages, and, for densities that treat each particle on its own,
the result is ``run_smc``'s bit for bit at any world size (the JAX package
reduces the ESS with psums and folds the rank into the mutation keys, so
its sharded ladder agrees with its oracle only to Monte Carlo error).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..inference.hmc import _hmc_transition, check_placement, init_state, value_and_grad
from ..inference.smc import (
    ACCEPT_TARGET,
    SmcResult,
    SmcState,
    _check_mutation,
    _next_beta,
    _systematic_resample,
    smc_init,
)
from .mesh import Mesh

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


def _rows(generator, n: int, lo: int, hi: int, like: torch.Tensor, shape=(), normal=True):
    """Rows [lo, hi) of an (n, *shape) draw from the shared generator."""
    draw = torch.randn if normal else torch.rand
    return draw((n,) + tuple(shape), generator=generator, dtype=like.dtype,
                device=like.device)[lo:hi]


def sharded_smc_fn(mesh: Mesh, log_prior: LogProbFn, log_like: LogProbFn,
                   n_mutation_steps: int = 5, n_leapfrog: int = 8, target_ess_frac: float = 0.5,
                   max_stages: int = 50, step_size: float = 0.1, mutation: str = "hmc",
                   axis: str = "chain"):
    """fn(generator, x_local (n_particles / world, dim)) → ``SmcResult``
    with this rank's particles and the replicated evidence, stage count and
    temperatures; the particles are split over ``axis`` in rank order.  The
    generator must be seeded alike on every rank: it drives the draws that
    all ranks share."""
    _check_mutation(mutation)
    mesh.check_axis(axis)

    def stage(generator, st: SmcState, n: int, lo: int) -> SmcState:
        hi = lo + st.particles.shape[0]
        ll = mesh.all_gather(log_like(st.particles))
        beta_new = _next_beta(ll, st.beta, target_ess_frac * n)
        log_w = (beta_new - st.beta) * ll
        log_Z = st.log_Z + torch.logsumexp(log_w, dim=0) - math.log(n)
        idx = _systematic_resample(generator, log_w, n)[lo:hi]
        x = mesh.all_gather(st.particles)[idx]

        def target(x):
            return log_prior(x) + beta_new * log_like(x)

        ones = torch.ones_like(x)
        ap = ones[:, 0]
        if mutation == "hmc":
            vg, state = value_and_grad(target), init_state(target, x)
            step = st.step.expand(x.shape[:1])
            for _ in range(n_mutation_steps):
                p0 = _rows(generator, n, lo, hi, x, x.shape[1:])
                u = _rows(generator, n, lo, hi, x, normal=False)
                state, ap = _hmc_transition(vg, state, p0 / torch.sqrt(ones), u, step, ones,
                                            n_leapfrog)
            x = state.x
        else:
            lp = log_prior(x) + beta_new * ll[idx]
            for _ in range(n_mutation_steps):
                prop = x + st.step * _rows(generator, n, lo, hi, x, x.shape[1:])
                lp_prop = target(prop)
                log_u = torch.log(_rows(generator, n, lo, hi, x, normal=False))
                ap = torch.clamp(torch.exp(lp_prop - lp), max=1.0)
                take = log_u < lp_prop - lp
                x = torch.where(take[:, None], prop, x)
                lp = torch.where(take, lp_prop, lp)
        step = st.step * torch.exp(torch.mean(mesh.all_gather(ap)) - ACCEPT_TARGET[mutation])
        temps = st.temps.clone()
        temps[st.stage] = beta_new
        return SmcState(x, beta_new, log_Z, st.stage + 1, step, temps)

    def fn(generator: torch.Generator, x_local: torch.Tensor) -> SmcResult:
        check_placement(generator, log_like, x_local)
        n = x_local.shape[0] * mesh.size
        st = smc_init(x_local, step_size, max_stages)
        while st.stage < max_stages and float(st.beta) < 1.0:
            st = stage(generator, st, n, mesh.rank * x_local.shape[0])
        return SmcResult(st.particles, st.log_Z, st.stage, st.temps)

    return fn
