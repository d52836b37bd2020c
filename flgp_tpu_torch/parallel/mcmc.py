"""Chain-parallel MCMC over processes.

HMC and NUTS chains are independent, so the chain axis shards with no
collective in the hot loop: each rank runs ``inference.hmc.run_hmc`` (or
``run_nuts``) on its chains with a generator of its own, seeded from the
caller's.  ChEES adapts from cross-chain statistics, so its rank runs take
the mesh and every cross-chain mean is an all-reduce: all ranks hold the same
adapted (ε, τ, M⁻¹) and run the same leapfrog counts.  Cross-chain summaries
afterwards (:func:`pooled_mean_variance`) are one all-reduce.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..inference.chees import CheesRun, run_chees
from ..inference.hmc import HmcRun, run_hmc
from ..inference.nuts import NutsRun, run_nuts
from .mesh import Mesh

LogProbFn = Callable[[torch.Tensor], torch.Tensor]

_SPREAD = 0x9E3779B97F4A7C15   # odd 64-bit constant spreading the ranks' seeds


def _rank_generator(generator: torch.Generator, mesh: Mesh) -> torch.Generator:
    """This rank's generator: one 62-bit draw from the caller's (the same on
    every rank whose caller seeded it alike), spread by the rank."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=mesh.device).manual_seed((base + _SPREAD * mesh.rank) % 2 ** 64)


def sharded_hmc_fn(mesh: Mesh, logprob: LogProbFn, n_warmup: int, n_samples: int,
                   n_leapfrog: int = 16, axis: str = "chain"):
    """fn(generator, x0_local (C_local, dim)) → this rank's ``HmcRun``
    (samples (n_samples, C_local, dim)): ``run_hmc`` on the local chains."""
    mesh.check_axis(axis)

    def fn(generator: torch.Generator, x0_local: torch.Tensor) -> HmcRun:
        return run_hmc(_rank_generator(generator, mesh), logprob, x0_local, n_warmup=n_warmup,
                       n_samples=n_samples, n_leapfrog=n_leapfrog)

    return fn


def sharded_nuts_fn(mesh: Mesh, logprob: LogProbFn, n_warmup: int, n_samples: int,
                    max_depth: int = 8, target_accept: float = 0.8, axis: str = "chain"):
    """fn(generator, x0_local) → this rank's ``NutsRun``: ``run_nuts`` on the
    local chains; the warmup adapts each chain on its own, so the loop has no
    collective."""
    mesh.check_axis(axis)

    def fn(generator: torch.Generator, x0_local: torch.Tensor) -> NutsRun:
        return run_nuts(_rank_generator(generator, mesh), logprob, x0_local, n_warmup=n_warmup,
                        n_samples=n_samples, max_depth=max_depth, target_accept=target_accept)

    return fn


def sharded_chees_fn(mesh: Mesh, logprob: LogProbFn, n_warmup: int, n_samples: int,
                     max_steps: int = 256, axis: str = "chain"):
    """fn(generator, x0_local) → ``CheesRun`` with this rank's samples and
    the adapted (step, traj_len, inv_mass), the same on every rank: every
    cross-chain statistic of the adaptation is an all-reduce over the mesh
    (3 scalars and 2 (dim,) vectors a warmup iteration)."""
    mesh.check_axis(axis)

    def fn(generator: torch.Generator, x0_local: torch.Tensor) -> CheesRun:
        return run_chees(_rank_generator(generator, mesh), logprob, x0_local, n_warmup=n_warmup,
                         n_samples=n_samples, max_steps=max_steps, axis_name=mesh)

    return fn


def pooled_mean_variance(mesh: Mesh, draws: torch.Tensor,
                         axis: str = "chain") -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance (dim,) over every rank's draws
    (n_samples, C_local, dim): one all-reduce of Σx, Σx² and the count, in
    the draws' dtype on return.

    The sums are float64 whatever the draws' dtype, and the count, a whole
    number, is exact in them: Σx²/N − mean² in float32 cancels away the
    variance of draws whose mean is large against their spread (at mean 17
    and sd 0.01 it gave 6e-5 to 1.5e-4 for 1e-4).  The reference sums in
    the draws' dtype (``flgp_tpu/parallel/mcmc.py:144-151``)."""
    mesh.check_axis(axis)
    dim = draws.shape[-1]
    x = draws.to(torch.float64)
    cnt = torch.tensor([draws.shape[0] * draws.shape[1]], dtype=torch.float64,
                       device=draws.device)
    tot = mesh.psum(torch.cat([torch.sum(x, dim=(0, 1)), torch.sum(x * x, dim=(0, 1)), cnt]))
    mean = tot[:dim] / tot[-1]
    var = tot[dim:2 * dim] / tot[-1] - mean * mean
    return mean.to(draws.dtype), var.to(draws.dtype)
