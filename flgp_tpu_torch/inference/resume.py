"""Checkpointed HMC that resumes bit for bit.

Long HMC runs execute in fixed-size segments.  Each phase draws from a
generator seeded afresh from (seed, phase index) through
``numpy.random.SeedSequence(seed, spawn_key=(i,))``: index 0 the warmup,
1 + i segment i.  Carrying one generator's state across segments would tie a
resumed run to the state the killed process had reached; seeding each
segment afresh makes the draw stream a pure function of (seed, shapes).
After segment i its draws go to ``seg_<i>`` and the carried chain state to
``phase_<i>`` (``utils.checkpoint``, written atomically), so a killed run
resumes from the last segment with both on disk and returns the draws of an
uninterrupted run, bit for bit.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.checkpoint import is_saved, load_pytree, save_pytree
from .hmc import (
    HmcRun,
    _find_reasonable_step,
    check_placement,
    da_init,
    da_update,
    hmc_kernel,
    init_state,
)


class HmcPhase(NamedTuple):
    """Post-warmup sampling state carried between segments."""

    x: torch.Tensor          # (C, dim) current positions
    step: torch.Tensor       # (C,) adapted step sizes
    inv_mass: torch.Tensor   # (C, dim) adapted diagonal inverse mass


def phase_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of phase i (0 the warmup, 1 + j segment j) of a run
    seeded with ``seed``, on ``device``."""
    words = np.random.SeedSequence(seed, spawn_key=(i,)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) | (int(words[1]) << 32))
    return g


def hmc_warmup(generator: torch.Generator, logprob: Callable, x0: torch.Tensor, n_warmup: int,
               n_leapfrog: int = 16, target_accept: float = 0.8) -> HmcPhase:
    """Dual-averaging warmup of every chain at unit mass, then the diagonal
    inverse mass from the second half of its draws; returns the frozen
    sampling phase."""
    check_placement(generator, logprob, x0)
    state = init_state(logprob, x0)
    inv_mass0 = torch.ones_like(x0)
    da = da_init(_find_reasonable_step(logprob, state, inv_mass0, generator, x0.dtype))
    half = []
    for i in range(n_warmup):
        state, ap = hmc_kernel(logprob, generator, state, torch.exp(da.log_step), inv_mass0,
                               n_leapfrog)
        da = da_update(da, ap, target_accept)
        if i >= n_warmup // 2:
            half.append(state.x)
    w = len(half)
    var = torch.var(torch.stack(half), dim=0, correction=0)
    inv_mass = (w / (w + 5.0)) * var + 1e-3 * (5.0 / (w + 5.0))
    return HmcPhase(state.x, torch.exp(da.log_step_avg), inv_mass)


def hmc_segment(generator: torch.Generator, logprob: Callable, phase: HmcPhase, n_sweeps: int,
                n_leapfrog: int = 16):
    """``n_sweeps`` fixed-parameter HMC sweeps from ``phase``; returns
    (draws (n_sweeps, C, dim), accept (n_sweeps, C), new phase)."""
    check_placement(generator, logprob, phase.x)
    state = init_state(logprob, phase.x)
    draws = phase.x.new_empty((n_sweeps,) + tuple(phase.x.shape))
    aps = phase.x.new_empty((n_sweeps, phase.x.shape[0]))
    for i in range(n_sweeps):
        state, ap = hmc_kernel(logprob, generator, state, phase.step, phase.inv_mass, n_leapfrog)
        draws[i] = state.x
        aps[i] = ap
    return draws, aps, HmcPhase(state.x, phase.step, phase.inv_mass)


def run_hmc_checkpointed(seed: int, logprob: Callable, x0: torch.Tensor, ckpt_dir: str,
                         n_warmup: int = 256, n_samples: int = 1024, segment: int = 256,
                         n_leapfrog: int = 16, target_accept: float = 0.8) -> HmcRun:
    """Segmented HMC with kill-and-resume semantics, on x0's device.

    The warmup draws from :func:`phase_generator` (seed, 0) and segment i
    from (seed, 1 + i), so a resumed run and an uninterrupted one return the
    same samples.  ``ckpt_dir`` gets ``phase_<i>`` and ``seg_<i>`` after
    segment i; a run resumes after the last i that has both."""
    n_segments = -(-n_samples // segment)
    os.makedirs(ckpt_dir, exist_ok=True)
    device = x0.device

    def seg_path(i):
        return os.path.join(ckpt_dir, f"seg_{i}")

    def phase_path(i):
        return os.path.join(ckpt_dir, f"phase_{i}")

    done = 0
    for i in range(n_segments):
        if not (is_saved(phase_path(i)) and is_saved(seg_path(i))):
            break
        done = i + 1

    if done == 0:
        phase = hmc_warmup(phase_generator(seed, 0, device), logprob, x0, n_warmup, n_leapfrog,
                           target_accept)
    else:
        # at the saved dtypes: a cast would break bit-exact resume
        tree = load_pytree(phase_path(done - 1))
        phase = HmcPhase(*(tree[k].to(device) for k in HmcPhase._fields))

    for i in range(done, n_segments):
        draws, aps, phase = hmc_segment(phase_generator(seed, 1 + i, device), logprob, phase,
                                        segment, n_leapfrog)
        save_pytree(seg_path(i), {"draws": draws, "accept": aps})
        save_pytree(phase_path(i), phase._asdict())

    segs = [load_pytree(seg_path(i)) for i in range(n_segments)]
    samples = torch.cat([s["draws"] for s in segs])[:n_samples].to(device)
    accept = torch.cat([s["accept"] for s in segs])[:n_samples].to(device)
    return HmcRun(samples, accept, phase.step, phase.inv_mass)
