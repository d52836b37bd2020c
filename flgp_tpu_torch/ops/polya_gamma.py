"""Pólya-Gamma sampling.

The Devroye alternating-series sampler (Polson–Scott–Windle): PG(1, c) =
J*(1, |c|/2)/4 with J* drawn by a mixture proposal (truncated
inverse-Gaussian below t = 0.64, truncated exponential above) and the
alternating-series squeeze.  Two paths, chosen by ``pg_on_kernel``:

* on the card: one launch of the CUDA kernel
  ``hopper_kernels.polya_gamma`` finishes every lane on the device, from a
  Philox key drawn from the caller's generator on the device; no host read;
* elsewhere (the CPU): the plain version, vectorized over the whole batch
  with per-lane acceptance masks, whose rejection loops check on the host
  once per round whether every lane is done; each round of its three loops
  counts one ``pg_rounds``.

Both keep the JAX sampler's round caps and fallbacks.  Each call of
``polya_gamma`` counts one ``pg_draws``.  Every draw comes from the caller's
``torch.Generator``, on the data's device.
"""

from __future__ import annotations

import math

import torch

from ..utils.metrics import count, to_host
from . import hopper_kernels as hk

_T = 0.64          # series/proposal cut point
_MAX_ROUNDS = 64   # outer rejection rounds (P(accept) ≳ 0.57 per round)
_MAX_TERMS = 128   # alternating-series terms (decision typically ≤ 10)
_MAX_INNER = 32    # inner rejection rounds for the truncated proposals


def _uniform(g: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=g, dtype=like.dtype, device=like.device)


def _normal(g: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=g, dtype=like.dtype, device=like.device)


def _exponential(g: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like).exponential_(generator=g)


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _a_n(n: float, x: torch.Tensor) -> torch.Tensor:
    """Series coefficient a_n(x) of the J*(1,·) density (piecewise at t)."""
    np_half = n + 0.5
    left = math.pi * np_half * (2.0 / (math.pi * x)) ** 1.5 * torch.exp(-2.0 * np_half**2 / x)
    right = math.pi * np_half * torch.exp(-(np_half**2) * math.pi**2 * x / 2.0)
    return torch.where(x <= _T, left, right)


def _mass_texpon(z: torch.Tensor):
    """Mixture weights (p, q): exponential tail mass and truncated-IG mass."""
    K = math.pi**2 / 8.0 + z**2 / 2.0
    p = (math.pi / (2.0 * K)) * torch.exp(-K * _T)
    sqrt_t = math.sqrt(_T)
    # IG(μ=1/z, λ=1) CDF at t, written directly in z (finite at z = 0)
    q = 2.0 * torch.exp(-z) * (
        _norm_cdf((_T * z - 1.0) / sqrt_t) + torch.exp(2.0 * z) * _norm_cdf(-(_T * z + 1.0) / sqrt_t)
    )
    return p, q


def _sample_ig(g: torch.Generator, mu: torch.Tensor) -> torch.Tensor:
    """Inverse-Gaussian IG(mu, 1) (Michael–Schucany–Haas)."""
    y = _normal(g, mu) ** 2
    x = mu + 0.5 * mu**2 * y - 0.5 * mu * torch.sqrt(4.0 * mu * y + (mu * y) ** 2)
    u = _uniform(g, mu)
    return torch.where(u <= mu / (mu + x), x, mu**2 / torch.clamp(x, min=1e-30))


def _sample_rtigauss(g: torch.Generator, z: torch.Tensor) -> torch.Tensor:
    """IG(μ=1/z, λ=1) truncated to (0, t]; both branch strategies (μ > t:
    χ² proposal; μ ≤ t: resample IG until ≤ t) advance together under
    acceptance masks."""
    mu = 1.0 / torch.clamp(z, min=1e-10)
    big_mu = mu > _T
    done = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    x = torch.full_like(z, 0.5 * _T)
    for _ in range(_MAX_INNER):
        count("pg_rounds")
        # branch A (μ > t): one-sided χ²-style proposal
        e1 = _exponential(g, z)
        e2 = _exponential(g, z)
        ok_e = e1 * e1 <= 2.0 * e2 / _T
        xa = _T / (1.0 + _T * e1) ** 2
        acc_a = ok_e & (_uniform(g, z) <= torch.exp(-0.5 * z * z * xa))
        # branch B (μ ≤ t): plain IG, accept if ≤ t
        xb = _sample_ig(g, mu)
        acc = torch.where(big_mu, acc_a, xb <= _T)
        x = torch.where(~done & acc, torch.where(big_mu, xa, xb), x)
        done = done | acc
        if to_host(torch.all(done)):
            break
    return x


def _series_accept(g: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Alternating-series accept/reject for a proposal x of J*(1, z)."""
    s = _a_n(0.0, x)
    y = _uniform(g, x) * s
    decided = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    accept = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for n in range(1, _MAX_TERMS + 1):
        count("pg_rounds")
        a = _a_n(float(n), x)
        odd = n % 2 == 1
        s = s - a if odd else s + a
        newly = ~decided & ((y <= s) if odd else (y > s))
        if odd:
            accept = accept | newly
        decided = decided | newly
        if to_host(torch.all(decided)):
            break
    # undecided after _MAX_TERMS (prob ~0): accept, the partial sums have converged
    return accept | ~decided


def _sample_jstar(g: torch.Generator, z: torch.Tensor) -> torch.Tensor:
    """J*(1, z) for z ≥ 0, batched over z's shape."""
    done = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    x = torch.full_like(z, _T)
    p, q = _mass_texpon(z)
    ratio = p / (p + q)
    Kz = math.pi**2 / 8.0 + z**2 / 2.0
    for _ in range(_MAX_ROUNDS):
        count("pg_rounds")
        use_tail = _uniform(g, z) < ratio
        x_tail = _T + _exponential(g, z) / Kz
        x_ig = _sample_rtigauss(g, z)
        prop = torch.where(use_tail, x_tail, x_ig)
        acc = _series_accept(g, prop)
        x = torch.where(~done & acc, prop, x)
        done = done | acc
        if to_host(torch.all(done)):
            break
    return x


def pg_on_kernel(device_type: str, dtype: torch.dtype) -> bool:
    """Whether a draw of this device type and dtype takes the CUDA kernel:
    every draw on the card, whose kernel raises on a dtype other than float32
    and float64; the CPU keeps the loop."""
    return device_type == "cuda"


def polya_gamma(g: torch.Generator, c: torch.Tensor) -> torch.Tensor:
    """One PG(1, c) draw per element of c."""
    count("pg_draws")
    z = torch.abs(c) / 2.0
    if pg_on_kernel(c.device.type, c.dtype):
        key = torch.randint(2**62, (2,), generator=g, dtype=torch.int64, device=c.device)
        return hk.polya_gamma(z.contiguous(), key) / 4.0
    return _sample_jstar(g, z) / 4.0


def polya_gamma_int(g: torch.Generator, b: int, c: torch.Tensor) -> torch.Tensor:
    """PG(b, c) for an integer b ≥ 1 as the sum of b PG(1, c) draws (pgdraw's
    integer-b semantics)."""
    return torch.sum(polya_gamma(g, c.expand((b,) + c.shape)), dim=0)


def polya_gamma_counts(g: torch.Generator, N: torch.Tensor, c: torch.Tensor,
                       max_n: int) -> torch.Tensor:
    """PG(N_i, c_i) with per-element integer counts N_i ≤ max_n: masked sum of
    max_n PG(1, c) draws.  N broadcasts against c (counts (m,) for c (J, m))."""
    draws = polya_gamma(g, c.expand((max_n,) + c.shape))     # (max_n, ..., m)
    mask = torch.arange(max_n, device=c.device).reshape((max_n,) + (1,) * N.dim()) < N[None]
    return torch.sum(draws * mask, dim=0)
