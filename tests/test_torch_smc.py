"""flgp_tpu_torch's tempered SMC (``inference/smc.py``).

SMC is stochastic, so the port is held to the reference's own statistical
gates (tests/test_inference.py::TestSmc): the analytic log evidence of a
Gaussian prior × Gaussian likelihood within 0.15 (HMC mutations) or 0.2
(random-walk mutations) and the posterior mean within 0.15.  Deterministic,
and the port's own: the chunked driver gives the same bits as the whole
ladder, and the systematic-resampling index is clamped where a float32
cumulative sum ends below the last position.
"""

import math

import numpy as np
import pytest
import torch

from flgp_tpu_torch.inference import smc
from flgp_tpu_torch.inference.smc import run_smc, run_smc_chunked

torch.set_num_threads(1)

F64 = torch.float64
MU = torch.tensor([0.5, -0.5], dtype=F64)
S2 = 0.5**2


def log_prior(x):
    return -0.5 * torch.sum(x * x, dim=-1) - math.log(2 * math.pi)


def log_like(x):
    return -0.5 * torch.sum((x - MU) ** 2, dim=-1) / S2 - math.log(2 * math.pi * S2)


def analytic():
    var = 1.0 + S2
    log_z = float(np.sum(-0.5 * np.log(2 * np.pi * var) - 0.5 * MU.numpy() ** 2 / var))
    return log_z, MU.numpy() / S2 / (1 + 1 / S2)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("mutation,steps,atol", [("hmc", 5, 0.15), ("rwm", 10, 0.2)])
def test_gaussian_evidence(mutation, steps, atol):
    """Prior N(0, I), likelihood N(x; μ, σ²I): log Z and the posterior mean
    are analytic; the reference's tolerances."""
    x0 = torch.randn((512, 2), generator=gen(0), dtype=F64)
    kw = dict(n_mutation_steps=steps, mutation=mutation)
    if mutation == "rwm":
        kw["step_size"] = 0.5
    res = run_smc(gen(1), log_prior, log_like, x0, **kw)
    log_z, post_mean = analytic()
    assert abs(float(res.log_evidence) - log_z) < atol
    np.testing.assert_allclose(res.particles.mean(0).numpy(), post_mean, atol=0.15)
    temps = res.temperatures.numpy()
    assert res.n_stages >= 1 and temps[res.n_stages - 1] == 1.0
    assert np.all(np.diff(temps[:res.n_stages]) > 0) and np.all(temps[res.n_stages:] == 1.0)


@pytest.mark.parametrize("mutation", ["rwm", "hmc"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_driver_same_bits(chunk, mutation):
    """The chunked ladder applies the same stage bodies: particles,
    temperatures, n_stages and log evidence are the same bits."""
    def sharp_like(x):                    # a narrow likelihood: a ladder of many stages
        return -0.5 * torch.sum((x - MU.float()) ** 2, dim=-1) / 0.05**2

    x0 = torch.randn((128, 2), generator=gen(0), dtype=torch.float32)
    kw = dict(n_mutation_steps=3, mutation=mutation, step_size=0.5)
    mono = run_smc(gen(1), log_prior, sharp_like, x0, **kw)
    ck = run_smc_chunked(gen(1), log_prior, sharp_like, x0, stages_per_dispatch=chunk, **kw)
    assert mono.n_stages > chunk
    assert ck.n_stages == mono.n_stages
    assert torch.equal(ck.particles, mono.particles)
    assert torch.equal(ck.temperatures, mono.temperatures)
    assert torch.equal(ck.log_evidence, mono.log_evidence)


def test_resample_index_is_clamped_where_the_cumulative_sum_ends_short():
    """A float32 cumulative sum ending at 1 − 1e-7 sits below the last
    systematic position; searchsorted then returns n, which JAX's gather
    clamps and a torch index would fault on."""
    cum = torch.tensor([0.25, 0.5, 0.75, 1.0 - 1e-7], dtype=torch.float32)
    u = torch.tensor(1.0 - 2e-8, dtype=torch.float32)
    positions = (u + torch.arange(4, dtype=torch.float32)) / 4
    assert int(torch.searchsorted(cum, positions)[-1]) == 4
    idx = smc._resample_index(cum, positions)
    assert idx.tolist() == [0, 1, 2, 3]
    particles = torch.arange(4.0)[:, None]
    assert particles[idx].shape == (4, 1)


def test_resample_indices_follow_the_weights():
    """Systematic resampling keeps each particle ⌊n·w⌋ or ⌈n·w⌉ times."""
    w = torch.tensor([0.5, 0.25, 0.125, 0.125], dtype=F64)
    idx = smc._systematic_resample(gen(3), torch.log(w), 8)
    counts = torch.bincount(idx, minlength=4).tolist()
    assert counts == [4, 2, 1, 1]


def test_bisection_meets_the_ess_target():
    """The next β keeps the incremental ESS at the target (within the
    bisection's resolution), or is 1 when 1 already keeps it."""
    ll = torch.randn(256, generator=gen(4), dtype=F64) * 20.0
    beta = torch.tensor(0.0, dtype=F64)
    b = smc._next_beta(ll, beta, 128.0)
    assert 0.0 < float(b) < 1.0
    assert float(smc._ess_from_logw(b * ll)) >= 128.0
    assert float(smc._ess_from_logw((b + 1e-6) * ll)) < 128.0
    assert float(smc._next_beta(ll * 1e-6, beta, 128.0)) == 1.0


def test_rejects_unknown_mutation_and_misplaced_generator():
    with pytest.raises(ValueError, match="mutation"):
        run_smc(gen(0), log_prior, log_like, torch.zeros((4, 2)), mutation="nope")
    with pytest.raises(ValueError, match="generator"):
        run_smc(gen(0), log_prior, log_like, torch.zeros((4, 2), device="meta"))
