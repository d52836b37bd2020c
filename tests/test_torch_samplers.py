"""flgp_tpu_torch's samplers: HMC, NUTS, ChEES and the diagnostics.

Held to the reference (``flgp_tpu.inference``) in float64 where a piece is
deterministic: ``split_rhat`` and ``ess`` on the same draws, ``halton2``,
``stan_windows``, dual-averaging sequences, and one HMC and one ChEES
transition whose momenta and uniforms are JAX's own draws, injected, at
1e-12.  The reference samplers themselves are not run (their jit compiles
cost minutes); the port's are held to the statistical tests of
``tests/test_inference.py`` (TestHmc, TestNuts, TestChees, TestInvMassSeed)
at their tolerances, plus NUTS's properties and fault F3.  The cross-check
of HMC and NUTS against PG-Gibbs and Laplace on one posterior is in
tests/test_torch_latent.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.inference import chees as jchees
from flgp_tpu.inference import diagnostics as jdiag
from flgp_tpu.inference import hmc as jhmc
from flgp_tpu.models import latent as jlat

from flgp_tpu_torch.convert import gpc_logpost_from_jax
from flgp_tpu_torch.inference import chees, hmc, nuts
from flgp_tpu_torch.inference.chees import halton2, run_chees, run_chees_fixed
from flgp_tpu_torch.inference.diagnostics import ess, split_rhat
from flgp_tpu_torch.inference.hmc import run_hmc
from flgp_tpu_torch.inference.nuts import run_nuts
from flgp_tpu_torch.models.latent import WhitenedGP, whitened_inv_mass0

torch.set_num_threads(1)

F64 = torch.float64
DIM = 3
MEAN = torch.tensor([1.0, -2.0, 0.5], dtype=F64)
SCALES = torch.tensor([1.0, 0.5, 2.0], dtype=F64)


def gauss_logprob(x):
    return -0.5 * torch.sum(((x - MEAN) / SCALES) ** 2, dim=-1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def zeros(c, d):
    return torch.zeros((c, d), dtype=F64)


def flat(samples):
    return samples.reshape(-1, samples.shape[-1]).numpy()


# ---------------------------------------------------------------------------
# deterministic pieces against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(500, 4, 2), (301, 3, 5), (64, 16, 3), (9, 2, 1)])
def test_diagnostics_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    draws = rng.normal(size=shape)
    draws += np.cumsum(rng.normal(size=shape), axis=0) * 0.3      # some autocorrelation
    draws[:, 0] += 0.5                                           # and a chain apart
    np.testing.assert_allclose(split_rhat(torch.tensor(draws)).numpy(),
                               np.asarray(jdiag.split_rhat(jnp.asarray(draws))), rtol=1e-12)
    np.testing.assert_allclose(ess(draws), jdiag.ess(draws), rtol=1e-12)
    np.testing.assert_allclose(ess(torch.tensor(draws), max_lag=5), jdiag.ess(draws, 5),
                               rtol=1e-12)


def test_ess_iid_and_rhat_of_diverged_chains():
    draws = np.random.default_rng(0).normal(size=(500, 4, 2))
    assert np.all(ess(draws) > 1000)              # iid: ESS ≈ n·chains = 2000
    draws = np.random.default_rng(0).normal(size=(300, 4, 1))
    draws[:, 0, :] += 10.0
    assert split_rhat(draws)[0] > 1.5


def test_halton2_is_the_reference_s():
    i = np.concatenate([np.arange(1, 2049), [2**20 + 7, 2**31 - 1, 123456789]]).astype(np.int32)
    want = np.asarray(jax.vmap(jchees.halton2)(jnp.asarray(i)))
    np.testing.assert_array_equal(halton2(torch.tensor(i)).numpy(), want)
    np.testing.assert_array_equal(halton2(torch.tensor(i), torch.float32).numpy(),
                                  want.astype(np.float32))
    h = halton2(torch.arange(1, 257)).numpy()
    assert np.all((h > 0) & (h < 1))
    counts, _ = np.histogram(h, bins=16, range=(0, 1))
    assert counts.min() == counts.max() == 16


def test_stan_windows_are_the_reference_s():
    for n in list(range(0, 400)) + [500, 1000, 1234, 4096]:
        assert hmc.stan_windows(n) == jhmc.stan_windows(n), n
        assert hmc.stan_windows(n, 0.2, 0.05, 10) == jhmc.stan_windows(n, 0.2, 0.05, 10), n


def test_dual_averaging_sequence_is_the_reference_s():
    rng = np.random.default_rng(1)
    step0 = rng.uniform(0.05, 2.0, size=6)
    aps = rng.uniform(0.0, 1.0, size=(200, 6))
    da = hmc.da_init(torch.tensor(step0))
    jda = jhmc.da_init(jnp.asarray(step0))
    for a in aps:
        da = hmc.da_update(da, torch.tensor(a), 0.8)
        jda = jhmc.da_update(jda, jnp.asarray(a), 0.8)
        for got, want in zip(da, jda):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-300)


def _gpc_model(seed, m=30, K=10):
    rng = np.random.default_rng(seed)
    gp = jlat.WhitenedGP(jnp.asarray(rng.normal(size=(m, K))),
                         jnp.asarray(np.sort(rng.uniform(0.0, 1.0, K))), 1e-3)
    Y = (rng.uniform(size=m) > 0.5).astype(float)
    ref = jlat.GpcLogPost(gp, jnp.asarray(Y), jnp.ones(m), 1e-2, 10.0, 2.0)
    x0 = 0.3 * rng.normal(size=(4, K + 1))
    x0[:, -1] += 1.5
    return ref, gpc_logpost_from_jax(ref), x0


@pytest.mark.parametrize("n_steps", [1, 8])
def test_hmc_transition_with_injected_draws_is_the_reference_s(n_steps):
    """hmc_kernel's draws as ``flgp_tpu/inference/hmc.py:73-81`` makes them
    (k_mom, k_acc = split(key); normal(k_mom)/√M⁻¹; uniform(k_acc)), fed to
    the port's transition: the same state and acceptance at 1e-12."""
    ref, post, x0 = _gpc_model(7)
    C, dim = x0.shape
    rng = np.random.default_rng(8)
    step = rng.uniform(0.05, 0.3, size=C)
    inv_mass = rng.uniform(0.5, 2.0, size=(C, dim))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    z, u, want = [], [], []
    for c in range(C):
        k_mom, k_acc = jax.random.split(keys[c])
        z.append(np.asarray(jax.random.normal(k_mom, (dim,), jnp.float64)))
        u.append(float(jax.random.uniform(k_acc, (), jnp.float64)))
        st = jhmc.init_state(ref, jnp.asarray(x0[c]))
        want.append(jhmc.hmc_kernel(ref, keys[c], st, jnp.asarray(step[c]),
                                    jnp.asarray(inv_mass[c]), n_steps))
    state = hmc.init_state(post, torch.tensor(x0))
    im = torch.tensor(inv_mass)
    got, ap = hmc._hmc_transition(post.value_and_grad, state, torch.tensor(np.stack(z)) /
                                  torch.sqrt(im), torch.tensor(u), torch.tensor(step), im, n_steps)
    for c, (wst, wap) in enumerate(want):
        np.testing.assert_allclose(got.x[c].numpy(), np.asarray(wst.x), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got.logp[c].item(), float(wst.logp), rtol=1e-12)
        np.testing.assert_allclose(got.grad[c].numpy(), np.asarray(wst.grad), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(ap[c].item(), float(wap), rtol=1e-12, atol=1e-12)
    assert 0 < float((ap > 0).sum())


@pytest.mark.parametrize("n_steps", [1, 5])
def test_chees_transition_with_injected_draws_is_the_reference_s(n_steps):
    """_chees_transition's draws as ``flgp_tpu/inference/chees.py:104-111``
    makes them (normal(p0_key, (C, dim))/√M⁻¹, uniform(key, (C,))); the new
    state, the proposal, the final momentum and the accept probabilities at
    1e-12."""
    ref, post, x0 = _gpc_model(9)
    C, dim = x0.shape
    inv_mass = np.random.default_rng(2).uniform(0.5, 2.0, size=dim)
    key, p0_key = jax.random.split(jax.random.PRNGKey(5))
    vg = jax.vmap(jax.value_and_grad(ref))
    jst = jchees._BatchState(jnp.asarray(x0), *vg(jnp.asarray(x0)))
    want = jchees._chees_transition(vg, key, jst, p0_key, jnp.asarray(0.2),
                                    jnp.asarray(inv_mass), jnp.int32(n_steps), None)
    z = np.asarray(jax.random.normal(p0_key, (C, dim), jnp.float64))
    u = np.asarray(jax.random.uniform(key, (C,), jnp.float64))
    x = torch.tensor(x0)
    st = chees._BatchState(x, *post.value_and_grad(x))
    im = torch.tensor(inv_mass)
    got = chees._chees_transition(post.value_and_grad, st, torch.tensor(z) / torch.sqrt(im)[None],
                                  torch.tensor(u), torch.tensor(0.2, dtype=F64), im, n_steps)
    (gnew, gprop, gp1, gap), (wnew, wprop, wp1, wap) = got, want
    for a, b in [(gnew.x, wnew.x), (gnew.logp, wnew.logp), (gnew.grad, wnew.grad),
                 (gprop.x, wprop.x), (gprop.logp, wprop.logp), (gp1, wp1), (gap, wap)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    # the ChEES criterion's gradient from the same transition
    g = chees._chees_grad(st, gprop, gp1, gap, im, 0.7)
    jg = jchees._chees_grad(jst, wprop, wp1, wap, jnp.asarray(inv_mass), 0.7, None)
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-12, atol=1e-300)


def test_leapfrog_is_reversible_and_keeps_the_energy():
    """n steps forward, the momentum negated, n steps back: the start again,
    with the energy nearly kept on the way (the public ``leapfrog``)."""
    _, post, x0 = _gpc_model(4)
    state = hmc.init_state(post, torch.tensor(x0))
    p0 = torch.randn(state.x.shape, generator=gen(2), dtype=F64)
    mid, p1 = hmc.leapfrog(post, state, p0, 0.02, torch.ones(state.x.shape[1], dtype=F64), 25)
    back, p2 = hmc.leapfrog(post, mid, -p1, torch.full((4,), 0.02, dtype=F64), 1.0, 25)
    np.testing.assert_allclose(back.x.numpy(), x0, rtol=0, atol=1e-10)
    np.testing.assert_allclose((-p2).numpy(), p0.numpy(), rtol=0, atol=1e-10)
    h0 = -state.logp + 0.5 * torch.sum(p0 * p0, dim=-1)
    h1 = -mid.logp + 0.5 * torch.sum(p1 * p1, dim=-1)
    assert float(torch.max(torch.abs(h1 - h0))) < 0.05


# ---------------------------------------------------------------------------
# statistics, at the tolerances of tests/test_inference.py
# ---------------------------------------------------------------------------


def test_hmc_gaussian_moments_and_rhat():
    run = run_hmc(gen(0), gauss_logprob, zeros(4, DIM), n_warmup=300, n_samples=600,
                  n_leapfrog=8)
    draws = flat(run.samples)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.2)
    np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.25)
    assert float(run.accept_prob.mean()) > 0.5
    run = run_hmc(gen(1), gauss_logprob, zeros(4, DIM), n_warmup=300, n_samples=600,
                  n_leapfrog=8)
    rhat = split_rhat(run.samples).numpy()
    assert np.all(rhat < 1.1), rhat
    assert run.step.shape == (4,) and run.inv_mass.shape == (4, DIM)


def test_hmc_fixed_continues_an_adapted_run():
    run = run_hmc(gen(2), gauss_logprob, zeros(4, DIM), n_warmup=200, n_samples=20, n_leapfrog=8)
    cont = hmc.run_hmc_fixed(gen(3), gauss_logprob, run.samples[-1], run.step, run.inv_mass,
                             n_samples=600, n_leapfrog=8)
    draws = flat(cont.samples)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.2)
    np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.25)
    assert torch.equal(cont.step, run.step)


def test_hmc_anisotropic_with_inv_mass_seed():
    scales = torch.tensor([100.0, 10.0, 1.0, 0.1, 0.01], dtype=F64)

    def logprob(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    run = run_hmc(gen(3), logprob, zeros(4, 5), n_warmup=400, n_samples=600, n_leapfrog=8,
                  inv_mass0=scales ** 2)
    np.testing.assert_allclose(flat(run.samples).std(0), scales.numpy(), rtol=0.35)


def test_whitened_inv_mass0_ordering():
    rng = np.random.default_rng(0)
    V = torch.tensor(rng.normal(size=(50, 8)), dtype=torch.float32)
    lam = torch.linspace(0.0, 1.0, 8)
    im0 = whitened_inv_mass0(WhitenedGP(V, lam, 1e-3), t0=10.0, obs_curvature=0.25,
                             n_hyper=2).numpy()
    assert im0.shape == (10,)
    assert np.all(im0[:8] <= 1.0) and np.all(im0 > 0.0)
    assert im0[7] > im0[0]
    np.testing.assert_allclose(im0[8:], 1.0)


def test_nuts_gaussian_moments():
    run = run_nuts(gen(0), gauss_logprob, zeros(4, DIM), n_warmup=200, n_samples=400,
                   max_depth=6)
    draws = flat(run.samples)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.25)
    np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.3)


def test_nuts_correlated_gaussian():
    rho = 0.9
    prec = torch.tensor(np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]])))

    def logprob(x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1)

    run = run_nuts(gen(2), logprob, zeros(4, 2), n_warmup=300, n_samples=500, max_depth=8)
    got = np.corrcoef(flat(run.samples).T)[0, 1]
    np.testing.assert_allclose(got, rho, atol=0.1)


def test_nuts_fixed_chunked_driver():
    adapt = run_nuts(gen(5), gauss_logprob, zeros(4, DIM), n_warmup=200, n_samples=50,
                     max_depth=6)
    run = nuts.run_nuts_fixed_chunked(gen(6), gauss_logprob, adapt.samples[-1], adapt.step,
                                      adapt.inv_mass, n_samples=400, max_depth=6,
                                      max_dispatch_seconds=0.5)
    assert run.samples.shape == (400, 4, DIM)
    assert run.n_leapfrog.shape == (400, 4)
    assert int(run.n_leapfrog.min()) >= 1
    draws = flat(run.samples)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.3)
    np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.3)


@pytest.mark.parametrize("max_depth", [1, 3, 6])
def test_nuts_leapfrog_counts_are_each_chain_s_own(max_depth):
    """n_leapfrog ≤ 2^max_depth − 1 per chain and transition; the lockstep
    leaves are at least the slowest chain's count; the host syncs are
    counted."""
    nuts.reset_stats()
    run = nuts.run_nuts_fixed(gen(7), gauss_logprob, torch.randn((6, DIM), generator=gen(8),
                                                                  dtype=F64),
                              torch.full((6,), 0.05, dtype=F64), torch.ones(DIM, dtype=F64),
                              n_samples=30, max_depth=max_depth)
    n = run.n_leapfrog
    assert n.dtype == torch.int64 and n.shape == (30, 6)
    assert int(n.min()) >= 1 and int(n.max()) <= 2 ** max_depth - 1
    assert nuts.STATS["transitions"] == 30
    assert nuts.STATS["lockstep_leaves"] >= int(n.max(dim=1).values.sum())
    if max_depth == 6:                      # a small step: trees run deep, chains apart
        assert int(n.max()) > int(n.min())
        assert nuts.STATS["host_syncs"] > 0


def test_nuts_divergent_start_accepts_zero_not_nan():
    """From a point where every leaf's energy is NaN the transition stays put
    with accept statistic 0 (Stan's convention), not NaN."""
    def logprob(x):
        lp = -0.5 * torch.sum(x * x, dim=-1)
        return torch.where(torch.abs(x[..., 0]) > 1.0, lp,
                           torch.full_like(lp, float("nan")))

    x0 = torch.tensor([[0.0, 1.0], [0.5, -1.0], [3.0, 0.0]], dtype=F64)
    state = hmc.init_state(logprob, x0)
    new, (ap, ns) = nuts.nuts_kernel(logprob, gen(1), state, torch.full((3,), 1e-3, dtype=F64),
                                     torch.ones(2, dtype=F64), max_depth=5)
    assert not torch.isnan(ap).any()
    assert ap[0].item() == 0.0 and ap[1].item() == 0.0 and ns[0].item() == 1
    assert torch.equal(new.x[:2], x0[:2])
    assert ap[2].item() > 0.5


def _chees_target(d, top, mean=None):
    scales = torch.tensor(np.geomspace(1.0, top, d), dtype=F64)
    mean = torch.zeros(d, dtype=F64) if mean is None else mean

    def logprob(x):
        return -0.5 * torch.sum(((x - mean) / scales) ** 2, dim=-1)

    return logprob, scales


def test_chees_ill_conditioned_gaussian_moments_and_metric():
    d = 16
    mean = torch.linspace(-2, 2, d, dtype=F64)
    logprob, scales = _chees_target(d, 30.0, mean)
    run = run_chees(gen(0), logprob, zeros(32, d), n_warmup=400, n_samples=600)
    S = flat(run.samples)
    np.testing.assert_allclose(S.mean(0), mean, atol=0.3)
    np.testing.assert_allclose(S.std(0), scales, rtol=0.15)
    np.testing.assert_allclose(run.inv_mass.numpy(), scales.numpy() ** 2, rtol=0.5)
    acc = float(run.accept_prob.mean())
    assert 0.55 < acc < 0.95, acc


def test_chees_ess_per_gradient_beats_fixed_hmc_floor():
    d = 16
    logprob, _ = _chees_target(d, 30.0)
    run = run_chees(gen(1), logprob, zeros(32, d), n_warmup=400, n_samples=600)
    e = ess(run.samples)
    grads = int(run.n_leapfrog_total) * 32
    assert e.min() / grads > 0.02, (e.min(), grads)


def test_chees_inv_mass0_seed_survives_short_warmup():
    d = 12
    logprob, scales = _chees_target(d, 30.0)
    run = run_chees(gen(4), logprob, zeros(32, d), n_warmup=120, n_samples=400,
                    inv_mass0=scales ** 2)
    np.testing.assert_allclose(flat(run.samples).std(0), scales, rtol=0.2)
    np.testing.assert_allclose(run.inv_mass.numpy(), scales.numpy() ** 2, rtol=1.0)


def test_chees_fixed_continuation_matches_adaptive_moments():
    d = 8
    logprob, scales = _chees_target(d, 10.0)
    run = run_chees(gen(2), logprob, zeros(16, d), n_warmup=300, n_samples=200)
    cont = run_chees_fixed(gen(3), logprob, run.samples[-1], run.step, run.traj_len, run.inv_mass,
                           n_samples=600)
    S = flat(cont.samples)
    np.testing.assert_allclose(S.mean(0), 0.0, atol=0.4)
    np.testing.assert_allclose(S.std(0), scales, rtol=0.15)
    rhat = split_rhat(cont.samples).numpy()
    assert np.all(rhat < 1.05), rhat


@pytest.mark.parametrize("n_warmup", [0, 1, 5])
def test_chees_makes_exactly_n_warmup_transitions(n_warmup):
    """F3: the reference runs two warmup iterations for n_warmup of 0 or 1;
    the port runs exactly n_warmup.  With max_steps = 1 every transition is
    one batched gradient, and the run makes 1 (at x0) + n_warmup + n_samples."""
    calls = []

    def logprob(x):
        calls.append(x.shape[0])
        return gauss_logprob(x)

    run = run_chees(gen(0), logprob, zeros(8, DIM), n_warmup=n_warmup, n_samples=3, max_steps=1)
    assert len(calls) == 1 + n_warmup + 3 and set(calls) == {8}
    assert run.n_leapfrog_total == 3
    if n_warmup == 0:
        assert run.step.item() == pytest.approx(0.1) and run.traj_len.item() == pytest.approx(1.0)


def test_chees_axis_name_waits_for_the_multi_device_layer():
    """``axis_name`` is the chain axis's mesh of the multi-device layer: a
    name alone raises, and a mesh of world size 1 (no process group) is the
    single-process run bit for bit."""
    from flgp_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        run_chees(gen(0), gauss_logprob, zeros(4, DIM), n_warmup=2, n_samples=2, axis_name="c")
    with pytest.raises(TypeError):
        run_chees_fixed(gen(0), gauss_logprob, zeros(4, DIM), 0.1, 1.0, torch.ones(DIM), 2,
                        axis_name="c")
    mesh = make_mesh(axis_names=("chain",), device="cpu")
    x0 = torch.randn((8, DIM), generator=gen(1), dtype=torch.float64)
    ref = run_chees(gen(0), gauss_logprob, x0, n_warmup=30, n_samples=5)
    got = run_chees(gen(0), gauss_logprob, x0, n_warmup=30, n_samples=5, axis_name=mesh)
    for a, b in zip(ref[:5], got[:5]):
        assert torch.equal(a, b)


class _OnMeta:
    """A model that says it lives on another device."""

    device = torch.device("meta")

    def __call__(self, x):
        return gauss_logprob(x)


@pytest.mark.parametrize("driver", ["run_hmc", "run_nuts", "run_chees"])
def test_samplers_refuse_a_model_elsewhere(driver):
    fn = {"run_hmc": run_hmc, "run_nuts": run_nuts, "run_chees": run_chees}[driver]
    with pytest.raises(ValueError, match="model is on"):
        fn(gen(0), _OnMeta(), zeros(4, DIM), n_warmup=2, n_samples=2)
    assert fn(gen(0), gauss_logprob, zeros(4, DIM), n_warmup=2, n_samples=2).samples.shape == (
        2, 4, DIM)
