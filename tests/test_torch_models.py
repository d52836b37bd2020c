"""flgp_tpu_torch solve tail against flgp_tpu on the same inputs, in float64.

Deterministic stages (Newton mode, Laplace objective, 1-D optimizer,
Matheron draw, collapsed predictor, Laplace moments) get the same numpy
inputs and must agree to 1e-8 or tighter.  The Pólya-Gamma sampler is
random and the two RNG streams differ, so it is compared by its moments
within Monte-Carlo error.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optimize_parent
import pytest
import torch

from flgp_tpu import FitConfig as JFitConfig
from flgp_tpu.fit import drivers as jdrivers
from flgp_tpu.inference import pg_gibbs as jpg
from flgp_tpu.models import gpc as jgpc
from flgp_tpu.ops.polya_gamma import polya_gamma as jpolya_gamma
from flgp_tpu.types import EigenPair as JEigenPair

from flgp_tpu_torch.convert import eigenpair_from_numpy, fit_config_from_jax
from flgp_tpu_torch.fit import drivers
from flgp_tpu_torch.inference import pg_gibbs as tpg
from flgp_tpu_torch.models import gpc
from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.ops import polya_gamma as pg
from flgp_tpu_torch.ops.polya_gamma import polya_gamma, polya_gamma_counts, polya_gamma_int
from flgp_tpu_torch.utils import metrics

torch.set_num_threads(1)

SIGMA = 1e-3


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _problem(rng, m, K, n=80, counts=False):
    """A spectral pair and binary (or binomial-count) labels on its first m rows."""
    values = np.sort(rng.uniform(0.05, 1.0, size=K))[::-1].copy()
    vectors = rng.normal(size=(n, K))
    N = rng.integers(1, 4, size=m).astype(np.float64) if counts else np.ones(m)
    Y = np.floor(N * rng.uniform(size=m) + 0.5 * (vectors[:m, 0] > 0)).clip(0, N)
    return values, vectors, Y, N


def _both(values, vectors):
    return (eigenpair_from_numpy(values, vectors),
            JEigenPair(jnp.asarray(values), jnp.asarray(vectors)))


def _spd(rng, m, p=0):
    A = rng.normal(size=(m, m))
    C = A @ A.T / m + 0.1 * np.eye(m)
    return C, rng.normal(size=(p, m)) if p else None


# ---------------------------------------------------------------------------
# Laplace-Newton and the objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,K,counts", [(20, 30, False), (40, 10, False), (30, 12, True)],
                         ids=["dense", "woodbury", "woodbury-counts"])
@pytest.mark.parametrize("t", [0.5, 40.0])
def test_newton_objective_matches_reference(rng, m, K, counts, t):
    values, vectors, Y, N = _problem(rng, m, K, counts=counts)
    eig_t, eig_j = _both(values, vectors)
    got = gpc.gpc_nmll_objective_status(eig_t, T(Y), T(N), slice(0, m), K, t, SIGMA)
    ref = jgpc.gpc_nmll_objective_status(eig_j, jnp.asarray(Y), jnp.asarray(N), jnp.arange(m),
                                         K, jnp.asarray(t), SIGMA)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-10, atol=1e-8)
    assert int(got[1]) == int(ref[1])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6, atol=1e-12)
    nlp = gpc.gpc_nlp_objective(eig_t, T(Y), T(N), slice(0, m), K, t, SIGMA)
    nlp_ref = jgpc.gpc_nlp_objective(eig_j, jnp.asarray(Y), jnp.asarray(N), jnp.arange(m), K,
                                     jnp.asarray(t), SIGMA)
    np.testing.assert_allclose(float(nlp), float(nlp_ref), rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("m,K", [(20, 30), (40, 10)], ids=["dense", "woodbury"])
def test_batched_lanes_freeze_like_lanes_run_alone(rng, m, K):
    """Lanes converge after different iteration counts; each frozen lane must
    hold exactly the state it reached, as when it runs alone (and as the
    JAX package's vmapped while_loop)."""
    values, vectors, Y, N = _problem(rng, m, K)
    eig_t, eig_j = _both(values, vectors)
    ts = [1e-3, 0.3, 3.0, 30.0, 300.0, 3e3]
    obj, its, deltas = gpc.gpc_nmll_objective_status(eig_t, T(Y), T(N), slice(0, m), K,
                                                      T(ts), SIGMA, max_iter=30)
    assert obj.shape == (len(ts),)
    assert len(set(its.tolist())) > 1          # the lanes really stop at different rounds
    for i, t in enumerate(ts):
        alone = gpc.gpc_nmll_objective_status(eig_t, T(Y), T(N), slice(0, m), K, t, SIGMA,
                                              max_iter=30)
        assert int(alone[1]) == int(its[i])
        np.testing.assert_allclose(float(alone[0]), float(obj[i]), rtol=1e-12, atol=1e-10)
        # Σ|Δf| is a difference of nearly equal iterates: batched and single BLAS
        # calls round f (of order 1) differently at ~1e-14 per entry
        np.testing.assert_allclose(float(alone[2]), float(deltas[i]), rtol=1e-6, atol=1e-11)
    ref = jax.vmap(lambda t: jgpc.gpc_nmll_objective_status(
        eig_j, jnp.asarray(Y), jnp.asarray(N), jnp.arange(m), K, t, SIGMA, max_iter=30))(
        jnp.asarray(ts))
    np.testing.assert_array_equal(its.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(obj.numpy(), np.asarray(ref[0]), rtol=1e-10, atol=1e-8)


def test_posterior_moments_match_reference(rng):
    m, p = 25, 40
    C11, C21 = _spd(rng, m, p)
    C22 = rng.uniform(1.0, 2.0, size=p)
    Y = (rng.uniform(size=m) > 0.5).astype(np.float64)
    mean, cov = gpc.gpc_posterior_moments(T(C11), T(C21), T(C22), T(Y))
    mr, cr = jgpc.gpc_posterior_moments(jnp.asarray(C11), jnp.asarray(C21), jnp.asarray(C22),
                                        jnp.asarray(Y))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mr), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(cov.numpy(), np.asarray(cr), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the 1-D optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,K", [(20, 30), (40, 10)], ids=["dense", "woodbury"])
def test_train_gpc_selects_reference_t(rng, m, K):
    """minimize_1d_log on the GPC objective: coarse scan with the 30-step
    surrogate, window expansion, exact re-rank of the top 3, 4×32 refinement."""
    values, vectors, Y, N = _problem(rng, m, K)
    eig_t, eig_j = _both(values, vectors)
    jcfg = JFitConfig(dtype=jnp.float64)
    res = drivers._train_gpc(eig_t, T(Y), T(N), slice(0, m), K, fit_config_from_jax(jcfg))
    ref = jdrivers._train_gpc(eig_j, jnp.asarray(Y), jnp.asarray(N), jnp.arange(m), K, jcfg)
    np.testing.assert_allclose(float(res.x), float(ref.x), rtol=1e-6)
    np.testing.assert_allclose(float(res.obj), float(ref.obj), rtol=1e-9, atol=1e-9)
    assert res.n_expansions == int(ref.n_expansions)
    np.testing.assert_allclose(float(res.bracket_logwidth), float(ref.bracket_logwidth), rtol=1e-9)


def test_minimize_1d_log_expands_past_the_window():
    from flgp_tpu.inference.optimize import minimize_1d_log as jmin
    from flgp_tpu_torch.inference.optimize import minimize_1d_log

    # minimum at x = 5e4, above the initial window [1e-2, 1e3]; non-finite values count as +inf
    def f_t(x):
        return torch.where(x < 2e-2, torch.nan, (torch.log(x) - np.log(5e4)) ** 2)

    def f_j(x):
        return jnp.where(x < 2e-2, jnp.nan, (jnp.log(x) - np.log(5e4)) ** 2)

    res = minimize_1d_log(f_t, dtype=torch.float64, device="cpu")
    ref = jmin(f_j, dtype=jnp.float64)
    assert res.n_expansions == int(ref.n_expansions) >= 1
    np.testing.assert_allclose(float(res.x), float(ref.x), rtol=1e-9)
    np.testing.assert_allclose(float(res.x), 5e4, rtol=1e-3)


def _expanding(x):
    # minimum at x = 5e4, above the initial window [1e-2, 1e3]; non-finite values count as +inf
    return torch.where(x < 2e-2, torch.nan, (torch.log(x) - np.log(5e4)) ** 2)


def _pinned(x):
    # decreasing everywhere: every window pins to its top, up to max_expand
    return -torch.log(x)


def _bumpy(x):
    # many local minima: the surrogate's top 3 and the exact re-rank differ
    u = torch.log(x)
    return torch.cos(3.0 * u) + 0.05 * (u - 2.0) ** 2


@pytest.mark.parametrize("f", [_expanding, _pinned, _bumpy])
@pytest.mark.parametrize("surrogate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_problem_is_the_parent_s_search_bit_for_bit(f, surrogate, dtype):
    """A scalar objective, and the same objective as one problem of the
    problem axis, give the one-problem optimizer's values bit for bit, its
    window shifts and its host syncs."""
    from flgp_tpu_torch.inference.optimize import minimize_1d_log

    coarse = (lambda x: f(x) + 0.1 * torch.sin(x)) if surrogate else None
    kw = dict(dtype=dtype, device="cpu", n_grid=16)
    def syncs_of(search):
        before = metrics.COUNTS["host_syncs"]
        res = search()
        return res, metrics.COUNTS["host_syncs"] - before

    ref, ref_syncs = syncs_of(lambda: optimize_parent.minimize_1d_log(f, coarse_fn=coarse, **kw))
    lift = lambda g: None if g is None else (lambda x, rows: g(x[0])[None])  # noqa: E731
    for search in (lambda: minimize_1d_log(f, coarse_fn=coarse, **kw),
                   lambda: minimize_1d_log(lift(f), coarse_fn=lift(coarse), problems=1,
                                           **kw).first()):
        got, syncs = syncs_of(search)
        assert got.n_expansions == ref.n_expansions and syncs == ref_syncs
        for a, b in zip(got[:3], ref[:3]):
            assert a.shape == b.shape == () and torch.equal(a, b)
    assert ref.n_expansions == {_expanding: 1, _pinned: 4, _bumpy: 0}[f]


@pytest.mark.parametrize("m,K", [(20, 30), (40, 10)], ids=["dense", "woodbury"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_binary_training_is_the_parent_s_bit_for_bit(rng, m, K, dtype):
    """``_train_gpc`` on labels (m,), one problem of the problem axis, gives
    the one-problem training's t, objective, bracket and shifts bit for bit,
    with its Newton rounds and host syncs to the count."""
    values, vectors, Y, N = _problem(rng, m, K)
    eig = eigenpair_from_numpy(values, vectors, dtype=dtype)
    cfg = fit_config_from_jax(JFitConfig(dtype=jnp.float64))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    Y, N = T(Y, dtype), T(N, dtype)
    keys = ("newton_rounds", "host_syncs")
    before = {k: metrics.COUNTS[k] for k in keys}
    ref = optimize_parent.train_gpc(eig, Y, N, slice(0, m), K, cfg)
    mid = {k: metrics.COUNTS[k] for k in keys}
    got = drivers._train_gpc(eig, Y, N, slice(0, m), K, cfg)
    for k in keys:
        assert metrics.COUNTS[k] - mid[k] == mid[k] - before[k] > 0, k
    assert got.n_expansions == ref.n_expansions
    for a, b in zip(got[:3], ref[:3]):
        assert a.shape == b.shape == () and torch.equal(a, b)


# ---------------------------------------------------------------------------
# PG Gibbs: the deterministic maps, then the sampler by its moments
# ---------------------------------------------------------------------------


def test_conditional_draw_matches_reference(rng):
    m = 30
    C, _ = _spd(rng, m)
    L_C = np.linalg.cholesky(C + 1e-10 * np.eye(m))
    kappa = (rng.uniform(size=m) > 0.5) - 0.5
    omega = rng.uniform(0.05, 0.3, size=m)
    e1, e2 = rng.normal(size=m), rng.normal(size=m)
    got = tpg._conditional_draw(T(C), T(L_C), T(kappa), T(omega), T(e1), T(e2))
    ref = jpg._conditional_draw(*(jnp.asarray(a) for a in (C, L_C, kappa, omega, e1, e2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_collapsed_predict_matches_reference(rng):
    m, p, S = 25, 35, 4
    C, Cnv = _spd(rng, m, p)
    Y = (rng.uniform(size=m) > 0.5).astype(np.float64)
    omegas = rng.uniform(0.05, 0.3, size=(S, m))
    got = tpg.collapsed_predict(T(C), T(Cnv), T(Y), T(omegas))          # batched over ω
    for s_ in range(S):
        ref = jpg.collapsed_predict(jnp.asarray(C), jnp.asarray(Cnv), jnp.asarray(Y),
                                    jnp.asarray(omegas[s_]))
        np.testing.assert_allclose(got[s_].numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
        single = tpg.collapsed_predict(T(C), T(Cnv), T(Y), T(omegas[s_]))
        np.testing.assert_allclose(single.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def _pg_moments(c):
    """Closed-form mean and variance of PG(1, c)."""
    c = np.asarray(c, dtype=np.float64)
    mean = np.where(c == 0, 0.25, np.tanh(c / 2) / (2 * np.where(c == 0, 1, c)))
    cs = np.where(c == 0, 1.0, c)
    var = np.where(c == 0, 1 / 24, (np.sinh(cs) - cs) / (4 * cs**3 * np.cosh(cs / 2) ** 2))
    return mean, var


def test_polya_gamma_moments_match_closed_form_and_reference():
    cs = np.array([0.0, 0.5, 2.0, 8.0])
    S = 20000
    c = np.repeat(cs[:, None], S, axis=1)
    draws = polya_gamma(torch.Generator().manual_seed(0), T(c)).numpy()
    jdraws = np.asarray(jpolya_gamma(jax.random.PRNGKey(0), jnp.asarray(c)))
    mean, var = _pg_moments(cs)
    se_mean = np.sqrt(var / S)
    assert np.all(draws > 0)
    np.testing.assert_array_less(np.abs(draws.mean(1) - mean), 5 * se_mean)
    np.testing.assert_array_less(np.abs(draws.mean(1) - jdraws.mean(1)), 5 * np.sqrt(2) * se_mean)
    # variance: its MC standard error is ~ sd(x²)/√S; 15% is > 5 such errors at S=2e4
    np.testing.assert_allclose(draws.var(1), var, rtol=0.15)


def test_polya_gamma_counts_scale_the_mean():
    c = np.repeat(np.array([1.0, 3.0]), 10000)
    N = np.tile([1, 3], 10000)[:c.size]
    c = np.sort(c)
    draws = polya_gamma_counts(torch.Generator().manual_seed(1), T(N, torch.int64), T(c), 3).numpy()
    mean, var = _pg_moments(c)
    for cv in (1.0, 3.0):
        for nv in (1, 3):
            sel = (c == cv) & (N == nv)
            se = np.sqrt(nv * var[sel][0] / sel.sum())
            assert abs(draws[sel].mean() - nv * mean[sel][0]) < 5 * se


@pytest.mark.parametrize("b", [1, 4])
def test_polya_gamma_int_mean(b):
    """PG(b, c) is the sum of b PG(1, c) draws: mean b·tanh(c/2)/(2c) and
    variance b times PG(1, c)'s, within Monte Carlo error."""
    cs = np.array([0.0, 1.5, 6.0])
    S = 20000
    c = np.repeat(cs[:, None], S, axis=1)
    draws = polya_gamma_int(torch.Generator().manual_seed(2), b, T(c)).numpy()
    mean, var = _pg_moments(cs)
    assert draws.shape == c.shape and np.all(draws > 0)
    np.testing.assert_array_less(np.abs(draws.mean(1) - b * mean), 5 * np.sqrt(b * var / S))
    np.testing.assert_allclose(draws.var(1), b * var, rtol=0.15)


@pytest.mark.parametrize("device_type,dtype,kernel", [
    ("cuda", torch.float32, True), ("cuda", torch.float64, True),
    ("cpu", torch.float32, False), ("cpu", torch.float64, False),
    ("cuda", torch.float16, True), ("cuda", torch.bfloat16, True)])
def test_pg_on_kernel_at_its_cases(device_type, dtype, kernel):
    """The one predicate of the draw's path is the device: every draw on the
    card takes the kernel, whose wrapper raises on a dtype other than
    float32 and float64, so a half-precision draw on the card raises where
    it would otherwise fall back to the loop."""
    assert pg.pg_on_kernel(device_type, dtype) is kernel
    if dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError, match="float32 or float64"):
            hk.polya_gamma(torch.ones(8, dtype=dtype), torch.zeros(2, dtype=torch.int64))


# 10,000 draws of the reference sampler at each of three c, kept as a file so
# that the card tests, which run without JAX, hold the kernel to its law
# (tests/test_torch_cuda.py); ``reference_pg_draws`` writes it.
REFERENCE_PG_DRAWS = Path(__file__).parent / "data" / "pg_jax_draws.npz"
REFERENCE_PG_CS = (0.5, 3.0, 12.0)


def reference_pg_draws(path=None) -> np.ndarray:
    """``flgp_tpu.ops.polya_gamma.polya_gamma`` at REFERENCE_PG_CS, 10,000
    lanes each from PRNGKey(2024), as float32 (3, 10000); saved with the c
    values to ``path`` if given."""
    cs = np.asarray(REFERENCE_PG_CS)
    c = jnp.repeat(jnp.asarray(cs)[:, None], 10_000, axis=1)
    draws = np.asarray(jpolya_gamma(jax.random.PRNGKey(2024), c), np.float32)
    if path is not None:
        np.savez(path, c=cs, draws=draws)
    return draws


def test_reference_pg_draws_file_holds_the_reference_sampler_s_draws():
    """The file the card tests read is the reference sampler's output from
    its key.  A lane whose accept/reject test sits within an ulp of its cut
    may decide otherwise on another CPU's transcendental functions, so at
    most one lane in a thousand may differ; every other lane is the same
    float32."""
    saved = np.load(REFERENCE_PG_DRAWS)
    assert np.array_equal(saved["c"], np.asarray(REFERENCE_PG_CS))
    fresh = reference_pg_draws()
    assert saved["draws"].shape == fresh.shape == (3, 10_000)
    assert np.mean(saved["draws"] != fresh) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_draw_is_the_loop_s_bits_and_counts_its_rounds(dtype):
    """On the CPU a draw is the plain loop's, J*(1, |c|/2)/4 from the
    caller's generator, bit for bit (no key drawn): it counts one
    ``pg_draws`` a call, its host rounds in ``pg_rounds``, and no launch."""
    c = T(np.random.default_rng(3).normal(scale=3.0, size=(4, 500)), dtype)
    c[1, 7] = float("nan")
    before = dict(metrics.COUNTS)
    got = polya_gamma(torch.Generator().manual_seed(11), c)
    counted = {k: metrics.COUNTS[k] - before.get(k, 0) for k in ("pg_draws", "pg_rounds")}
    want = pg._sample_jstar(torch.Generator().manual_seed(11), torch.abs(c) / 2.0) / 4.0
    assert torch.equal(got, want) and got.dtype == dtype
    assert counted["pg_draws"] == 1 and counted["pg_rounds"] > 0
    assert metrics.COUNTS["kernel_launches:polya_gamma"] == before.get(
        "kernel_launches:polya_gamma", 0)
    # the NaN lane ends at the caps: t/2 from the inner loops, accepted, or t
    assert any(torch.equal(got[1, 7], T(v, dtype)) for v in (pg._T / 8, pg._T / 4))
    before = metrics.COUNTS["pg_draws"]
    polya_gamma_int(torch.Generator().manual_seed(1), 3, c[0])
    polya_gamma_counts(torch.Generator().manual_seed(1), T([1, 2], torch.int64).repeat(250),
                       c[0], 2)
    assert metrics.COUNTS["pg_draws"] - before == 2


def test_the_kernel_s_wrapper_takes_no_cpu_tensor():
    """``hopper_kernels.polya_gamma`` has no fallback: a CPU tensor raises."""
    with pytest.raises(ValueError, match="CUDA"):
        hk.polya_gamma(torch.ones(8, dtype=torch.float64), torch.zeros(2, dtype=torch.int64))


def test_the_kernel_keeps_the_loop_s_constants():
    """csrc/polya_gamma.cu runs the loop's sampler: the cut point, the round
    caps and the fallbacks' values are ``ops/polya_gamma.py``'s."""
    import re

    src = (Path(pg.__file__).resolve().parent.parent / "csrc" / "polya_gamma.cu").read_text()

    def constant(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.]+);", src).group(1))

    assert constant("kT") == pg._T
    assert constant("kMaxRounds") == pg._MAX_ROUNDS
    assert constant("kMaxInner") == pg._MAX_INNER
    assert constant("kMaxTerms") == pg._MAX_TERMS
    assert "return T(0.5 * kT);" in src and "return T(kT);" in src


def test_test_pgbinary_rao_blackwellized_shapes(rng):
    m, p = 20, 15
    C, Cnv = _spd(rng, m, p)
    Y = (rng.uniform(size=m) > 0.5).astype(np.float64)
    labels, pi = tpg.test_pgbinary(torch.Generator().manual_seed(2), T(C), T(Y), T(Cnv),
                                   n_sweeps=12, avg_sweeps=5)
    assert labels.shape == (p,) and pi.shape == (p,)
    assert torch.all((pi > 0) & (pi < 1))
    np.testing.assert_array_equal(labels.numpy(), (pi.numpy() > 0.5).astype(np.float64))
    final_only, _ = tpg.test_pgbinary(torch.Generator().manual_seed(2), T(C), T(Y), T(Cnv),
                                      n_sweeps=12, avg_sweeps=0)
    assert final_only.shape == (p,)


def test_fit_config_round_trip():
    from flgp_tpu import GraphConfig as JGraph, TrainConfig as JTrain
    jcfg = JFitConfig(graph=JGraph(s=50, r=4, K=20, gl="normalized", subsample="random"),
                      train=JTrain(grid_size=8, newton_tol=1e-6), sigma=2e-3, n_gibbs=40,
                      gibbs_avg_sweeps=10, dtype=jnp.float32, solve_dtype=jnp.float64)
    cfg = fit_config_from_jax(jcfg)
    assert cfg.dtype == torch.float32 and cfg.solve_dtype == torch.float64
    for f in dataclasses.fields(cfg.graph):
        assert getattr(cfg.graph, f.name) == getattr(jcfg.graph, f.name)
    for f in dataclasses.fields(cfg.train):
        assert getattr(cfg.train, f.name) == getattr(jcfg.train, f.name)
    assert (cfg.sigma, cfg.n_gibbs, cfg.gibbs_avg_sweeps) == (2e-3, 40, 10)


# ---------------------------------------------------------------------------
# the ambient RBF Subset-of-Regressors baseline (models/rbf.py)
# ---------------------------------------------------------------------------


def _sqdist(A, B):
    return ((A[:, None, :] - B[None]) ** 2).sum(-1)


def _sor_problem(rng, m=80, s=20, d=1):
    """The reference test's shapes (tests/test_scale.py::TestRbfSor)."""
    X = np.sort(rng.uniform(-3, 3, size=(m, d)), axis=0)
    U = np.linspace(-3, 3, s)[:, None]
    Y = np.sin(X[:, 0]) + 0.05 * rng.normal(size=m)
    X_new = rng.uniform(-3, 3, size=(40, d))
    return _sqdist(U, U), _sqdist(X, U), _sqdist(X_new, U), Y, X_new


@pytest.mark.parametrize("per_point", [False, True])
def test_rbf_sor_nmll_and_predict_match_reference(rng, per_point):
    from flgp_tpu.models import rbf as jrbf

    from flgp_tpu_torch.models import rbf

    dUU, dXU, dNU, Y, _ = _sor_problem(rng)
    noise = rng.uniform(0.01, 0.2, size=Y.shape[0]) if per_point else 0.05
    for t in (0.3, 2.0):
        got = rbf.rbf_sor_nmll(T(dUU), T(dXU), T(Y), t, T(noise), 1e-5)
        ref = jrbf.rbf_sor_nmll(jnp.asarray(dUU), jnp.asarray(dXU), jnp.asarray(Y), t,
                                jnp.asarray(noise), 1e-5)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-10)
        got = rbf.rbf_sor_nmll_posterior(T(dUU), T(dXU), T(Y), t, T(noise), 1e-5)
        ref = jrbf.rbf_sor_nmll_posterior(jnp.asarray(dUU), jnp.asarray(dXU), jnp.asarray(Y), t,
                                          jnp.asarray(noise), 1e-5)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-10)
        got = rbf.predict_rbf_sor(T(dUU), T(dXU), T(dNU), T(Y), t, T(noise), 1e-5)
        ref = jrbf.predict_rbf_sor(jnp.asarray(dUU), jnp.asarray(dXU), jnp.asarray(dNU),
                                   jnp.asarray(Y), t, jnp.asarray(noise), 1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-10)


def test_rbf_sor_batched_lanes_are_the_lanes_alone(rng):
    from flgp_tpu_torch.models import rbf

    dUU, dXU, _, Y, _ = _sor_problem(rng)
    ts, noises = T([[0.3, 1.0], [2.0, 5.0]]), T([[0.05, 0.1], [0.2, 0.01]])
    batched = rbf.rbf_sor_nmll(T(dUU), T(dXU), T(Y), ts, noises, 1e-5)
    for i in range(2):
        for j in range(2):
            alone = rbf.rbf_sor_nmll(T(dUU), T(dXU), T(Y), ts[i, j], noises[i, j], 1e-5)
            np.testing.assert_allclose(float(batched[i, j]), float(alone), rtol=1e-12)


@pytest.mark.parametrize("per_point", [False, True])
def test_train_rbf_sor_fits(rng, per_point):
    """The reference test's gate, rmse < 0.2 on sin, and the objective the
    trainer returns is the NMLL at its (t, noise).  The trajectories are not
    held to the reference's: S_UU at these shapes has a condition number
    near 1e16, so the two autodiffs' gradients differ and Adam's paths part
    (each side's gradient norm at its end is O(10))."""
    from flgp_tpu_torch.models import rbf

    dUU, dXU, dNU, Y, X_new = _sor_problem(rng)
    got = rbf.train_rbf_sor(T(dUU), T(dXU), T(Y), per_point_noise=per_point,
                            dtype=torch.float64)
    again = rbf.rbf_sor_nmll_posterior(T(dUU), T(dXU), T(Y), got.t, got.noise, 1e-5)
    np.testing.assert_allclose(float(got.obj), float(again), rtol=1e-10)
    assert got.noise.shape == ((80,) if per_point else ())
    pred = rbf.predict_rbf_sor(T(dUU), T(dXU), T(dNU), T(Y), got.t, got.noise, 1e-5).numpy()
    assert np.sqrt(np.mean((pred - np.sin(X_new[:, 0])) ** 2)) < 0.2
