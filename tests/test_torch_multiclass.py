"""The multiclass drivers of flgp_tpu_torch against flgp_tpu's, float64, on
the CPU (``device="cpu"``), with the deterministic subsampler sums (W4).

The reference's internals run on one shared spectrum (its own LAE spectrum of
three Gaussian blobs, carried over by ``convert``), so every deterministic
piece is compared tightly: per-class t to rtol 1e-6, objectives to 1e-8,
Laplace moments to 1e-8.  PG-Gibbs labels come from two random streams and
are compared by agreement.  The grid drivers' selection runs the reference's
own bases through the port's grid; the entry points end to end are held to
the reference tests' accuracy gates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.fit import multiclass as jmc
from flgp_tpu.fit import spectral as jspectral
from flgp_tpu.models import gpc as jgpc
from flgp_tpu.ops import kmeans as jkmeans

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import (
    eigenpair_from_numpy,
    fit_config_from_jax,
    nystrom_basis_from_jax,
    se_grid_basis_from_jax,
)
from flgp_tpu_torch.datasets import gaussian_blobs
from flgp_tpu_torch.fit import drivers
from flgp_tpu_torch.fit import multiclass as mc
from flgp_tpu_torch.inference import pg_gibbs
from flgp_tpu_torch.models import gpc
from flgp_tpu_torch.ops import kmeans

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
A2S = (0.5, 1.0, 2.0)
JCFG = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=30, r=3, K=15), a2s=A2S,
                          train=flgp_tpu.TrainConfig(grid_size=16, adam_steps=80),
                          n_gibbs=60, gibbs_avg_sweeps=30, dtype=jnp.float64)
CFG = fit_config_from_jax(JCFG)
K = 15


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@functools.partial(jax.jit, static_argnames=("K", "cfg"))
def _jtrain(eig, aug_y, idx, K, cfg):
    return jmc._train_mult(eig, aug_y, idx, K, cfg)


@pytest.fixture(scope="module")
def blobs():
    """Three blobs (60 labelled of 120), the reference's LAE spectrum of them
    and its per-class training on that spectrum."""
    data = gaussian_blobs(n_per_class=40, n_classes=3, sep=6.0)
    X_all = np.concatenate([data.x_train, data.x_test])
    m, n = len(data.y_train), len(X_all)
    jeig, _ = jspectral.build_spectrum(KEY, jnp.asarray(X_all), JCFG.graph)
    jaug = jmc.one_hot_labels(jnp.asarray(data.y_train), 3)
    jres = _jtrain(jeig, jaug, jnp.arange(m), K, JCFG)
    eig = eigenpair_from_numpy(np.asarray(jeig.values), np.asarray(jeig.vectors))
    aug = mc.one_hot_labels(torch.as_tensor(data.y_train), 3)
    return dict(data=data, X_all=X_all, m=m, n=n, jeig=jeig, jaug=jaug, jres=jres, eig=eig,
                aug=aug)


# ---------------------------------------------------------------------------
# W4: the subsampler's sums add in an order fixed by the data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sums_are_the_float64_sums(rng, dtype):
    X = rng.normal(scale=3.0, size=(5000, 3)) + 2.0
    assign = rng.integers(0, 37, size=5000)
    assign[assign == 5] = 6                             # an empty cluster sums to 0
    Xt = torch.as_tensor(X, dtype=dtype)
    got = kmeans._segment_sums(Xt, torch.as_tensor(assign), 37)
    assert got.dtype == torch.float64
    Xd = Xt.double().numpy()
    for j in range(37):
        ref = np.array([np.float64(sum(map(float, Xd[assign == j, c]))) for c in range(3)])
        exact = [np.float64(np.sum(np.abs(Xd[assign == j, c]))) for c in range(3)]
        assert np.all(np.abs(got[j].numpy() - ref) <= 1e-12 * np.maximum(exact, 1e-300)), j
    if dtype == torch.float64:
        # the CPU's index_add_ adds in row order too: the same bits
        ref = torch.zeros((37, 3), dtype=dtype).index_add_(0, torch.as_tensor(assign), Xt)
        assert torch.equal(got, ref)


def test_update_means_and_keeps_empty_centers(rng):
    X = torch.as_tensor(rng.normal(size=(400, 2)), dtype=torch.float32)
    assign = torch.as_tensor(rng.integers(0, 9, size=400))
    assign[assign == 4] = 3
    old = torch.full((9, 2), 7.0)
    centers, counts = kmeans._update(X, assign, 9, old)
    assert counts.dtype == torch.float32 and float(counts[4]) == 0.0
    assert torch.equal(centers[4], old[4])
    for j in (0, 3, 8):
        ref = X.double()[assign == j].sum(0) / float((assign == j).sum())
        torch.testing.assert_close(centers[j].double(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["kmeans", "minibatchkmeans"])
def test_subsample_twice_from_one_seed_is_the_same_bits(rng, method):
    """k-means‖ seeding with its weighted polish (n ≥ 4s, s ≥ 64) then Lloyd,
    and mini-batch k-means: one seed, one set of anchors."""
    X = torch.as_tensor(rng.normal(size=(2000, 2)), dtype=torch.float32)
    a, b = (kmeans.subsample(gen(3), X, 64, method=method, iters=30) for _ in range(2))
    assert torch.equal(a.centers, b.centers) and torch.equal(a.counts, b.counts)
    assert float(a.counts.sum()) == 2000


def test_lloyd_f32_from_same_init_matches_reference(rng):
    """float32 Lloyd (the card's path) from one init, against the reference's
    float64 Lloyd: the same assignments, centers to float32 rounding."""
    X = rng.normal(size=(600, 2)) + 4.0 * rng.integers(0, 3, size=(600, 1))
    init = X[rng.choice(600, 12, replace=False)]
    c, counts, _ = kmeans.lloyd(torch.as_tensor(X, dtype=torch.float32),
                                torch.as_tensor(init, dtype=torch.float32), 100)
    cj, countsj, _ = jkmeans.lloyd(jnp.asarray(X), jnp.asarray(init), 100)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(countsj))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# labels, posterior, training on the reference's spectrum
# ---------------------------------------------------------------------------


def test_one_hot_labels_is_the_reference_s():
    Y = np.array([2.0, 0.0, 1.0, 3.0, 0.0])
    got = mc.one_hot_labels(torch.as_tensor(Y), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmc.one_hot_labels(jnp.asarray(Y), 4)))
    assert got.dtype == torch.float64


def test_gpc_posterior_from_spectrum_matches_reference(blobs):
    m, n, t = blobs["m"], blobs["n"], 3.7
    y = blobs["data"].y_train == 1.0
    ref = jgpc.gpc_posterior_from_spectrum(blobs["jeig"], jnp.asarray(y, jnp.float64),
                                           jnp.arange(m), jnp.arange(m, n), K, t, 1e-3)
    got = gpc.gpc_posterior_from_spectrum(blobs["eig"], torch.as_tensor(y, dtype=torch.float64),
                                          slice(0, m), slice(m, n), K, t, 1e-3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


def test_gpc_marginal_wrappers_are_the_status_values(blobs):
    m = blobs["m"]
    eig = blobs["eig"]
    y = torch.as_tensor(blobs["data"].y_train == 2.0, dtype=torch.float64)
    N = torch.ones(m, dtype=torch.float64)
    Phi = eig.vectors[:m, :K] * torch.exp(-0.5 * 2.0 * eig.laplacian_eigenvalues(K))
    low = gpc.gpc_marginal_log_likelihood_lowrank(Phi, y, N, 1e-3)
    dense = gpc.gpc_marginal_log_likelihood(Phi @ Phi.T + 1e-3 * torch.eye(m), y, N)
    assert float(low) == float(gpc.gpc_marginal_log_likelihood_lowrank_status(Phi, y, N, 1e-3)[0])
    np.testing.assert_allclose(float(low), float(dense), rtol=1e-8)
    ref = jgpc.gpc_marginal_log_likelihood_lowrank(jnp.asarray(Phi.numpy()), jnp.asarray(y.numpy()),
                                                   jnp.asarray(N.numpy()), 1e-3)
    np.testing.assert_allclose(float(low), float(ref), rtol=1e-10)


def test_train_mult_matches_reference(blobs):
    res = mc._train_mult(blobs["eig"], blobs["aug"], blobs["m"], K, CFG)
    jres = blobs["jres"]
    assert res.x.shape == (3,)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-6)
    np.testing.assert_allclose(res.obj.numpy(), np.asarray(jres.obj), rtol=1e-8)


def _shifting_problem(m, K, n=80):
    """A spectrum whose top pair is (1, a constant vector) and three label
    columns: all ones, which wants a t above the others', a split on the
    second vector and coin flips."""
    rng = np.random.default_rng(1)
    values = np.sort(rng.uniform(0.05, 0.9, size=K))[::-1].copy()
    values[0] = 1.0
    vectors = rng.normal(size=(n, K))
    vectors[:, 0] = 2.0
    cols = [np.ones(m), (vectors[:m, 1] > 0).astype(float),
            (rng.uniform(size=m) < 0.5).astype(float)]
    return eigenpair_from_numpy(values, vectors), torch.as_tensor(np.stack(cols, 1))


def _recording_training(monkeypatch):
    """Patch the training so that each evaluation of the objective records
    the problems it ran (None: all) and each Newton solve its lanes' final
    iteration counts; returns the two lists, in call order."""
    rows, its = [], []
    minimize, iterate = drivers.minimize_1d_log, gpc._iterate_lanes

    def spy(fn):
        def evaluate(t, r):
            rows.append(r)
            return fn(t, r)
        return evaluate

    def minimize_spied(fn, **kw):
        return minimize(spy(fn), **dict(kw, coarse_fn=spy(kw["coarse_fn"])))

    def iterate_recorded(*args):
        st = iterate(*args)
        its.append(st.it.clone())
        return st

    monkeypatch.setattr(drivers, "minimize_1d_log", minimize_spied)
    monkeypatch.setattr(gpc, "_iterate_lanes", iterate_recorded)
    return rows, its


@pytest.mark.parametrize("m,K,t_ub,shifts", [(40, 10, 10.0, [1, 0, 0]), (40, 10, 0.03, [3, 2, 2]),
                                             (20, 30, 10.0, [1, 0, 1]), (20, 30, 0.03, [3, 2, 3])],
                         ids=["woodbury-one-shifts", "woodbury-all-shift", "dense-two-shift",
                              "dense-all-shift"])
def test_train_mult_is_each_class_s_lone_training(m, K, t_ub, shifts, monkeypatch):
    """The J classes solved together give each class its lone run: the same
    window shifts, the same Newton iteration count in every lane of every
    evaluation it takes part in, and its t, objective and bracket, in float64
    on both forms of the objective (m > K: the Woodbury dual; m ≤ K: dense),
    with one class shifting its window more often than another."""
    eig, Y = _shifting_problem(m, K)
    cfg = ft.FitConfig(dtype=torch.float64, train=ft.TrainConfig(t_ub=t_ub, grid_size=16))
    N = torch.ones(m, dtype=torch.float64)
    rows, its = _recording_training(monkeypatch)
    joint = mc._train_mult(eig, Y, m, K, cfg)
    joint_rows, joint_its = list(rows), list(its)
    assert joint.x.shape == joint.obj.shape == joint.bracket_logwidth.shape == (3,)
    assert joint.n_expansions == shifts
    for j in range(3):
        rows.clear()
        its.clear()
        lone = drivers._train_gpc(eig, Y[:, j], N, slice(0, m), K, cfg)
        assert lone.x.dim() == 0 and joint.n_expansions[j] == lone.n_expansions
        for got, want in zip(joint[:3], lone[:3]):
            np.testing.assert_allclose(float(got[j]), float(want), rtol=1e-12, atol=0)
        assert rows == [None] * len(its)
        mine = [it[(list(range(3)) if r is None else r).index(j)]
                for r, it in zip(joint_rows, joint_its) if r is None or j in r]
        assert len(mine) == len(its)
        for a, b in zip(mine, its):
            assert torch.equal(a, b[0])


def test_posterior_mult_matches_reference(blobs):
    m, n, ts = blobs["m"], blobs["n"], np.asarray(blobs["jres"].x)
    ref = jmc._posterior_mult(blobs["jeig"], blobs["jaug"], jnp.asarray(ts), jnp.arange(m),
                              jnp.arange(m, n), K, 1e-3)
    got = mc._posterior_mult(blobs["eig"], blobs["aug"], torch.as_tensor(ts), m, n, K, 1e-3)
    for a, b in zip(got, ref):
        assert a.shape == (n - m, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)


def test_predict_mult_agrees_with_reference(blobs):
    """Two RNG streams: labels agree on ≥ 95% of points, the class
    probabilities within the chains' Monte-Carlo error."""
    m, n, ts = blobs["m"], blobs["n"], np.asarray(blobs["jres"].x)
    jlabels, jprobs = jmc._predict_mult(KEY, blobs["jeig"], blobs["jaug"], jnp.asarray(ts),
                                        jnp.arange(m), jnp.arange(n), K, JCFG)
    labels, probs = mc._predict_mult(gen(), blobs["eig"], blobs["aug"], torch.as_tensor(ts), m, n,
                                     K, CFG)
    assert labels.shape == (n,) and probs.shape == (3, n) and labels.dtype == torch.float64
    assert np.mean(labels.numpy() == np.asarray(jlabels)) >= 0.95
    diff = np.abs(probs.numpy() - np.asarray(jprobs))
    assert diff.mean() < 0.03 and diff.max() < 0.3, (diff.mean(), diff.max())
    y = blobs["data"]
    assert np.mean(labels.numpy()[m:] != y.y_test) < 0.15


# ---------------------------------------------------------------------------
# the batched PG-Gibbs chain
# ---------------------------------------------------------------------------


def _spd(rng, J, m):
    A = rng.normal(size=(J, m, m))
    return torch.as_tensor(A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m))


def test_conditional_draw_with_a_class_axis_is_the_per_class_draws(rng):
    J, m = 4, 25
    C = _spd(rng, J, m)
    L_C = torch.linalg.cholesky(C)
    kappa, eps1, eps2 = (torch.as_tensor(rng.normal(size=(J, m))) for _ in range(3))
    omega = torch.as_tensor(rng.uniform(0.01, 2.0, size=(J, m)))
    got = pg_gibbs._conditional_draw(C, L_C, kappa, omega, eps1, eps2)
    assert got.shape == (J, m)
    for j in range(J):
        one = pg_gibbs._conditional_draw(C[j], L_C[j], kappa[j], omega[j], eps1[j], eps2[j])
        torch.testing.assert_close(got[j], one, rtol=0, atol=1e-12)


def test_pgbinary_on_one_class_keeps_its_results(rng):
    """A class axis of length one draws the same stream as the lone chain and
    gives its labels and probabilities."""
    m, n = 30, 50
    C = _spd(rng, 1, n)[0]
    Y = torch.as_tensor((rng.uniform(size=m) < 0.5).astype(np.float64))
    Cvv = C[:m, :m] + 1e-3 * torch.eye(m)
    labels, pi = pg_gibbs.test_pgbinary(gen(5), Cvv, Y, C[:, :m], 20, avg_sweeps=10)
    labels1, pi1 = pg_gibbs.test_pgbinary(gen(5), Cvv[None], Y[None], C[None, :, :m], 20,
                                          avg_sweeps=10)
    assert labels1.shape == (1, n)
    torch.testing.assert_close(pi1[0], pi, rtol=0, atol=1e-12)
    assert torch.equal(labels1[0], labels)


def test_collapsed_predict_with_a_class_axis_is_the_per_class_predictions(rng):
    S, J, m, n = 5, 3, 20, 45
    C = _spd(rng, J, n)
    Cvv = C[:, :m, :m] + 1e-3 * torch.eye(m)
    Y = torch.as_tensor((rng.uniform(size=(J, m)) < 0.5).astype(np.float64))
    omega = torch.as_tensor(rng.uniform(0.05, 1.0, size=(S, J, m)))
    got = pg_gibbs.collapsed_predict(Cvv, C[:, :, :m], Y, omega)
    assert got.shape == (S, J, n)
    for j in range(J):
        one = pg_gibbs.collapsed_predict(Cvv[j], C[j, :, :m], Y[j], omega[:, j])
        torch.testing.assert_close(got[:, j], one, rtol=0, atol=1e-12)


def test_pg_chain_trace_runs_classes_as_lanes_with_counts(rng):
    """Binomial counts broadcast over the class axis (``polya_gamma_counts``)."""
    J, m = 3, 20
    C = _spd(rng, J, m)
    Y = torch.as_tensor(rng.integers(0, 3, size=(J, m)).astype(np.float64))
    N = torch.full((m,), 3.0, dtype=torch.float64)
    state, f_trace, om_trace = pg_gibbs.pg_gibbs_chain_trace(gen(), C, Y, 8, N, 3)
    assert f_trace.shape == om_trace.shape == (8, J, m)
    assert bool(torch.all(torch.isfinite(f_trace))) and bool(torch.all(om_trace > 0))


# ---------------------------------------------------------------------------
# bandwidth-grid selection on the reference's bases
# ---------------------------------------------------------------------------


def _reference_grid(blobs, pair_at):
    """The reference's grid rule: per bandwidth train every class, keep the
    largest Σ_j −obj_j, the first on ties."""
    m = blobs["m"]
    results = [_jtrain(pair_at(a2), blobs["jaug"], jnp.arange(m), K, JCFG) for a2 in A2S]
    best = int(np.argmax([float(jnp.sum(-r.obj)) for r in results]))
    return A2S[best], results[best]


def _same_selection(got, a2, jres):
    assert float(got.pars["a2"]) == a2
    np.testing.assert_allclose(got.pars["t"], np.asarray(jres.x), rtol=1e-6)
    np.testing.assert_allclose(got.obj, float(jnp.sum(-jres.obj)), rtol=1e-8)
    assert got.posterior_mean.shape == got.posterior_cov.shape == (60, 3)


def test_se_grid_selection_matches_reference(blobs):
    k_spec, _ = jax.random.split(KEY)
    jbasis = jspectral.se_grid_setup(k_spec, jnp.asarray(blobs["X_all"]), JCFG.graph)
    a2, jres = _reference_grid(blobs, lambda a: jspectral.se_spectrum_at(jbasis, a, JCFG.graph))
    sub = se_grid_basis_from_jax(jbasis).sub
    Kp, spectrum_at, extend = drivers._se_family(None, torch.as_tensor(blobs["X_all"]), CFG,
                                                 (sub.centers, sub.counts), "cpu")
    got = mc._grid_mult(gen(), blobs["aug"], blobs["m"], blobs["n"], Kp, CFG, spectrum_at, extend)
    _same_selection(got, a2, jres)


def test_nystrom_grid_selection_matches_reference(blobs):
    k_spec, _ = jax.random.split(KEY)
    m, g = blobs["m"], JCFG.graph
    jbasis = jspectral.nystrom_setup(k_spec, jnp.asarray(blobs["X_all"]), g)

    def pair_at(a2):
        anchor, Z_UU = jspectral.nystrom_anchor_eigs(jbasis, a2, K)
        return jspectral.nystrom_extend(anchor, Z_UU, jbasis.dist_allU[:m], a2, jbasis.dist_mean,
                                        False, rcond=g.nystrom_rcond)

    a2, jres = _reference_grid(blobs, pair_at)
    Kp, spectrum_at, extend = drivers._nystrom_family(None, torch.as_tensor(blobs["X_all"]), m,
                                                      CFG, basis=nystrom_basis_from_jax(jbasis))
    got = mc._grid_mult(gen(), blobs["aug"], m, blobs["n"], Kp, CFG, spectrum_at, extend)
    _same_selection(got, a2, jres)


def test_gl_dense_grid_selection_matches_reference(blobs):
    jbasis = jspectral.gl_setup(jnp.asarray(blobs["X_all"]), False, JCFG.gl_threshold)
    a2, jres = _reference_grid(blobs, lambda a: jspectral.gl_spectrum_at(jbasis, a, K))
    Kp, spectrum_at, extend = drivers._gl_family(gen(), torch.as_tensor(blobs["X_all"]), CFG)
    got = mc._grid_mult(gen(), blobs["aug"], blobs["m"], blobs["n"], Kp, CFG, spectrum_at, extend)
    _same_selection(got, a2, jres)
    assert got.metrics == {"gl_eigensolve_max_residual": 0.0}


# ---------------------------------------------------------------------------
# the entry points end to end, with the reference tests' gates
# ---------------------------------------------------------------------------

E2E_TRAIN = ft.TrainConfig(grid_size=16, adam_steps=80)


@pytest.mark.parametrize("name,graph", [
    ("fit_lae_logit_mult_gp", ft.GraphConfig(s=30, r=3, K=15)),
    ("fit_se_logit_mult_gp", ft.GraphConfig(s=30, r=3, K=15)),
    ("fit_nystrom_logit_mult_gp", ft.GraphConfig(s=30, r=3, K=15)),
    ("fit_gl_logit_mult_gp", ft.GraphConfig(K=20))])
def test_entry_point_on_blobs(name, graph):
    data = gaussian_blobs(n_per_class=40, n_classes=3, sep=6.0)
    cfg = ft.FitConfig(graph=graph, train=E2E_TRAIN, dtype=torch.float64)
    res = getattr(ft, name)(gen(), data.x_train, data.y_train, data.x_test, cfg=cfg,
                            device="cpu")
    assert np.mean(res.y_test != data.y_test) < 0.15
    assert res.posterior_mean.shape == res.posterior_cov.shape == (60, 3)
    assert res.pars["t"].shape == (3,) and np.all(np.isfinite(res.pars["t"]))
    assert set(np.unique(res.y_train)) <= {0.0, 1.0, 2.0}
    assert ("a2" in res.pars) == (name != "fit_lae_logit_mult_gp")
    assert np.all(res.posterior_cov > 0)


def test_lae_mult_on_digits():
    pytest.importorskip("sklearn")
    from flgp_tpu_torch.datasets import digits

    dg = digits(m_train=250, seed=0)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=250, r=3, K=60), train=E2E_TRAIN, sigma=1e-3,
                       dtype=torch.float64)
    res = ft.fit_lae_logit_mult_gp(gen(), dg.x_train, dg.y_train, dg.x_test, cfg=cfg,
                                   device="cpu")
    assert np.mean(res.y_test != dg.y_test) < 0.12
    assert res.posterior_mean.shape == (len(dg.y_test), 10)
