"""The regression and bandwidth-grid drivers of flgp_tpu_torch end to end
against flgp_tpu's, float64, on the CPU (``device="cpu"``).

Both sides get the same data and, where the entry point takes them, the same
anchors, so everything but the PG-Gibbs labels is deterministic: the
selected bandwidth must be equal, t and noise agree to rtol 1e-6, the
objective to 1e-8, predictions and Laplace moments to 1e-6.  The LOBPCG
drivers start from different random blocks (two RNG streams): predictions to
1e-3, and the eigensolver residual under the reference test's own 1e-4.  The
Nyström drivers subsample at random and take no anchors: their grid is
compared from the reference's own basis, carried over by ``convert``, and the
drivers end to end by their accuracy alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.fit import spectral as jspectral

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import fit_config_from_jax, nystrom_basis_from_jax
from flgp_tpu_torch.datasets import spiral
from flgp_tpu_torch.fit import drivers

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
A2S = (0.5, 1.0, 2.0)


def gen():
    return torch.Generator().manual_seed(0)


def _anchors(X_all, s, seed=0):
    rng = np.random.default_rng(seed)
    centers = X_all[rng.choice(len(X_all), s, replace=False)]
    d2 = ((X_all[:, None, :] - centers[None]) ** 2).sum(-1)
    return centers, np.bincount(d2.argmin(1), minlength=s).astype(np.float64)


def _regression_data(n=400, m=60):
    ds = spiral(n=n, m_train=m, noise_sd=0.3, seed=5)
    return ds, np.concatenate([ds.x_train, ds.x_test])


def _two_blobs(n=400, m=60, seed=2):
    """Two separated clusters labelled 0/1: labels that both PG streams agree on."""
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    X = rng.normal(size=(n, 2)) * 0.5 + np.where(y[:, None] > 0, 1.5, -1.5)
    return X[:m], y[:m], X[m:], y[m:]


def _jcfg(**kw):
    base = dict(graph=flgp_tpu.GraphConfig(s=48, r=3, K=12), a2s=A2S, dtype=jnp.float64,
                train=flgp_tpu.TrainConfig(adam_steps=50, grid_size=12), n_gibbs=20,
                gibbs_avg_sweeps=10)
    base.update(kw)
    return flgp_tpu.FitConfig(**base)


def _same_regression(got, ref, tol=1e-6, obj_tol=1e-8):
    for k in ref.pars:
        np.testing.assert_allclose(got.pars[k], np.asarray(ref.pars[k]), rtol=tol, err_msg=k)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=obj_tol)
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=0, atol=tol,
                                   err_msg=name)


def _same_logit(got, ref, y_test, tol=1e-6, obj_tol=1e-8):
    for k in ref.pars:
        np.testing.assert_allclose(got.pars[k], np.asarray(ref.pars[k]), rtol=tol, err_msg=k)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=obj_tol)
    np.testing.assert_allclose(got.posterior_mean, ref.posterior_mean, rtol=0, atol=tol)
    np.testing.assert_allclose(got.posterior_cov, ref.posterior_cov, rtol=0, atol=tol)
    assert got.y_test.shape == ref.y_test.shape
    assert np.mean(got.y_test == ref.y_test) >= 0.98
    assert np.mean(got.y_test != y_test) <= 0.02


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise", ["same", "different"])
def test_fit_lae_regression_gp_matches_reference(noise):
    """Homoscedastic noise (minimize_t_noise) and per-point noise
    (minimize_t_noisevec, whose covariance takes noise[0]); m > K: Woodbury."""
    ds, X_all = _regression_data()
    anchors = _anchors(X_all, 48)
    jcfg = _jcfg(sigma=1e-5, train=flgp_tpu.TrainConfig(adam_steps=50, noise=noise))
    ref = flgp_tpu.fit_lae_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg,
                                         anchors=anchors)
    got = ft.fit_lae_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                   fit_config_from_jax(jcfg), anchors=anchors, device="cpu")
    assert got.pars["noise"].shape == (() if noise == "same" else (60,))
    _same_regression(got, ref)


def test_fit_lae_regression_gp_direct_branch_and_default_sigma():
    """m ≤ K takes the direct Cholesky; the generic σ = 1e-3 resolves to the
    regression default 1e-5 on both sides; C is returned on request."""
    ds, X_all = _regression_data(n=300, m=10)
    anchors = _anchors(X_all, 48)
    jcfg = _jcfg(output_cov=True)
    assert jcfg.sigma == 1e-3
    ref = flgp_tpu.fit_lae_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg,
                                         anchors=anchors)
    got = ft.fit_lae_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                   fit_config_from_jax(jcfg), anchors=anchors, device="cpu")
    _same_regression(got, ref)
    np.testing.assert_allclose(got.C, ref.C, rtol=0, atol=1e-8)


@pytest.mark.parametrize("noise", ["same", "different"])
def test_fit_se_regression_gp_matches_reference(noise):
    """The port trains the grid's bandwidths as lanes of one Adam run, the
    reference vmaps them: the same numbers, for both noise models."""
    ds, X_all = _regression_data()
    anchors = _anchors(X_all, 48, seed=1)
    jcfg = _jcfg(sigma=1e-5, train=flgp_tpu.TrainConfig(adam_steps=50, noise=noise))
    ref = flgp_tpu.fit_se_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg,
                                        anchors=anchors)
    got = ft.fit_se_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                  fit_config_from_jax(jcfg), anchors=anchors, device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    _same_regression(got, ref)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "knn-sparse"])
def test_fit_gl_regression_gp_eigh_matches_reference(sparse):
    ds, _ = _regression_data(n=240, m=60)
    jcfg = _jcfg(sigma=1e-5, gl_sparse=sparse, gl_threshold=0.04)
    ref = flgp_tpu.fit_gl_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg)
    got = ft.fit_gl_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                  fit_config_from_jax(jcfg), device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    _same_regression(got, ref)
    assert got.metrics == {"gl_eigensolve_max_residual": 0.0}


def test_fit_gl_regression_gp_lobpcg_against_reference():
    ds, _ = _regression_data(n=240, m=60)
    jcfg = _jcfg(sigma=1e-5, gl_sparse=True, gl_threshold=0.04, gl_solver="lobpcg",
                 gl_lobpcg_iters=120)
    ref = flgp_tpu.fit_gl_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg)
    got = ft.fit_gl_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                  fit_config_from_jax(jcfg), device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    np.testing.assert_allclose(got.y_test, ref.y_test, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.pars["t"], np.asarray(ref.pars["t"]), rtol=1e-3)
    assert 0.0 < got.metrics["gl_eigensolve_max_residual"] < 1e-4
    assert ref.metrics["gl_eigensolve_max_residual"] < 1e-4


def test_nystrom_regression_grid_from_the_reference_basis():
    """The reference driver's basis is nystrom_setup(key, X_all, g); the same
    call outside it gives the same basis, which the port's grid then takes."""
    ds, X_all = _regression_data()
    jcfg = _jcfg(sigma=1e-5, graph=flgp_tpu.GraphConfig(s=48, r=3, K=12, nystrom_rcond=1e-3))
    cfg = fit_config_from_jax(jcfg)
    ref = flgp_tpu.fit_nystrom_regression_gp(KEY, ds.x_train, ds.y_train, ds.x_test, jcfg)
    basis = nystrom_basis_from_jax(jspectral.nystrom_setup(KEY, jnp.asarray(X_all), jcfg.graph))
    m, n = 60, len(X_all)
    K, spectrum_at, extend = drivers._nystrom_family(None, torch.as_tensor(X_all), m, cfg,
                                                     basis=basis)
    got = drivers._grid_regression(torch.as_tensor(ds.y_train), m, n, K, cfg, spectrum_at, extend)
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    _same_regression(got, ref)
    # the entry point itself, on its own random anchors: as accurate as the reference
    own = ft.fit_nystrom_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test, cfg,
                                       device="cpu")
    rmse = lambda r: float(np.sqrt(np.mean((r.y_test - ds.y_test) ** 2)))  # noqa: E731
    assert rmse(own) < 1.25 * rmse(ref) + 0.05, (rmse(own), rmse(ref))


# ---------------------------------------------------------------------------
# binary classification
# ---------------------------------------------------------------------------


def test_fit_se_logit_gp_matches_reference():
    xtr, ytr, xte, yte = _two_blobs()
    anchors = _anchors(np.concatenate([xtr, xte]), 48)
    jcfg = _jcfg()
    ref = flgp_tpu.fit_se_logit_gp(KEY, xtr, ytr, xte, cfg=jcfg, anchors=anchors)
    got = ft.fit_se_logit_gp(gen(), xtr, ytr, xte, cfg=fit_config_from_jax(jcfg),
                             anchors=anchors, device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    _same_logit(got, ref, yte)


@pytest.mark.parametrize("solver", ["dense", "lobpcg"])
def test_fit_gl_logit_gp_against_reference(solver):
    xtr, ytr, xte, yte = _two_blobs(n=240)
    jcfg = _jcfg(gl_sparse=True, gl_threshold=0.04, gl_solver=solver, gl_lobpcg_iters=120)
    ref = flgp_tpu.fit_gl_logit_gp(KEY, xtr, ytr, xte, cfg=jcfg)
    got = ft.fit_gl_logit_gp(gen(), xtr, ytr, xte, cfg=fit_config_from_jax(jcfg), device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    if solver == "dense":
        _same_logit(got, ref, yte)
        assert got.metrics == {"gl_eigensolve_max_residual": 0.0}
    else:
        _same_logit(got, ref, yte, tol=1e-3, obj_tol=1e-5)
        assert 0.0 < got.metrics["gl_eigensolve_max_residual"] < 1e-4


def test_nystrom_logit_grid_from_the_reference_basis():
    xtr, ytr, xte, yte = _two_blobs()
    X_all = np.concatenate([xtr, xte])
    jcfg = _jcfg()
    cfg = fit_config_from_jax(jcfg)
    ref = flgp_tpu.fit_nystrom_logit_gp(KEY, xtr, ytr, xte, cfg=jcfg)
    k_spec, _ = jax.random.split(KEY)
    basis = nystrom_basis_from_jax(jspectral.nystrom_setup(k_spec, jnp.asarray(X_all), jcfg.graph))
    m, n = len(xtr), len(X_all)
    K, spectrum_at, extend = drivers._nystrom_family(None, torch.as_tensor(X_all), m, cfg,
                                                     basis=basis)
    got = drivers._grid_logit(gen(), torch.as_tensor(ytr), torch.ones(m, dtype=torch.float64), 1,
                              m, n, K, cfg, spectrum_at, extend)
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    _same_logit(got, ref, yte)
    own = ft.fit_nystrom_logit_gp(gen(), xtr, ytr, xte, cfg=cfg, device="cpu")
    assert np.mean(own.y_test != yte) <= 0.02


# ---------------------------------------------------------------------------
# the device rule, and the goldens on the reference's exact anchors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(n for n in ft.__all__ if n.startswith("fit_")))
def test_device_none_without_cuda_raises(name):
    """The drivers run on the card unless the caller asks for the CPU: with
    no CUDA device, ``device=None`` raises instead of fitting on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds, _ = _regression_data(n=60, m=10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(ft, name)(gen(), ds.x_train, ds.y_train, ds.x_test)
    with pytest.raises(ValueError, match="generator"):
        getattr(ft, name)(gen(), ds.x_train, ds.y_train, ds.x_test, device="meta")


@pytest.mark.parametrize("name", ["minimize_1d_log", "minimize_t_noise", "minimize_t_noisevec"])
def test_optimizers_device_none_without_cuda_raises(monkeypatch, name):
    """The optimizers build their grids on the card unless the caller names a
    device: with no CUDA device, ``device=None`` raises instead of running on
    the CPU, as the fit entry points do."""
    from flgp_tpu_torch.inference import optimize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(optimize, name)
    args = (lambda t, nz: t,) + ((3,) if name == "minimize_t_noisevec" else ())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(*args)


@pytest.fixture(scope="module")
def spiral_exact():
    from flgp_tpu_torch.datasets import spiral_r, spiral_r_anchors

    return spiral_r(), spiral_r_anchors()


GOLDEN_CFG = dict(graph=ft.GraphConfig(s=500, r=3, K=100), sigma=1e-5, dtype=torch.float64)


def test_spiral_golden_lae_regression_on_exact_anchors(spiral_exact):
    """README golden 0.4582 on the anchors the reference drew; the JAX
    package's own gate (tests/test_golden.py)."""
    ds, anchors = spiral_exact
    res = ft.fit_lae_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                   ft.FitConfig(**GOLDEN_CFG), anchors=anchors["lae"],
                                   device="cpu")
    rmse = float(np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)))
    assert abs(rmse - 0.4582) < 8e-3, rmse


def test_spiral_golden_se_regression_on_exact_anchors(spiral_exact):
    """README golden 0.5032, same gate as the JAX package's."""
    ds, anchors = spiral_exact
    res = ft.fit_se_regression_gp(gen(), ds.x_train, ds.y_train, ds.x_test,
                                  ft.FitConfig(**GOLDEN_CFG), anchors=anchors["se"],
                                  device="cpu")
    rmse = float(np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)))
    assert abs(rmse - 0.5032) < 1.5e-3, rmse
