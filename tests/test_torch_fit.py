"""flgp_tpu_torch.fit_lae_logit_gp end to end against flgp_tpu's driver.

Both drivers get the same data and the same anchors (the subsampler is
random and its streams differ), so everything up to the PG-Gibbs labels is
deterministic and compared tightly; the labels come from two different
random streams and are compared by agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.datasets import torus_rings as jtorus_rings

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import anchors_from_numpy, eigenpair_to_numpy, fit_config_from_jax
from flgp_tpu_torch.datasets import torus_rings

torch.set_num_threads(1)


def _data_and_anchors(n, s, seed=0):
    tor = torus_rings(n=n, m_train=100, seed=1234)
    X_all = np.concatenate([tor.x_train, tor.x_test])
    rng = np.random.default_rng(seed)
    centers = X_all[rng.choice(n, s, replace=False)]
    d2 = ((X_all[:, None, :] - centers[None]) ** 2).sum(-1)
    counts = np.bincount(d2.argmin(1), minlength=s).astype(np.float64)
    return tor, centers, counts


def test_torus_rings_is_the_reference_dataset():
    for kw in (dict(), dict(n=1000, m_train=50, seed=7), dict(n=601, n_rings=4, seed=3)):
        for a, b in zip(torus_rings(**kw), jtorus_rings(**kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K", [240, 40], ids=["K=s-dense", "K<m-woodbury"])
def test_fit_lae_logit_gp_matches_reference_f64(K):
    """Small torus, float64 throughout; K = s takes the dense Newton path
    (m ≤ K), K < m the Woodbury one."""
    n, s = 2400, 240
    tor, centers, counts = _data_and_anchors(n, s)
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=s, r=3, K=K), sigma=1e-3,
                              dtype=jnp.float64)
    ref = flgp_tpu.fit_lae_logit_gp(jax.random.PRNGKey(0), tor.x_train, tor.y_train, tor.x_test,
                                    cfg=jcfg, anchors=(centers, counts))
    got = ft.fit_lae_logit_gp(torch.Generator().manual_seed(0), tor.x_train, tor.y_train,
                              tor.x_test, cfg=fit_config_from_jax(jcfg),
                              anchors=anchors_from_numpy(centers, counts))
    np.testing.assert_allclose(got.pars["t"], np.asarray(ref.pars["t"]), rtol=1e-6)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-8)
    np.testing.assert_allclose(got.posterior_mean, ref.posterior_mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.posterior_cov, ref.posterior_cov, rtol=0, atol=1e-6)
    assert got.y_test.shape == ref.y_test.shape == (n - 100,)
    assert np.mean(got.y_test == ref.y_test) >= 0.98
    values, _ = eigenpair_to_numpy(got.eigenpair)
    np.testing.assert_allclose(values, np.asarray(ref.eigenpair.values), rtol=0, atol=1e-9)


def test_fit_main_path_dtypes_f32_graph_f64_tail():
    """The configuration the card runs: f32 graph stage (on the CPU, the
    kernels' plain versions), f64 solve tail, Woodbury objective (m > K)."""
    n, s, K = 2400, 240, 40
    tor, centers, counts = _data_and_anchors(n, s, seed=1)
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=s, r=3, K=K), sigma=1e-3,
                              dtype=jnp.float32, solve_dtype=jnp.float64)
    cfg = fit_config_from_jax(jcfg)
    assert (cfg.dtype, cfg.solve_dtype) == (torch.float32, torch.float64)
    ref = flgp_tpu.fit_lae_logit_gp(jax.random.PRNGKey(0), tor.x_train, tor.y_train, tor.x_test,
                                    cfg=jcfg, anchors=(centers, counts))
    got = ft.fit_lae_logit_gp(torch.Generator().manual_seed(0), tor.x_train, tor.y_train,
                              tor.x_test, cfg=cfg, anchors=(centers, counts))
    assert got.eigenpair.vectors.dtype == torch.float32
    # f32 graph stages of different op order: agreement to f32 spectral accuracy
    np.testing.assert_allclose(got.pars["t"], np.asarray(ref.pars["t"]), rtol=1e-2)
    np.testing.assert_allclose(got.posterior_mean, ref.posterior_mean, rtol=0, atol=1e-2)
    assert np.mean(got.y_test == ref.y_test) >= 0.98


def test_fit_with_binomial_counts_and_errors():
    n, s = 600, 60
    tor, centers, counts = _data_and_anchors(n, s)
    N = np.full(tor.y_train.shape, 2.0)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=s, r=3, K=20), n_gibbs=6, gibbs_avg_sweeps=3,
                       dtype=torch.float64, output_cov=True)
    res = ft.fit_lae_logit_gp(torch.Generator().manual_seed(0), tor.x_train, 2 * tor.y_train,
                              tor.x_test, N=N, cfg=cfg, anchors=(centers, counts))
    assert res.y_test.shape == res.posterior_mean.shape == (n - 100,)
    assert res.C.shape == (n, 100) and np.all(np.isfinite(res.C))
    with pytest.raises(ValueError, match="generator"):
        ft.fit_lae_logit_gp(torch.Generator(), tor.x_train, tor.y_train, tor.x_test,
                            cfg=cfg, device="meta")


@pytest.mark.slow
def test_torus_golden_full_config():
    """README golden at full size through the port's own subsampler
    (the JAX package's torus LAE gate: error ≤ 0.015)."""
    tor = torus_rings(n=4800, m_train=100, seed=1234)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=600, r=3, K=100), sigma=1e-3,
                       dtype=torch.float32, solve_dtype=torch.float64)
    res = ft.fit_lae_logit_gp(torch.Generator().manual_seed(0), tor.x_train, tor.y_train,
                              tor.x_test, cfg=cfg)
    assert np.mean(res.y_test != tor.y_test) <= 0.015
