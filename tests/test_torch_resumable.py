"""flgp_tpu_torch's resumable bandwidth-grid search (``fit/resumable.py``).

Against ``flgp_tpu.fit.resumable.fit_se_regression_gp_resumable`` on the same
data and anchors in float64: the same bandwidth, t, noise and predictions to
1e-6 (both draw their anchors inside and take none, so the test hands the
same anchors to both packages' ``se_grid_setup`` for its duration).  The
port's own: a run resumed from the first checkpoints is the uninterrupted
run bit for bit, and a checkpoint whose a2 is not the grid's is trained
again, not trusted.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.fit import spectral as jspectral
from flgp_tpu.fit.resumable import fit_se_regression_gp_resumable as j_resumable
from flgp_tpu.ops.kmeans import SubsampleResult as JSubsample

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import anchors_from_numpy, fit_config_from_jax
from flgp_tpu_torch.fit import spectral
from flgp_tpu_torch.fit.resumable import fit_se_regression_gp_resumable
from flgp_tpu_torch.utils.checkpoint import load_pytree, load_spectrum

torch.set_num_threads(1)

A2S = [0.3, 1.0, 3.0, 10.0]


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _data():
    """The reference test's spiral (tests/test_resume.py)."""
    rng = np.random.default_rng(3)
    n, m = 400, 80
    theta = rng.uniform(0, 4 * np.pi, n)
    X = np.stack([np.cos(theta) * (1 + theta / 5), np.sin(theta) * (1 + theta / 5)], 1)
    Y = np.sin(theta)
    idx = rng.permutation(n)
    return X[idx[:m]], Y[idx[:m]] + 0.1 * rng.normal(size=m), X[idx[m:]]


def _cfg(a2s=A2S, noise="same"):
    return ft.FitConfig(graph=ft.GraphConfig(s=32, r=3, K=16), sigma=1e-5, a2s=a2s,
                        dtype=torch.float64, train=ft.TrainConfig(noise=noise, adam_steps=60))


def _equal(a, b):
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.pars.keys() == b.pars.keys()
    for k in a.pars:
        assert np.array_equal(a.pars[k], b.pars[k]), k
    assert a.obj == b.obj


def test_matches_reference(tmp_path, monkeypatch):
    Xtr, Ytr, Xte = _data()
    X_all = np.concatenate([Xtr, Xte])
    rng = np.random.default_rng(0)
    centers = X_all[rng.choice(len(X_all), 32, replace=False)]
    d2 = ((X_all[:, None, :] - centers[None]) ** 2).sum(-1)
    counts = np.bincount(d2.argmin(1), minlength=32).astype(np.float64)
    jsetup, setup = jspectral.se_grid_setup, spectral.se_grid_setup
    janchors = JSubsample(jnp.asarray(centers), jnp.asarray(counts))
    monkeypatch.setattr(jspectral, "se_grid_setup",
                        lambda key, X, g, anchors=None: jsetup(key, X, g, janchors))
    monkeypatch.setattr(spectral, "se_grid_setup",
                        lambda gen, X, g, anchors=None: setup(gen, X, g,
                                                              anchors_from_numpy(centers, counts)))
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=32, r=3, K=16), sigma=1e-5,
                              a2s=A2S, dtype=jnp.float64,
                              train=flgp_tpu.TrainConfig(adam_steps=60))
    ref = j_resumable(jax.random.PRNGKey(0), Xtr, Ytr, Xte, str(tmp_path / "ref"), jcfg)
    got = fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "got"),
                                         fit_config_from_jax(jcfg), device="cpu")
    assert float(got.pars["a2"]) == float(ref.pars["a2"])
    for k in ("t", "noise"):
        np.testing.assert_allclose(got.pars[k], np.asarray(ref.pars[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-6)
    for name in ("y_train", "y_test", "posterior_cov"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("noise", ["same", "different"])
def test_interrupt_and_resume_same_bits(tmp_path, noise):
    """Also under the per-point noise model, whose checkpoints hold a noise
    vector (the reference's resumable fit takes the scalar model only)."""
    Xtr, Ytr, Xte = _data()
    full = fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "f"),
                                          _cfg(noise=noise), device="cpu")
    os.makedirs(tmp_path / "p")
    for i in range(2):
        shutil.copytree(tmp_path / "f" / f"a2_{i}", tmp_path / "p" / f"a2_{i}")
    resumed = fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "p"),
                                             _cfg(noise=noise), device="cpu")
    _equal(resumed, full)
    eig, centers, counts = load_spectrum(str(tmp_path / "p" / "best_spectrum"))
    assert torch.equal(eig.vectors, full.eigenpair.vectors)
    assert centers.shape == (32, 2) and float(counts.sum()) == 400


def test_a_checkpoint_of_another_bandwidth_is_trained_again(tmp_path):
    """The grid's first point changes between runs: its stale checkpoint is
    retrained, the others are reused, and the result is the fresh run's."""
    Xtr, Ytr, Xte = _data()
    fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "d"), _cfg(),
                                   device="cpu")
    new = [0.5] + A2S[1:]
    again = fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "d"),
                                           _cfg(a2s=new), device="cpu")
    fresh = fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, str(tmp_path / "fresh"),
                                           _cfg(a2s=new), device="cpu")
    _equal(again, fresh)
    assert float(load_pytree(str(tmp_path / "d" / "a2_0"))["a2"]) == 0.5


def test_device_none_needs_a_card():
    Xtr, Ytr, Xte = _data()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fit_se_regression_gp_resumable(gen(), Xtr, Ytr, Xte, "unused", _cfg())
