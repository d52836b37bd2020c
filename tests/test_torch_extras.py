"""flgp_tpu_torch's extras against flgp_tpu's, float64, on the CPU: the
cross-similarity graphs, ``lae_eigenmap`` (through its pieces on fixed
anchors, and whole), ``heat_kernel_covariance``, the model-criticism NLLs and
the multiclass datasets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu import datasets as jdatasets
from flgp_tpu.config import LaplacianType as JLaplacian
from flgp_tpu.models import criticism as jcrit
from flgp_tpu.ops import spectrum as jspectrum

import flgp_tpu_torch as ft
from flgp_tpu_torch import datasets
from flgp_tpu_torch.config import LaplacianType
from flgp_tpu_torch.models import criticism
from flgp_tpu_torch.ops import spectrum

torch.set_num_threads(1)

T = torch.as_tensor


def _cloud(rng, n=300, s=40):
    X = np.concatenate([rng.normal(size=(n // 2, 2)), rng.normal(size=(n - n // 2, 2)) + 4.0])
    U = X[rng.choice(n, s, replace=False)]
    d2 = ((X[:, None, :] - U[None]) ** 2).sum(-1)
    counts = np.bincount(d2.argmin(1), minlength=s).astype(np.float64)
    return X, U, counts


@pytest.mark.parametrize("gl", ["rw", "normalized", "cluster-normalized"])
def test_cross_similarity_lae_and_se_match_reference(rng, gl):
    X, U, counts = _cloud(rng)
    got = spectrum.cross_similarity_lae(T(X), T(U), 3, LaplacianType(gl), T(counts))
    ref = jspectrum.cross_similarity_lae(jnp.asarray(X), jnp.asarray(U), 3, JLaplacian(gl),
                                         jnp.asarray(counts))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=1e-10)
    assert got.num_cols == ref.num_cols == 40
    got = spectrum.cross_similarity_se(T(X), T(U), 4, LaplacianType(gl), 0.7, T(counts))
    ref = jspectrum.cross_similarity_se(jnp.asarray(X), jnp.asarray(U), 4, JLaplacian(gl), 0.7,
                                        jnp.asarray(counts))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=1e-10)


def test_lae_eigenmap_pieces_match_reference(rng):
    """The eigenmap on fixed anchors: eigenvalues 1 − λ to 1e-8, the
    eigenvectors up to sign."""
    X, U, counts = _cloud(rng)
    ndim = 6
    cn = LaplacianType.CLUSTER_NORMALIZED
    eig = spectrum.spectrum_from_Z(spectrum.cross_similarity_lae(T(X), T(U), 3, cn, T(counts)),
                                   ndim, True)
    jeig = jspectrum.spectrum_from_Z(jspectrum.cross_similarity_lae(
        jnp.asarray(X), jnp.asarray(U), 3, JLaplacian(cn.value), jnp.asarray(counts)), ndim, True)
    np.testing.assert_allclose((1.0 - eig.values).numpy(), 1.0 - np.asarray(jeig.values),
                               rtol=0, atol=1e-8)
    Vg, Vr = eig.vectors.numpy(), np.asarray(jeig.vectors)
    signs = np.sign(np.sum(Vg * Vr, axis=0))
    np.testing.assert_allclose(Vg * signs, Vr, rtol=0, atol=1e-6)


def test_lae_eigenmap_entry_point():
    tor = datasets.torus_rings(n=1200, m_train=100, seed=1)
    X = np.concatenate([tor.x_train, tor.x_test])
    vals, vecs = ft.lae_eigenmap(torch.Generator().manual_seed(0), X, 80, 3, 8, device="cpu")
    assert vals.shape == (8,) and vecs.shape == (1200, 8)
    assert bool(torch.all(vals[1:] >= vals[:-1])) and float(vals[0]) >= -1e-10
    assert float(vals[-1]) <= 2.0 and abs(float(vals[0])) < 1e-8
    np.testing.assert_allclose(torch.linalg.norm(vecs, dim=0).numpy(), np.sqrt(1200), rtol=1e-6)


def test_heat_kernel_covariance_is_a_covariance():
    tor = datasets.torus_rings(n=900, m_train=60, seed=2)
    H = ft.heat_kernel_covariance(torch.Generator().manual_seed(0), tor.x_train, tor.x_test, 1.0,
                                  ft.GraphConfig(s=90, r=3, K=40), device="cpu")
    assert H.shape == (900, 60) and H.dtype == torch.float64
    assert bool(torch.all(torch.isfinite(H)))
    Hmm = H[:60]
    torch.testing.assert_close(Hmm, Hmm.T, rtol=0, atol=1e-12)
    w = torch.linalg.eigvalsh(Hmm)
    assert float(w.min()) >= -1e-10 * float(w.max())


def test_heat_kernel_covariance_matches_reference_on_its_spectrum():
    """The same subsampler stream cannot be had, so the port's covariance is
    checked against the reference's heat kernel on the port's own spectrum."""
    from flgp_tpu.ops.heat_kernel import heat_kernel as jheat_kernel
    from flgp_tpu.types import EigenPair as JEigenPair

    from flgp_tpu_torch.fit import spectral

    tor = datasets.torus_rings(n=600, m_train=40, seed=3)
    X_all = T(np.concatenate([tor.x_train, tor.x_test]))
    g = ft.GraphConfig(s=60, r=3, K=30)
    H = ft.heat_kernel_covariance(torch.Generator().manual_seed(4), tor.x_train, tor.x_test, 2.5,
                                  g, device="cpu")
    eig, _ = spectral.build_spectrum(torch.Generator().manual_seed(4), X_all, g)
    ref = jheat_kernel(JEigenPair(jnp.asarray(eig.values.numpy()), jnp.asarray(eig.vectors.numpy())),
                       2.5, 30, jnp.arange(600), jnp.arange(40))
    np.testing.assert_allclose(H.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_extras_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X = np.zeros((10, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ft.heat_kernel_covariance(torch.Generator(), X, X, 1.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ft.lae_eigenmap(torch.Generator(), X, 4, 3, 2)


# ---------------------------------------------------------------------------
# criticism
# ---------------------------------------------------------------------------


def test_nll_regression_matches_reference(rng):
    mean, target = rng.normal(size=200), rng.normal(size=200)
    cov = rng.uniform(0.1, 2.0, size=200)
    got = criticism.nll_regression(T(mean), T(cov), T(target))
    ref = jcrit.nll_regression(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    assert float(criticism.negative_log_likelihood(None, T(mean), T(cov), T(target))) == float(got)


def _mc_sd(fn, reps=20):
    vals = [float(fn(torch.Generator().manual_seed(s))) for s in range(reps)]
    return np.mean(vals), np.std(vals, ddof=1)


def test_nll_classification_within_mc_error(rng):
    n = 400
    mean, cov = rng.normal(scale=2.0, size=n), rng.uniform(0.05, 3.0, size=n)
    target = (rng.uniform(size=n) < 0.5).astype(np.float64)
    avg, sd = _mc_sd(lambda g: criticism.nll_classification(g, T(mean), T(cov), T(target)))
    ref = jcrit.nll_classification(jax.random.PRNGKey(0), jnp.asarray(mean), jnp.asarray(cov),
                                   jnp.asarray(target))
    assert abs(avg - float(ref)) < 5.0 * sd + 1e-12, (avg, float(ref), sd)
    # a deterministic limit: zero variance is the plug-in likelihood
    got = criticism.nll_classification(torch.Generator(), T(mean), T(0 * cov), T(target))
    pi = 1.0 / (1.0 + np.exp(-mean))
    like = pi * target + (1.0 - pi) * (1.0 - target)
    np.testing.assert_allclose(float(got), -np.mean(np.log(like + 1e-2)), rtol=1e-12)


def test_multinomial_nll_within_mc_error(rng):
    n, J = 300, 4
    mean, cov = rng.normal(size=(n, J)), rng.uniform(0.05, 1.0, size=(n, J))
    target = rng.integers(0, J, size=n).astype(np.float64)
    avg, sd = _mc_sd(lambda g: criticism.negative_log_likelihood(
        g, T(mean), T(cov), T(target), kind="multinomial"))
    ref = jcrit.negative_log_likelihood(jax.random.PRNGKey(0), jnp.asarray(mean), jnp.asarray(cov),
                                        jnp.asarray(target), kind="multinomial")
    assert abs(avg - float(ref)) < 5.0 * sd + 1e-12, (avg, float(ref), sd)
    with pytest.raises(ValueError):
        criticism.negative_log_likelihood(None, T(mean), T(cov), T(target), kind="ordinal")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("gaussian_blobs", dict()), ("gaussian_blobs", dict(n_per_class=40, sep=6.0, seed=3)),
    ("mnist_like", dict(n=3000, m_train=200, seed=1)), ("mnist_like", dict(n=70_000)),
    ("digits", dict(m_train=250)), ("digits_large", dict(n=3000, m_train=100, seed=2))])
def test_datasets_are_the_reference_s(name, kw):
    if name.startswith("digits"):
        pytest.importorskip("sklearn")
    got, ref = getattr(datasets, name)(**kw), getattr(jdatasets, name)(**kw)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

