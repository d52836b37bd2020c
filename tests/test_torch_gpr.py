"""flgp_tpu_torch GPR model layer against flgp_tpu on the same inputs, float64.

Values, predictions and covariances must agree to rtol 1e-9 (the same
algebra in another library's BLAS order); gradients in (t, noise) come from
``torch.autograd`` on one side and ``jax.grad`` on the other, rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.models import gpr as jgpr
from flgp_tpu.ops import linalg as jlinalg
from flgp_tpu.types import EigenPair as JEigenPair

from flgp_tpu_torch.convert import eigenpair_from_numpy
from flgp_tpu_torch.models import gpr
from flgp_tpu_torch.ops import linalg

torch.set_num_threads(1)

SIGMA = 1e-5
RTOL = 1e-9
BRANCHES = pytest.mark.parametrize("m,K", [(20, 30), (40, 12)], ids=["direct", "woodbury"])
NOISES = pytest.mark.parametrize("vector_noise", [False, True], ids=["scalar", "per-point"])


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _problem(rng, m, K, n=70, vector_noise=False, q=None):
    values = np.sort(rng.uniform(0.05, 1.0, size=K))[::-1].copy()
    vectors = rng.normal(size=(n, K))
    Y = rng.normal(size=(m,) if q is None else (m, q))
    noise = rng.uniform(0.05, 0.8, size=m) if vector_noise else 0.3
    eigs = (eigenpair_from_numpy(values, vectors),
            JEigenPair(jnp.asarray(values), jnp.asarray(vectors)))
    return eigs, Y, noise


def test_woodbury_solve_terms_matches_reference(rng):
    m, K, q = 30, 8, 2
    V, lam_sqrt = rng.normal(size=(m, K)), rng.uniform(0.2, 1.0, size=K)
    z_inv, Y = rng.uniform(0.5, 3.0, size=m), rng.normal(size=(m, q))
    alpha, L_Q = linalg.woodbury_solve_terms(T(V), T(lam_sqrt), T(z_inv), T(Y))
    ja, jL = jlinalg.woodbury_solve_terms(*(jnp.asarray(a) for a in (V, lam_sqrt, z_inv, Y)))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ja), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(L_Q.numpy(), np.asarray(jL), rtol=RTOL, atol=1e-12)
    # alpha really solves C·alpha = Y for C = V·diag(lam)·Vᵀ + diag(1/z_inv)
    C = V @ np.diag(lam_sqrt ** 2) @ V.T + np.diag(1.0 / z_inv)
    np.testing.assert_allclose(C @ alpha.numpy(), Y, rtol=0, atol=1e-10)


@BRANCHES
@NOISES
@pytest.mark.parametrize("posterior", [False, True], ids=["nmll", "nmll+priors"])
def test_nmll_and_gradient_match_reference(rng, m, K, vector_noise, posterior):
    (eig_t, eig_j), Y, noise = _problem(rng, m, K, vector_noise=vector_noise)
    idx = np.arange(m)
    tfn = gpr.gpr_nmll_posterior if posterior else gpr.gpr_nmll
    jfn = jgpr.gpr_nmll_posterior if posterior else jgpr.gpr_nmll
    for t in (0.7, 25.0):
        tt = T(t).requires_grad_(True)
        nt = T(noise).requires_grad_(True)
        val = tfn(eig_t, T(Y), slice(0, m), K, tt, nt, SIGMA)
        gt, gn = torch.autograd.grad(val, (tt, nt))
        jval, (jgt, jgn) = jax.value_and_grad(
            lambda t_, n_: jfn(eig_j, jnp.asarray(Y), jnp.asarray(idx), K, t_, n_, SIGMA),
            argnums=(0, 1))(jnp.asarray(t), jnp.asarray(noise))
        np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL)
        np.testing.assert_allclose(float(gt), float(jgt), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), rtol=RTOL, atol=1e-12)


@BRANCHES
@NOISES
def test_nmll_batched_lanes_equal_single_calls(rng, m, K, vector_noise):
    """A batch of (t, noise) lanes gives each lane's own value (the coarse
    grid of the optimizers runs as one such call), for multi-column Y too."""
    (eig_t, eig_j), Y, noise = _problem(rng, m, K, vector_noise=vector_noise, q=3)
    ts = np.array([0.05, 1.0, 30.0])
    noises = np.stack([noise * f for f in (0.5, 1.0, 2.0)]) if vector_noise else \
        np.array([0.01, 0.3, 2.0])
    got = gpr.gpr_nmll_posterior(eig_t, T(Y), slice(0, m), K, T(ts), T(noises), SIGMA)
    assert got.shape == (3,)
    for k in range(3):
        ref = jgpr.gpr_nmll_posterior(eig_j, jnp.asarray(Y), jnp.arange(m), K,
                                      jnp.asarray(ts[k]), jnp.asarray(noises[k]), SIGMA)
        np.testing.assert_allclose(float(got[k]), float(ref), rtol=RTOL)
    np.testing.assert_allclose(
        float(gpr.gpr_mll(eig_t, T(Y[:, 0]), slice(0, m), K, 1.0, noises[1], SIGMA)),
        float(jgpr.gpr_mll(eig_j, jnp.asarray(Y[:, 0]), jnp.arange(m), K, 1.0,
                           jnp.asarray(noises[1]), SIGMA)), rtol=RTOL)


@BRANCHES
@NOISES
def test_predict_and_posterior_cov_match_reference(rng, m, K, vector_noise):
    (eig_t, eig_j), Y, noise = _problem(rng, m, K, vector_noise=vector_noise)
    n = eig_t.vectors.shape[0]
    idx0, idx1 = jnp.arange(m), jnp.arange(m, n)
    t = 3.0
    for sel_t, sel_j in ((slice(m, n), idx1), (slice(0, m), idx0)):
        pred = gpr.gpr_predict(eig_t, T(Y), slice(0, m), sel_t, K, t, T(noise), SIGMA)
        jpred = jgpr.gpr_predict(eig_j, jnp.asarray(Y), idx0, sel_j, K, t, jnp.asarray(noise),
                                 SIGMA)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=RTOL, atol=1e-12)
    noise0 = float(np.ravel(noise)[0])
    cov = gpr.gpr_posterior_cov(eig_t, torch.arange(m), torch.arange(m, n), K, t, noise0, SIGMA)
    jcov = jgpr.gpr_posterior_cov(eig_j, idx0, idx1, K, t, noise0, SIGMA)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=RTOL, atol=1e-12)


def test_predict_keeps_the_columns_of_Y(rng):
    (eig_t, eig_j), Y, noise = _problem(rng, 15, 20, q=2)
    pred = gpr.gpr_predict(eig_t, T(Y), slice(0, 15), slice(15, 70), 20, 2.0, noise, SIGMA)
    jpred = jgpr.gpr_predict(eig_j, jnp.asarray(Y), jnp.arange(15), jnp.arange(15, 70), 20, 2.0,
                             noise, SIGMA)
    assert pred.shape == (55, 2)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=RTOL, atol=1e-12)
