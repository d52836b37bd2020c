"""flgp_tpu_torch's Adam and GPR optimizers against flgp_tpu's, float64.

Adam is hand-written and deterministic on both sides, so from the same start
the two must land on the same iterate: x, objective and gradient norm to
rtol 1e-9.  The (t, noise) optimizers add a log-grid seed and a 200–400-step
run over a GPR objective; they are held to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.inference import optimize as jopt
from flgp_tpu.models import gpr as jgpr
from flgp_tpu.types import EigenPair as JEigenPair

from flgp_tpu_torch.convert import eigenpair_from_numpy, gpr_opt_result_to_numpy
from flgp_tpu_torch.inference import optimize as opt
from flgp_tpu_torch.models import gpr
from flgp_tpu_torch.ops import linalg

torch.set_num_threads(1)

SIGMA = 1e-5


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_adam_minimize_lands_on_the_reference_iterate():
    """A non-quadratic function with a non-finite region (log of a negative
    number) that the start's first steps cross."""
    a = np.array([1.5, -0.5, 2.0])

    def tfn(x):
        return torch.sum((x - T(a)) ** 4, dim=-1) + torch.sum(torch.cosh(0.3 * x), dim=-1) \
            + torch.log(x[..., 0] + 2.0)

    def jfn(x):
        return jnp.sum((x - a) ** 4) + jnp.sum(jnp.cosh(0.3 * x)) + jnp.log(x[0] + 2.0)

    x0 = np.array([-2.02, 1.0, 0.0])
    got = opt.adam_minimize(tfn, T(x0), steps=120, lr=0.05)
    ref = jopt.adam_minimize(jfn, jnp.asarray(x0), steps=120, lr=0.05)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9)
    np.testing.assert_allclose(float(got.obj), float(ref.obj), rtol=1e-9)
    np.testing.assert_allclose(float(got.grad_norm), float(ref.grad_norm), rtol=1e-9)
    # independent lanes: each lane of a batched start equals its own run
    lanes = opt.adam_minimize(tfn, T(np.stack([x0, x0 + 0.5])), steps=120, lr=0.05)
    np.testing.assert_allclose(lanes.x[0].numpy(), got.x.numpy(), rtol=1e-12)
    assert lanes.obj.shape == lanes.grad_norm.shape == (2,)


def _gpr_problem(m, K, n=90, seed=3):
    rng = np.random.default_rng(seed)
    values = np.sort(rng.uniform(0.05, 1.0, size=K))[::-1].copy()
    vectors = rng.normal(size=(n, K))
    Y = vectors[:m, :4] @ rng.normal(size=4) + 0.3 * rng.normal(size=m)
    return (eigenpair_from_numpy(values, vectors),
            JEigenPair(jnp.asarray(values), jnp.asarray(vectors)), Y)


@pytest.mark.parametrize("m,K", [(25, 30), (50, 10)], ids=["direct", "woodbury"])
def test_minimize_t_noise_matches_reference(m, K):
    eig_t, eig_j, Y = _gpr_problem(m, K)
    got = opt.minimize_t_noise(
        lambda t, nz: gpr.gpr_nmll_posterior(eig_t, T(Y), slice(0, m), K, t, nz, SIGMA),
        adam_steps=60, dtype=torch.float64, device="cpu")
    ref = jopt.minimize_t_noise(
        lambda t, nz: jgpr.gpr_nmll_posterior(eig_j, jnp.asarray(Y), jnp.arange(m), K, t, nz,
                                              SIGMA),
        adam_steps=60, dtype=jnp.float64)
    for name in ("t", "noise", "obj"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(got.grad_norm), float(ref.grad_norm), rtol=1e-5, atol=1e-9)


def test_minimize_t_noisevec_matches_reference():
    m, K = 30, 12
    eig_t, eig_j, Y = _gpr_problem(m, K, seed=5)
    got = gpr_opt_result_to_numpy(opt.minimize_t_noisevec(
        lambda t, nz: gpr.gpr_nmll_posterior(eig_t, T(Y), slice(0, m), K, t, nz, SIGMA),
        m, adam_steps=60, dtype=torch.float64, device="cpu"))
    ref = jopt.minimize_t_noisevec(
        lambda t, nz: jgpr.gpr_nmll_posterior(eig_j, jnp.asarray(Y), jnp.arange(m), K, t, nz,
                                              SIGMA),
        m, adam_steps=60, dtype=jnp.float64)
    assert got.noise.shape == (1, m) and got.t.shape == got.obj.shape == (1,)
    for name in ("t", "noise", "obj"):
        np.testing.assert_allclose(getattr(got, name)[0], np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)


def test_a_failed_cholesky_counts_as_inf_not_as_an_error():
    """A grid whose every cell but one is not positive definite: the
    objective's value there is +inf and the finite cell seeds Adam."""
    def fn(t, nz):
        C = torch.eye(2, dtype=torch.float64) * (1.5 - t)[..., None, None]   # PD only for t < 1.5
        return linalg.chol_logdet_half(linalg.cholesky(C)) + (nz - 0.5) ** 2

    res = opt.minimize_t_noise(fn, t_range=(1.0, 1e3), n_grid=4, adam_steps=5,
                               dtype=torch.float64, device="cpu")
    assert np.isfinite(float(res.obj)) and float(res.t) < 1.5


@pytest.mark.parametrize("per_point", [False, True], ids=["scalar-noise", "per-point-noise"])
@pytest.mark.parametrize("m,K", [(25, 30), (40, 10)], ids=["direct", "woodbury"])
def test_lanes_of_one_adam_run_equal_their_own_runs(per_point, m, K):
    """Three spectral pairs (the lanes of a bandwidth grid, each with a
    points axis for the optimizer's (lanes, points) arguments) trained as one
    batched objective land where each lane's own run lands (rtol 1e-9: the
    sum's gradient holds each lane's gradient, batched BLAS may reorder)."""
    from flgp_tpu_torch.types import EigenPair

    pairs = [_gpr_problem(m, K, seed=s)[0] for s in (3, 4, 5)]
    Y = T(_gpr_problem(m, K)[2])

    def objective(pair):
        return lambda t, nz: gpr.gpr_nmll_posterior(pair, Y, slice(0, m), K, t, nz, SIGMA)

    stacked = EigenPair(torch.stack([p.values for p in pairs])[:, None],
                        torch.stack([p.vectors for p in pairs])[:, None])
    kw = dict(adam_steps=40, dtype=torch.float64, device="cpu")
    run = (lambda fn, **k: opt.minimize_t_noisevec(fn, m, **k, **kw)) if per_point else \
        (lambda fn, **k: opt.minimize_t_noise(fn, **k, **kw))
    lanes = run(objective(stacked), lanes=3)
    assert lanes.t.shape == lanes.obj.shape == lanes.grad_norm.shape == (3,)
    assert lanes.noise.shape == ((3, m) if per_point else (3,))
    for a, pair in enumerate(pairs):
        own = run(objective(pair))
        for name in ("t", "noise", "obj"):
            np.testing.assert_allclose(getattr(lanes, name)[a].numpy(),
                                       getattr(own, name)[0].numpy(), rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(float(lanes.grad_norm[a]), float(own.grad_norm), rtol=1e-6,
                                   atol=1e-10)
