"""flgp_tpu_torch's hyperposteriors over the diffusion time
(``inference/hyperparam.py``).

Deterministic: ``mult_t_quadrature`` against ``flgp_tpu.inference.
hyperparam.mult_t_quadrature`` on the same toy eigenpair in float64 (the
reference's tests/test_inference.py::TestHyperparamSmc pair), t-mean, t-sd,
log evidence and the coarse weight to 1e-8 relative.  Stochastic, by the
reference's gates: ``gpc_t_posterior`` lands within 1.5 in log t of the grid
optimum of ``gpc_nlp_objective``; ``mult_t_posterior`` has the reference's
shapes, finite evidence and positive t, and at the 64-particle, 5-mutation
budget its t-means sit within 1.0 quadrature sd of the quadrature's on every
class and 0.5 on average.  The port's own: the chunked ladder gives the same
bits, t_sd is the population sd, and ``device=None`` needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.fit.multiclass import one_hot_labels as j_one_hot
from flgp_tpu.inference import hyperparam as jhyp
from flgp_tpu.types import EigenPair as JEigenPair

from flgp_tpu_torch.fit.multiclass import one_hot_labels
from flgp_tpu_torch.inference import hyperparam as hyp
from flgp_tpu_torch.models.gpc import gpc_nlp_objective
from flgp_tpu_torch.models.latent import latent_f, make_whitened
from flgp_tpu_torch.types import EigenPair

torch.set_num_threads(1)

F64 = torch.float64


def toy(seed=0, n=60, K=12):
    """The reference test's toy spectrum: orthonormal columns scaled by √n,
    W-eigenvalues in (0.2, 1] descending."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    vectors = Q[:, :K] * np.sqrt(n)
    values = np.sort(rng.uniform(0.2, 1.0, K))[::-1].copy()
    return rng, values, vectors


def pair(values, vectors):
    return EigenPair(torch.as_tensor(values, dtype=F64), torch.as_tensor(vectors, dtype=F64))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def informative_labels(rng, eig, m, K, J):
    """Labels of J classes drawn from latent functions at known times, so
    each class's t-posterior is informative."""
    gp = make_whitened(eig, torch.arange(m), K, 1e-3, device="cpu")
    u = torch.as_tensor(rng.normal(size=(J, K)), dtype=F64)
    f = latent_f(gp, u, torch.tensor([1.0, 3.0, 10.0][:J], dtype=F64))    # (J, m)
    return torch.argmax(f, dim=0)


@pytest.mark.parametrize("n_grid", [64, 256])
def test_mult_t_quadrature_matches_reference(n_grid):
    rng, values, vectors = toy()
    m, K, J = 30, 12, 3
    labels = rng.integers(0, J, size=m)
    ref = jhyp.mult_t_quadrature(JEigenPair(jnp.asarray(values), jnp.asarray(vectors)),
                                 j_one_hot(jnp.asarray(labels), J), jnp.arange(m), K, 1e-3,
                                 n_grid=n_grid)
    got = hyp.mult_t_quadrature(pair(values, vectors),
                                one_hot_labels(torch.as_tensor(labels, dtype=F64), J),
                                torch.arange(m), K, 1e-3, n_grid=n_grid, device="cpu")
    for name in ("t_mean", "t_sd", "log_evidence", "coarse_max_weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-8, atol=0, err_msg=name)


def test_gpc_t_posterior_near_the_grid_optimum():
    """The reference's gate: the posterior mass sits within 1.5 in log t of
    the 1-D grid optimum of the "posterior" objective."""
    rng, values, vectors = toy()
    eig = pair(values, vectors)
    m, K, sigma = 40, 12, 1e-3
    gp = make_whitened(eig, torch.arange(m), K, sigma, device="cpu")
    f = latent_f(gp, torch.as_tensor(rng.normal(size=K), dtype=F64), 3.0)
    Y = (torch.sigmoid(f) > 0.5).to(F64)
    post = hyp.gpc_t_posterior(gen(0), eig, Y, torch.arange(m), K, sigma, n_particles=128,
                               device="cpu")
    assert np.isfinite(float(post.log_evidence))
    t_mean = float(post.t_mean)
    assert 1e-2 < t_mean < 1e3
    ts = torch.exp(torch.linspace(-2, 5, 60, dtype=F64))
    objs = gpc_nlp_objective(eig, Y, torch.ones(m, dtype=F64), torch.arange(m), K, ts, sigma)
    t_star = float(ts[int(torch.argmin(objs))])
    assert abs(np.log(t_mean) - np.log(t_star)) < 1.5
    assert post.t.shape == (128,)
    assert float(post.t_sd) == pytest.approx(float(np.std(post.t.numpy())), rel=1e-12)


def test_mult_t_posterior_shapes_positive_and_chunked_same_bits():
    rng, values, vectors = toy()
    eig = pair(values, vectors)
    m, K, J = 30, 12, 3
    aug = one_hot_labels(torch.as_tensor(rng.integers(0, J, size=m), dtype=F64), J)
    kw = dict(n_particles=32, n_mutation_steps=3, device="cpu")
    post = hyp.mult_t_posterior(gen(0), eig, aug, torch.arange(m), K, 1e-3, **kw)
    assert post.t.shape == (32, J) and post.t_mean.shape == (J,) and post.t_sd.shape == (J,)
    assert np.isfinite(float(post.log_evidence))
    assert bool(torch.all(post.t > 0))
    np.testing.assert_allclose(post.t_sd.numpy(), np.std(post.t.numpy(), axis=0), rtol=1e-12)
    ck = hyp.mult_t_posterior(gen(0), eig, aug, torch.arange(m), K, 1e-3,
                              stages_per_dispatch=2, **kw)
    assert ck.smc.n_stages == post.smc.n_stages
    assert torch.equal(ck.t, post.t) and torch.equal(ck.log_evidence, post.log_evidence)
    assert torch.equal(ck.smc.temperatures, post.smc.temperatures)


def test_mult_t_posterior_matches_quadrature_at_the_bench_budget():
    """The reference's statistical gate (tests/test_end_to_end.py) at 64
    particles and 5 mutations: SMC t-means within 1.0 quadrature sd on every
    class and 0.5 on average."""
    rng, values, vectors = toy(n=120, K=16)
    eig = pair(values, vectors)
    m, K, J = 80, 16, 3
    aug = one_hot_labels(informative_labels(rng, eig, m, K, J).to(F64), J)
    quad = hyp.mult_t_quadrature(eig, aug, torch.arange(m), K, 1e-3, device="cpu")
    assert float(quad.coarse_max_weight) < 0.5
    post = hyp.mult_t_posterior(gen(3), eig, aug, torch.arange(m), K, 1e-3, n_particles=64,
                                n_mutation_steps=5, device="cpu")
    err = (torch.abs(post.t_mean - quad.t_mean) / quad.t_sd).numpy()
    assert err.max() < 1.0, err
    assert err.mean() < 0.5, err


def test_device_none_needs_a_card_and_the_pair_must_be_on_the_device():
    _, values, vectors = toy()
    eig = pair(values, vectors)
    aug = one_hot_labels(torch.zeros(10, dtype=F64), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            hyp.mult_t_quadrature(eig, aug, torch.arange(10), 12, 1e-3)
    with pytest.raises(ValueError, match="eigenpair"):
        hyp.mult_t_quadrature(eig, aug, torch.arange(10), 12, 1e-3, device="meta")
