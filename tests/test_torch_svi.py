"""flgp_tpu_torch's stochastic variational inference (``inference/svi.py``).

Deterministic, against ``flgp_tpu.inference.svi`` in float64 at the same
parameters: the two families' entropies and the low-rank family's
covariance, to 1e-12 relative.  Stochastic, by the reference's own gates
(tests/test_inference.py::TestSvi): mean-field recovers a diagonal Gaussian
(means within 0.35, scales within 30%) with a rising ELBO; the rank-2 family
recovers a correlated Gaussian's strong correlations within 0.25 and beats
mean-field's ELBO.  The port's own: the written-out ELBO gradient is
autograd's (1e-10), the fit evaluates the model only through its analytic
``value_and_grad``, and the trace stays a device tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.inference import svi as jsvi

from flgp_tpu_torch.inference.svi import LowRankGaussian, MeanField, fit_svi, fit_svi_lowrank
from flgp_tpu_torch.models.latent import GpcLogPost, WhitenedGP

torch.set_num_threads(1)

F64 = torch.float64
MEAN = torch.tensor([1.0, -2.0, 0.5], dtype=F64)
SCALES = torch.tensor([1.0, 0.5, 2.0], dtype=F64)


def gauss_logprob(x):
    return -0.5 * torch.sum(((x - MEAN) / SCALES) ** 2, dim=-1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_entropy_and_covariance_match_reference():
    rng = np.random.default_rng(0)
    dim, rank = 7, 3
    mu, ls, W = rng.normal(size=dim), 0.3 * rng.normal(size=dim), rng.normal(size=(dim, rank))
    T = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    mf, jmf = MeanField(T(mu), T(ls)), jsvi.MeanField(jnp.asarray(mu), jnp.asarray(ls))
    np.testing.assert_allclose(float(mf.entropy()), float(jmf.entropy()), rtol=1e-12)
    lr = LowRankGaussian(T(mu), T(ls), T(W))
    jlr = jsvi.LowRankGaussian(jnp.asarray(mu), jnp.asarray(ls), jnp.asarray(W))
    np.testing.assert_allclose(float(lr.entropy()), float(jlr.entropy()), rtol=1e-12)
    np.testing.assert_allclose(lr.covariance().numpy(), np.asarray(jlr.covariance()),
                               rtol=1e-12, atol=1e-14)
    # the determinant lemma against the dense log-determinant
    dense = 0.5 * dim * (1 + np.log(2 * np.pi)) + 0.5 * np.linalg.slogdet(
        lr.covariance().numpy())[1]
    np.testing.assert_allclose(float(lr.entropy()), dense, rtol=1e-12)
    np.testing.assert_allclose(mf.covariance().numpy(), np.diag(np.exp(2 * ls)), rtol=1e-15)


def test_samples_have_the_family_s_moments():
    rng = np.random.default_rng(1)
    dim, rank = 4, 2
    T = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    q = LowRankGaussian(T(rng.normal(size=dim)), T(-0.5 * np.ones(dim)),
                        T(rng.normal(size=(dim, rank))))
    x = q.sample(gen(2), 200_000).numpy()
    np.testing.assert_allclose(x.mean(0), q.mu.numpy(), atol=0.02)
    np.testing.assert_allclose(np.cov(x.T), q.covariance().numpy(), atol=0.05)


def test_gaussian_recovery():
    res = fit_svi(gen(0), gauss_logprob, 3, steps=1500, n_mc=8, lr=0.05, dtype=F64,
                  device="cpu")
    np.testing.assert_allclose(res.posterior.mu.numpy(), MEAN.numpy(), atol=0.35)
    np.testing.assert_allclose(np.exp(res.posterior.log_scale.numpy()), SCALES.numpy(),
                               rtol=0.3)
    elbo = res.elbo_trace
    assert isinstance(elbo, torch.Tensor) and elbo.shape == (1500,)
    assert float(elbo[-50:].mean()) > float(elbo[:50].mean())


def test_lowrank_recovers_correlation_and_beats_mean_field():
    rng = np.random.default_rng(3)
    d = 6
    F = rng.normal(size=(d, 2)) * 0.8
    cov = np.diag(np.full(d, 0.3)) + F @ F.T
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu = torch.as_tensor(np.linspace(-1, 1, d))

    def logprob(x):
        dx = x - mu
        return -0.5 * torch.sum((dx @ prec) * dx, dim=-1)

    kw = dict(steps=4000, n_mc=16, lr=0.03, dtype=F64, device="cpu")
    lr_res = fit_svi_lowrank(gen(0), logprob, d, rank=2, **kw)
    mf_res = fit_svi(gen(0), logprob, d, **kw)
    np.testing.assert_allclose(lr_res.posterior.mu.numpy(), mu.numpy(), atol=0.15)
    cov_q = lr_res.posterior.covariance().numpy()
    corr = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    corr_q = cov_q / np.sqrt(np.outer(np.diag(cov_q), np.diag(cov_q)))
    big = np.abs(corr) > 0.4
    np.testing.assert_allclose(corr_q[big], corr[big], atol=0.25)
    assert float(lr_res.elbo_trace[-200:].mean()) > float(mf_res.elbo_trace[-200:].mean())


def _gpc_post(seed=0, m=20, K=6):
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    gp = WhitenedGP(T(rng.normal(size=(m, K))), T(np.linspace(0.0, 0.9, K)), 1e-3)
    Y = T((rng.uniform(size=m) > 0.5).astype(float))
    return GpcLogPost(gp, Y, torch.ones(m, dtype=F64), 1e-2, 10.0, 2.0)


@pytest.mark.parametrize("family", ["mean-field", "low-rank"])
def test_elbo_gradient_is_autograd_s(family):
    """The written-out reparameterization gradient equals autograd's
    gradient of the same ELBO estimate (the same noise) through the density
    and the entropy, in float64."""
    post = _gpc_post()
    rng = np.random.default_rng(6)
    T = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    fields = [T(0.3 * rng.normal(size=post.dim)), T(-1.0 + 0.2 * rng.normal(size=post.dim))]
    if family == "low-rank":
        fields.append(T(0.2 * rng.normal(size=(post.dim, 3))))
    cls = MeanField if family == "mean-field" else LowRankGaussian
    q = cls(*fields)
    x, noise = q.draw(gen(4), 8)
    _, g = post.value_and_grad(x)
    got = q.elbo_grad(g, noise)

    leaves = [f.clone().requires_grad_(True) for f in fields]
    qa = cls(*leaves)
    xa = qa.mu + torch.exp(qa.log_scale) * noise[0]
    if family == "low-rank":
        xa = xa + noise[1] @ qa.W.T
    value = torch.mean(post(xa)) + qa.entropy()
    want = torch.autograd.grad(value, leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_the_fit_takes_the_model_s_value_and_grad():
    post = _gpc_post()
    calls = []

    class Counted:
        device = post.device

        def __call__(self, x):
            raise AssertionError("the fit should take value_and_grad")

        def value_and_grad(self, x):
            calls.append(x.shape)
            return post.value_and_grad(x)

    res = fit_svi_lowrank(gen(5), Counted(), post.dim, rank=2, steps=20, n_mc=4, dtype=F64,
                          device="cpu")
    assert calls == [(4, post.dim)] * 20
    assert bool(torch.all(torch.isfinite(res.elbo_trace)))


def test_initialization_follows_the_reference():
    res = fit_svi_lowrank(gen(0), gauss_logprob, 3, rank=2, steps=0, dtype=F64, device="cpu")
    assert torch.equal(res.posterior.mu, torch.zeros(3, dtype=F64))
    assert torch.equal(res.posterior.log_scale, torch.full((3,), -2.0, dtype=F64))
    W0 = 0.01 * torch.randn((3, 2), generator=gen(0), dtype=F64) / np.sqrt(3)
    assert torch.equal(res.posterior.W, W0)
    init = torch.tensor([1.0, 2.0, 3.0], dtype=F64)
    assert torch.equal(fit_svi(gen(0), gauss_logprob, 3, steps=0, init_mu=init, dtype=F64,
                               device="cpu").posterior.mu, init)


def test_device_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fit_svi(gen(0), gauss_logprob, 3, steps=1)
    with pytest.raises(ValueError, match="generator"):
        fit_svi(gen(0), gauss_logprob, 3, steps=1, device="meta")
