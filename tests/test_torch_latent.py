"""flgp_tpu_torch.models.latent against flgp_tpu.models.latent.

Both packages evaluate the same whitened posterior, built from the same
numpy arrays through ``convert.gpc_logpost_from_jax`` /
``gpr_logpost_from_jax``, in float64: densities and the port's analytic
gradients against the reference's ``__call__`` and ``jax.grad`` at 1e-10
relative, the pieces at 1e-12.  The slice as a whole: the torus fit by both
packages on the same anchors, then ``make_whitened`` and the densities after
the eigenvectors' signs are aligned, at 1e-9.  And one posterior, four
engines: the port's HMC and NUTS on the whitened model against its PG-Gibbs
chain and Laplace moments (tests/test_inference.py:506-590).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.models import latent as jlat

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import (
    anchors_from_numpy,
    eigenpair_from_numpy,
    fit_config_from_jax,
    gpc_logpost_from_jax,
    gpr_logpost_from_jax,
    whitened_from_numpy,
)
from flgp_tpu_torch.inference.hmc import value_and_grad
from flgp_tpu_torch.models import latent as tlat

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _whitened(rng, m, K):
    V = rng.normal(size=(m, K))
    lam = np.sort(rng.uniform(0.0, 1.0, size=K))
    return V, lam


def _posts(kind, rng, m=24, K=8, counts=False):
    """The same posterior in both packages."""
    V, lam = _whitened(rng, m, K)
    jgp = jlat.WhitenedGP(jnp.asarray(V), jnp.asarray(lam), 1e-3)
    if kind == "gpc":
        N = rng.integers(1, 4, size=m).astype(float) if counts else np.ones(m)
        Y = np.floor(rng.uniform(size=m) * (N + 1))
        ref = jlat.GpcLogPost(jgp, jnp.asarray(Y), jnp.asarray(N), 1e-2, 10.0, 2.0)
        return ref, gpc_logpost_from_jax(ref)
    Y = rng.normal(size=m)
    ref = jlat.GprLogPost(jgp, jnp.asarray(Y), 1e-2, 10.0, 2.0, 0.1, 1e-3)
    return ref, gpr_logpost_from_jax(ref)


def _points(rng, dim, n=5):
    x = rng.normal(size=(n, dim))
    x[:, -1] = rng.uniform(-1.0, 4.0, size=n)    # log t from 0.4 to 55
    return x


def _assert_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("kind,m,K,counts", [
    ("gpc", 24, 8, False), ("gpc", 60, 20, True), ("gpc", 7, 30, False),
    ("gpr", 24, 8, False), ("gpr", 60, 20, False), ("gpr", 7, 30, False),
])
def test_density_and_analytic_gradient_match_reference(kind, m, K, counts):
    """The batched density and its analytic gradient at five points against
    the reference's one-point ``__call__`` and ``jax.grad``."""
    rng = np.random.default_rng(m * K)
    ref, got = _posts(kind, rng, m, K, counts)
    assert got.dim == ref.dim
    X = _points(rng, ref.dim)
    if kind == "gpr":
        X[:, -1] = rng.uniform(-6.0, 0.0, size=len(X))           # log noise
    lp, grad = got.value_and_grad(torch.tensor(X))
    assert lp.shape == (len(X),) and grad.shape == X.shape
    for i, x in enumerate(X):
        _assert_close(lp[i].item(), float(ref(jnp.asarray(x))), 1e-10)
        _assert_close(grad[i].numpy(), np.asarray(jax.grad(ref)(jnp.asarray(x))), 1e-10)
    # the value alone is the same code's value, bit for bit
    assert torch.equal(got(torch.tensor(X)), lp)


@pytest.mark.parametrize("kind", ["gpc", "gpr"])
def test_analytic_gradient_is_autograd_s(kind):
    rng = np.random.default_rng(3)
    _, post = _posts(kind, rng, 30, 12)
    X = torch.tensor(_points(rng, post.dim, 7))
    lp, grad = post.value_and_grad(X)
    Xg = X.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(post(Xg).sum(), Xg)
    _assert_close(grad.numpy(), auto.numpy(), 1e-12)
    # the samplers' helper takes the analytic gradient, else autograd of the sum
    assert value_and_grad(post) == post.value_and_grad
    lp2, grad2 = value_and_grad(lambda x: post(x))(X)
    assert torch.equal(lp2, lp)
    _assert_close(grad2.numpy(), grad.numpy(), 1e-12)


def _pieces(rng):
    V, lam = _whitened(rng, 30, 9)
    jgp = jlat.WhitenedGP(jnp.asarray(V), jnp.asarray(lam), 1e-3)
    tgp = whitened_from_numpy(V, lam, 1e-3)
    u = rng.normal(size=(4, 9))
    t = rng.uniform(0.5, 20.0, size=4)
    f = rng.normal(size=(4, 30))
    Y = (rng.uniform(size=30) > 0.5).astype(float)
    N = np.ones(30)
    Yr = rng.normal(size=30)
    theta = np.log(t)
    return {
        "whitened_inv_mass0": (
            lambda: tlat.whitened_inv_mass0(tgp, 10.0, 0.25, 2),
            lambda: jlat.whitened_inv_mass0(jgp, 10.0, 0.25, 2)),
        "latent_f": (
            lambda: tlat.latent_f(tgp, torch.tensor(u), torch.tensor(t)),
            lambda: np.stack([jlat.latent_f(jgp, jnp.asarray(u[i]), t[i]) for i in range(4)])),
        "log_prior_u": (
            lambda: tlat.log_prior_u(torch.tensor(u)),
            lambda: np.stack([jlat.log_prior_u(jnp.asarray(u[i])) for i in range(4)])),
        "t_log_prior_density": (
            lambda: tlat.t_log_prior_density(torch.tensor(t), 1e-2, 10.0, 2.0),
            lambda: jlat.t_log_prior_density(jnp.asarray(t), 1e-2, 10.0, 2.0)),
        "bernoulli_logit_loglik": (
            lambda: tlat.bernoulli_logit_loglik(torch.tensor(f), torch.tensor(Y), torch.tensor(N)),
            lambda: np.stack([jlat.bernoulli_logit_loglik(jnp.asarray(f[i]), jnp.asarray(Y),
                                                          jnp.asarray(N)) for i in range(4)])),
        "gaussian_loglik": (
            lambda: tlat.gaussian_loglik(torch.tensor(f), torch.tensor(Yr), torch.tensor(t)),
            lambda: np.stack([jlat.gaussian_loglik(jnp.asarray(f[i]), jnp.asarray(Yr), t[i])
                              for i in range(4)])),
        "_theta_log_prior": (
            lambda: tlat._theta_log_prior(torch.tensor(theta), torch.tensor(t), 1e-2, 10.0, 2.0,
                                          2.3, 1.5),
            lambda: jlat._theta_log_prior(jnp.asarray(theta), jnp.asarray(t), 1e-2, 10.0, 2.0,
                                          2.3, 1.5)),
    }


@pytest.mark.parametrize("name", list(_pieces(np.random.default_rng(0))))
def test_pieces_match_reference(name):
    got, ref = _pieces(np.random.default_rng(11))[name]
    _assert_close(got().numpy(), np.asarray(ref()), 1e-12)


def test_theta_log_prior_grad_is_the_derivative():
    theta = torch.linspace(-3.0, 6.0, 50, dtype=torch.float64, requires_grad=True)
    lp = tlat._theta_log_prior(theta, torch.exp(theta), 1e-2, 10.0, 2.0, 2.3, 1.5)
    (auto,) = torch.autograd.grad(lp.sum(), theta)
    got = tlat._theta_log_prior_grad(theta.detach(), torch.exp(theta.detach()), 1e-2, 10.0, 2.0,
                                     2.3, 1.5)
    _assert_close(got.numpy(), auto.numpy(), 1e-13)


@pytest.mark.parametrize("kind", ["gpc", "gpr"])
def test_one_density_and_precision_none_is_the_default_bit_for_bit(kind):
    """F4: ``logpost_with_precision`` returns the same density object with
    one field changed; at precision None it is the default, bit for bit, and
    on the CPU (no TF32 there) so is ``"tf32"``."""
    rng = np.random.default_rng(5)
    ref, post = _posts(kind, rng)
    assert post.precision is None
    X = torch.tensor(_points(rng, post.dim))
    base = post.value_and_grad(X)
    for precision in (None, "tf32"):
        other = tlat.logpost_with_precision(post, precision)
        assert type(other) is type(post) and other.precision == precision
        assert other._replace(precision=None) == post
        got = other.value_and_grad(X)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        assert torch.equal(other(X), post(X))
    # the reference's own closure agrees with its NamedTuple on the CPU
    fast = jlat.logpost_with_precision(ref, jax.lax.Precision.DEFAULT)
    assert float(fast(jnp.asarray(X[0].numpy()))) == pytest.approx(float(post(X[0])), rel=1e-12)
    with pytest.raises(ValueError):
        tlat.logpost_with_precision(post, "bf16")
    assert not torch.backends.cuda.matmul.allow_tf32


def test_make_whitened_matches_reference_and_settles_the_device(monkeypatch):
    rng = np.random.default_rng(2)
    vals = np.sort(rng.uniform(0.0, 1.0, 12))[::-1].copy()
    vecs = rng.normal(size=(40, 12))
    idx = np.arange(0, 40, 3)
    ref = jlat.make_whitened(flgp_tpu.EigenPair(jnp.asarray(vals), jnp.asarray(vecs)),
                             jnp.asarray(idx), 10, 1e-3)
    eig = eigenpair_from_numpy(vals, vecs)
    got = tlat.make_whitened(eig, idx, 10, 1e-3, device="cpu")
    np.testing.assert_array_equal(got.V.numpy(), np.asarray(ref.V))
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(ref.lam))
    assert got.sigma == ref.sigma
    with pytest.raises(ValueError, match="eigenpair is on"):
        tlat.make_whitened(eig, idx, 10, 1e-3, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlat.make_whitened(eig, idx, 10, 1e-3)


def test_convert_carries_every_field():
    rng = np.random.default_rng(4)
    for kind in ("gpc", "gpr"):
        ref, got = _posts(kind, rng)
        for name in ref._fields:
            a, b = getattr(ref, name), getattr(got, name)
            if name == "gp":
                np.testing.assert_array_equal(b.V.numpy(), np.asarray(a.V))
                np.testing.assert_array_equal(b.lam.numpy(), np.asarray(a.lam))
                assert b.sigma == a.sigma
            elif isinstance(b, torch.Tensor):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            else:
                assert b == a


# ---------------------------------------------------------------------------
# the slice as a whole: torus fit -> whitened posterior, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def torus_pair():
    """The f64 torus fit of both packages on the same anchors (the fixture
    of tests/test_torch_fit.py), and the labels."""
    from test_torch_fit import _data_and_anchors

    n, s, K = 2400, 240, 40
    tor, centers, counts = _data_and_anchors(n, s)
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=s, r=3, K=K), sigma=1e-3,
                              dtype=jnp.float64)
    ref = flgp_tpu.fit_lae_logit_gp(jax.random.PRNGKey(0), tor.x_train, tor.y_train, tor.x_test,
                                    cfg=jcfg, anchors=(centers, counts))
    got = ft.fit_lae_logit_gp(torch.Generator().manual_seed(0), tor.x_train, tor.y_train,
                              tor.x_test, cfg=fit_config_from_jax(jcfg),
                              anchors=anchors_from_numpy(centers, counts), device="cpu")
    return ref.eigenpair, got.eigenpair, tor, K


@pytest.mark.parametrize("kind", ["gpc", "gpr"])
def test_torus_fit_to_whitened_density_matches_reference(torus_pair, kind):
    """Eigenvectors agree up to sign: each flipped column flips the matching
    u coordinate, and then f, the density and the gradient agree."""
    jeig, teig, tor, K = torus_pair
    m = tor.x_train.shape[0]
    jgp = jlat.make_whitened(jeig, jnp.arange(m), K, 1e-3)
    tgp = tlat.make_whitened(teig, np.arange(m), K, 1e-3, device="cpu")
    signs = np.sign(np.sum(np.asarray(jgp.V) * tgp.V.numpy(), axis=0))
    np.testing.assert_allclose(tgp.V.numpy() * signs, np.asarray(jgp.V), rtol=0, atol=1e-9)
    Y = np.asarray(tor.y_train, dtype=float)
    if kind == "gpc":
        ref = jlat.GpcLogPost(jgp, jnp.asarray(Y), jnp.ones(m), 1e-2, 10.0, 2.0)
        post = tlat.GpcLogPost(tgp, torch.tensor(Y), torch.ones(m, dtype=torch.float64), 1e-2,
                               10.0, 2.0)
    else:
        ref = jlat.GprLogPost(jgp, jnp.asarray(Y), 1e-2, 10.0, 2.0, 0.1, 1e-3)
        post = tlat.GprLogPost(tgp, torch.tensor(Y), 1e-2, 10.0, 2.0, 0.1, 1e-3)
    flip = np.concatenate([signs, np.ones(post.dim - K)])
    X = 0.5 * np.random.default_rng(1234).normal(size=(3, post.dim))
    X[:, K] = np.log([2.0, 30.0, 400.0])
    lp, grad = post.value_and_grad(torch.tensor(X * flip))
    for i, x in enumerate(X):
        _assert_close(lp[i].item(), float(ref(jnp.asarray(x))), 1e-9)
        _assert_close(grad[i].numpy() * flip, np.asarray(jax.grad(ref)(jnp.asarray(x))), 1e-9)


# ---------------------------------------------------------------------------
# one posterior, four engines (tests/test_inference.py:506-590)
# ---------------------------------------------------------------------------


def test_pg_hmc_nuts_laplace_agree():
    """PG-Gibbs, whitened HMC and whitened NUTS target the same binary-GPC
    posterior: their f moments at the training points agree within MC
    error, the Laplace approximation within its approximation error."""
    from flgp_tpu_torch.inference.diagnostics import ess
    from flgp_tpu_torch.inference.hmc import run_hmc
    from flgp_tpu_torch.inference.nuts import run_nuts
    from flgp_tpu_torch.inference.pg_gibbs import pg_gibbs_chain
    from flgp_tpu_torch.models.gpc import gpc_posterior_moments
    from flgp_tpu_torch.models.latent import bernoulli_logit_loglik, log_prior_u
    from flgp_tpu_torch.ops import linalg
    from flgp_tpu_torch.ops.heat_kernel import heat_kernel
    from flgp_tpu_torch.types import EigenPair

    rng = np.random.default_rng(7)
    m, K, t, sigma = 32, 8, 4.0, 1e-3
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    eig = EigenPair(torch.tensor(np.linspace(0.95, 0.3, K)), torch.tensor(Q[:, :K] * np.sqrt(m)))
    Y = torch.tensor((rng.uniform(size=m) > 0.5).astype(float))
    N = torch.ones(m, dtype=torch.float64)
    idx = torch.arange(m)
    C = linalg.add_diag(heat_kernel(eig, t, K, idx, idx), sigma)

    _, f_trace = pg_gibbs_chain(_gen(10), C, Y, n_sweeps=4000)
    f_pg = f_trace[500:].numpy()
    pg_mean, pg_var = f_pg.mean(0), f_pg.var(0)
    pg_mc = np.sqrt(pg_var / np.maximum(ess(f_pg[:, None, :]), 10.0))

    # f = V Λ_t^{1/2} u + √σ w: the extra m whitened coordinates give the σ
    # ridge exactly, so every sampler has one posterior
    Phi = eig.vectors * torch.exp(-0.5 * t * (1.0 - eig.values))[None, :]

    def logprob(x):
        f = x[..., :K] @ Phi.T + np.sqrt(sigma) * x[..., K:]
        return log_prior_u(x) + bernoulli_logit_loglik(f, Y, N)

    def f_draws(samples):
        xs = samples.reshape(-1, samples.shape[-1])
        return (xs[:, :K] @ Phi.T + np.sqrt(sigma) * xs[:, K:]).numpy()

    x0 = 0.1 * torch.randn((8, K + m), generator=_gen(11), dtype=torch.float64)
    f_hmc = f_draws(run_hmc(_gen(12), logprob, x0, n_warmup=300, n_samples=600,
                            n_leapfrog=16).samples)
    f_nuts = f_draws(run_nuts(_gen(13), logprob, x0[:4], n_warmup=300, n_samples=400,
                              max_depth=7).samples)
    la_mean, _ = gpc_posterior_moments(C, C, torch.diagonal(C), Y)
    la_mean = la_mean.numpy()

    tol = 6.0 * pg_mc + 0.05
    for name, f_s in (("hmc", f_hmc), ("nuts", f_nuts)):
        assert np.all(np.abs(f_s.mean(0) - pg_mean) < tol), (
            name, np.max(np.abs(f_s.mean(0) - pg_mean)))
        ratio = f_s.var(0) / pg_var
        assert 0.6 < float(np.median(ratio)) < 1.6, (name, ratio)
    assert np.all(np.abs(la_mean - pg_mean) < 0.30 + 6.0 * pg_mc)
    assert np.corrcoef(la_mean, pg_mean)[0, 1] > 0.98
