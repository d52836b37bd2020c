"""flgp_tpu_torch.fit.streaming (the O(n·K) GPC predict tail) and the huge-n
slice it closes, against flgp_tpu.

The eigenpair, the anchors and the cluster sizes go to both packages as
the same numpy arrays.  The deterministic parts (the trained t, the
Laplace moments) are compared with the reference at 1e-8; the PG-Gibbs
streams of torch and JAX differ, so the PG probabilities are held against
the port's own dense ``test_pgbinary`` from the same generator state, also
at 1e-8 (only the projection order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.fit import drivers as jdrivers
from flgp_tpu.fit import streaming as jstreaming
from flgp_tpu.ops import colmajor as jcol

from flgp_tpu_torch.convert import eigenpair_from_numpy, fit_config_from_jax
from flgp_tpu_torch.datasets import torus_rings
from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc
from flgp_tpu_torch.fit.streaming import _chunked_rows, _gpc_lowrank_tail
from flgp_tpu_torch.inference.pg_gibbs import test_pgbinary as pgbinary
from flgp_tpu_torch.models.gpc import gpc_posterior_moments
from flgp_tpu_torch.ops import colmajor as col
from flgp_tpu_torch.ops import linalg
from flgp_tpu_torch.ops.heat_kernel import heat_kernel, heat_kernel_diag
from flgp_tpu_torch.types import EigenPair

torch.set_num_threads(1)


def _eigenpair_and_labels(n=900, K=20, m=120, seed=5):
    """An orthonormal √n-scaled basis with eigenvalues in (0.3, 1), and
    labels that follow its leading vectors."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, K)))
    vectors = Q * np.sqrt(n)
    values = np.sort(rng.uniform(0.3, 1.0, size=K))[::-1].copy()
    train_idx = rng.permutation(n)[:m]
    f = vectors[:, 0] + 0.5 * vectors[:, 1]
    Y = (f[train_idx] + 0.3 * rng.normal(size=m) > 0).astype(np.float64)
    return values, vectors, Y, train_idx


@pytest.mark.parametrize("avg_sweeps", [20, 0])
def test_lowrank_tail_matches_reference_and_dense_tail(avg_sweeps):
    values, vectors, Y, train_idx = _eigenpair_and_labels()
    n, K, m, t, sigma = vectors.shape[0], vectors.shape[1], Y.shape[0], 3.0, 1e-3
    jcfg = flgp_tpu.FitConfig(sigma=sigma, dtype=jnp.float64, n_gibbs=40,
                              gibbs_avg_sweeps=avg_sweeps)
    cfg = fit_config_from_jax(jcfg)
    eig = eigenpair_from_numpy(values, vectors)
    Yt, N, tidx = torch.as_tensor(Y), torch.ones(m, dtype=torch.float64), torch.as_tensor(train_idx)

    labels, probs, mean, var = _gpc_lowrank_tail(torch.Generator().manual_seed(7), eig, Yt, N,
                                                 tidx, K, cfg, t, 1, chunk=257)
    assert labels.shape == probs.shape == mean.shape == var.shape == (n,)

    # Laplace moments: deterministic, so against the reference directly
    jtail = jax.jit(lambda key, V, lam: jstreaming._gpc_lowrank_tail(
        key, flgp_tpu.EigenPair(lam, V), jnp.asarray(Y), jnp.ones(m), jnp.asarray(train_idx), K,
        jcfg, jnp.float64(t), 1, chunk=257))
    _, _, jmean, jvar = jtail(jax.random.PRNGKey(7), jnp.asarray(vectors), jnp.asarray(values))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-8)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=1e-8)

    # PG probabilities: the port's dense tail from the same generator state,
    # prediction rows [all] with the σ ridge on the train rows
    Cvv = linalg.add_diag(heat_kernel(eig, t, K, tidx, tidx), sigma)
    C_all = heat_kernel(eig, t, K, torch.arange(n), tidx)
    C_all[tidx] = C_all[tidx] + sigma * torch.eye(m, dtype=torch.float64)
    lab_d, pi_d = pgbinary(torch.Generator().manual_seed(7), Cvv, Yt, C_all, cfg.n_gibbs, N,
                           avg_sweeps=avg_sweeps)
    np.testing.assert_allclose(probs.numpy(), pi_d.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(labels.numpy(), lab_d.numpy())

    # and the Laplace moments at the test rows against the port's dense form
    test_rows = torch.as_tensor(np.setdiff1d(np.arange(n), train_idx))
    mean_d, var_d = gpc_posterior_moments(
        Cvv, heat_kernel(eig, t, K, test_rows, tidx),
        heat_kernel_diag(eig, t, K, test_rows) + sigma, Yt)
    np.testing.assert_allclose(mean[test_rows].numpy(), mean_d.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(var[test_rows].numpy(), var_d.numpy(), rtol=0, atol=1e-8)


def test_lowrank_tail_casts_float32_vectors_block_by_block():
    """A float32 store with an f64 solve dtype gives exactly what the f64
    upcast of that store gives: each row block is cast on its own."""
    values, vectors, Y, train_idx = _eigenpair_and_labels(n=600, m=80, seed=2)
    K, m = vectors.shape[1], Y.shape[0]
    cfg = fit_config_from_jax(flgp_tpu.FitConfig(sigma=1e-3, dtype=jnp.float64, n_gibbs=10,
                                                 gibbs_avg_sweeps=5))
    v32 = torch.as_tensor(vectors, dtype=torch.float32)
    args = (torch.as_tensor(Y), torch.ones(m, dtype=torch.float64), torch.as_tensor(train_idx), K,
            cfg, 2.0, 1)
    got = _gpc_lowrank_tail(torch.Generator().manual_seed(3),
                            EigenPair(torch.as_tensor(values, dtype=torch.float32), v32), *args,
                            chunk=128)
    ref = _gpc_lowrank_tail(torch.Generator().manual_seed(3),
                            EigenPair(torch.as_tensor(values, dtype=torch.float32).double(),
                                      v32.double()), *args, chunk=128)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_chunked_rows_views_and_ragged_last_block():
    V = torch.as_tensor(np.random.default_rng(0).normal(size=(1000, 6)))
    seen = []

    def fn(Vc):
        seen.append(Vc.untyped_storage().data_ptr() == V.untyped_storage().data_ptr())
        return Vc.sum(dim=1), Vc[:, :2] * 2.0

    a, b = _chunked_rows(fn, V, 384)                  # 384 does not divide 1000
    assert len(seen) == 3 and all(seen)              # row views of V, not copies
    np.testing.assert_array_equal(a.numpy(), V.sum(dim=1).numpy())
    np.testing.assert_array_equal(b.numpy(), (V[:, :2] * 2.0).numpy())


def test_colmajor_gpc_slice_matches_reference_f64():
    """The huge-n slice end to end at a size both packages run:
    heat_kernel_spectrum_colmajor (cluster-normalized, padded chunks) +
    _train_gpc + _gpc_lowrank_tail, the composition chip_smoke.py drives at
    n=1e7, with the same anchors and cluster sizes on both sides."""
    n, m, s, K, chunk = 4800, 100, 600, 100, 1024         # 4800 = 4·1024 + 704: the last chunk pads
    tor = torus_rings(n=n, m_train=m, seed=1234)
    X_all = np.concatenate([tor.x_train, tor.x_test])
    # k-means anchors (random rows merge the rings: test error ~0.18), made
    # once by the port's sampler and handed to both packages as numpy
    centers = col.kmeans_anchors_colmajor(torch.Generator().manual_seed(0),
                                          torch.as_tensor(X_all).T, s, n_sample=n).numpy()
    counts = np.bincount(((X_all[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1),
                         minlength=s).astype(np.float64)
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=s, r=3, K=K), sigma=1e-3,
                              dtype=jnp.float64)
    cfg = fit_config_from_jax(jcfg)
    assert cfg.graph.gl.value == "cluster-normalized"

    @jax.jit
    def jfit(key, Xt, U, sizes, Y):
        g = jcfg.graph
        eig = jcol.heat_kernel_spectrum_colmajor(Xt, U, g.r, K, g.gl, g.root,
                                                 cluster_sizes=sizes, chunk=chunk)
        N = jnp.ones((m,))
        res = jdrivers._train_gpc(eig, Y, N, jnp.arange(m), K, jcfg)
        return res.x, jstreaming._gpc_lowrank_tail(key, eig, Y, N, jnp.arange(m), K, jcfg,
                                                   res.x, 1)

    jt, (jlab, _, jmean, jvar) = jfit(jax.random.PRNGKey(0), jnp.asarray(X_all.T),
                                      jnp.asarray(centers), jnp.asarray(counts),
                                      jnp.asarray(tor.y_train))

    # the port, composed as chip_smoke.py composes it
    g = cfg.graph
    eig = col.heat_kernel_spectrum_colmajor(torch.as_tensor(X_all).T, torch.as_tensor(centers),
                                            g.r, K, g.gl, g.root,
                                            cluster_sizes=torch.as_tensor(counts), chunk=chunk)
    Y, N = torch.as_tensor(tor.y_train), torch.ones(m, dtype=torch.float64)
    scfg, eig_m, (Ys, Ns) = _solve_cast(cfg, EigenPair(eig.values, eig.vectors[:m]), Y, N)
    res = _train_gpc(eig_m, Ys, Ns, slice(0, m), K, scfg)
    lab, _, mean, var = _gpc_lowrank_tail(torch.Generator().manual_seed(0), eig, Ys, Ns,
                                          torch.arange(m), K, scfg, res.x, 1)

    np.testing.assert_allclose(float(res.x), float(jt), rtol=1e-8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-8)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=1e-8)
    assert np.mean(np.asarray(jlab)[m:] != tor.y_test) <= 0.03
    assert np.mean(lab.numpy()[m:] != tor.y_test) <= 0.03
