"""The sparse GLGP operator and LOBPCG of flgp_tpu_torch against flgp_tpu,
float64, on the same kNN graphs and the same start block.

The port's ``SymCoo`` keeps the ELL arrays and applies gather + scatter-add;
the reference sums over a 2·n·r-edge COO list.  Same sum, another order:
products agree to 1e-12.  LOBPCG is deterministic given X0: eigenvalues to
1e-8, residual norms to 1e-6 absolute, eigenvectors through heat kernels
(which do not see signs or rotations inside an eigenspace) to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.fit import spectral as jspectral
from flgp_tpu.ops.heat_kernel import heat_kernel as jheat_kernel
from flgp_tpu.ops.knn import knn as jknn
from flgp_tpu.ops.lobpcg import lobpcg_standard as jlobpcg
from flgp_tpu.ops.sparse_graph import glgp_operator as jglgp_operator
from flgp_tpu.ops.sparse_graph import symmetrize_knn as jsymmetrize_knn

from flgp_tpu_torch.convert import gl_basis_from_jax, symcoo_from_numpy
from flgp_tpu_torch.fit import spectral
from flgp_tpu_torch.ops.heat_kernel import heat_kernel
from flgp_tpu_torch.ops.lobpcg import lobpcg_standard
from flgp_tpu_torch.ops.sparse_graph import glgp_operator, symmetrize_knn

torch.set_num_threads(1)


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _knn_graph(rng, n, r, d=3):
    X = rng.normal(size=(n, d))
    res = jknn(jnp.asarray(X), jnp.asarray(X), r)
    vals = np.exp(-np.asarray(res.sqdists) / 2.0)
    return np.asarray(res.indices), vals


def _dense_W(idx, vals):
    """The dense construction of the doubly-normalized operator."""
    n, r = idx.shape
    D = np.zeros((n, n))
    np.add.at(D, (np.arange(n)[:, None], idx), vals)
    D = (D + D.T) / 2
    rs = D.sum(1) + 1e-9
    A = D / rs[:, None] / rs[None, :]
    da = A.sum(1) + 1e-9
    return D, A / np.sqrt(da)[:, None] / np.sqrt(da)[None, :]


def test_symmetrize_and_operator_match_reference_and_dense(rng):
    n, r = 60, 5
    idx, vals = _knn_graph(rng, n, r)
    sym = symmetrize_knn(T(idx, torch.int32), T(vals), n)
    jsym = jsymmetrize_knn(jnp.asarray(idx), jnp.asarray(vals), n)
    for name in ("rows", "cols"):
        np.testing.assert_array_equal(getattr(sym, name).numpy(), np.asarray(getattr(jsym, name)))
    np.testing.assert_allclose(sym.vals.numpy(), np.asarray(jsym.vals), rtol=1e-12)
    np.testing.assert_allclose(sym.rowsum().numpy(), np.asarray(jsym.rowsum()), rtol=1e-12)
    D, Wd = _dense_W(idx, vals)
    x, Xk = rng.normal(size=n), rng.normal(size=(n, 4))
    np.testing.assert_allclose(sym.matvec(T(x)).numpy(), D @ x, atol=1e-10)

    W, sda = glgp_operator(sym)
    jW, jsda = jglgp_operator(jsym)
    np.testing.assert_allclose(sda.numpy(), np.asarray(jsda), rtol=1e-12)
    np.testing.assert_allclose(W.vals.numpy(), np.asarray(jW.vals), rtol=1e-12)
    for v in (x, Xk):
        got = W.matvec(T(v)).numpy()
        assert got.shape == v.shape
        np.testing.assert_allclose(got, np.asarray(jW.matvec(jnp.asarray(v))), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got, Wd @ v, atol=1e-8)
    # the reference's edge list converts to the same operator
    back = symcoo_from_numpy(jW.rows, jW.cols, jW.vals, n)
    np.testing.assert_allclose(back.matvec(T(Xk)).numpy(), W.matvec(T(Xk)).numpy(), rtol=1e-12,
                               atol=1e-14)
    with pytest.raises(ValueError, match="symmetrized"):
        symcoo_from_numpy(jW.cols, jW.rows, jW.vals, n)


def test_lobpcg_matches_reference_from_the_same_start(rng):
    n, r, k = 120, 6, 5
    idx, vals = _knn_graph(rng, n, r, d=2)
    W, _ = glgp_operator(symmetrize_knn(T(idx, torch.int32), T(vals), n))
    jW, _ = jglgp_operator(jsymmetrize_knn(jnp.asarray(idx), jnp.asarray(vals), n))
    X0 = rng.normal(size=(n, k))
    got = lobpcg_standard(W.matvec, T(X0), iters=60)
    ref = jlobpcg(jW.matvec, jnp.asarray(X0), iters=60)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(ref.eigenvalues), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.residual_norms.numpy(), np.asarray(ref.residual_norms),
                               rtol=0, atol=1e-6)
    w_np = np.sort(np.linalg.eigvalsh(_dense_W(idx, vals)[1]))[::-1][:k]
    np.testing.assert_allclose(got.eigenvalues.numpy(), w_np, atol=1e-5)
    lam = got.eigenvalues.numpy()
    Hg = (got.eigenvectors.numpy() * np.exp(-2.0 * (1 - lam))) @ got.eigenvectors.numpy().T
    Hr = (np.asarray(ref.eigenvectors) * np.exp(-2.0 * (1 - lam))) @ np.asarray(ref.eigenvectors).T
    np.testing.assert_allclose(Hg, Hr, rtol=0, atol=1e-6)


def test_lobpcg_raises_on_a_rank_deficient_start():
    """Two equal start columns: the Gram matrix is singular beyond what the
    1e-9 ridge repairs in float32, and the solver says so."""
    n = 40
    A = torch.diag(torch.linspace(1.0, 2.0, n))
    X0 = torch.ones((n, 2), dtype=torch.float32)
    X0[:, 1] *= -1.0
    with pytest.raises(RuntimeError, match="positive definite"):
        lobpcg_standard(lambda x: A @ x, X0, iters=2)


def test_clustered_spectrum_six_blobs():
    """Six well-separated blobs give a near-degenerate 6-fold top cluster at
    λ ≈ 1 (the JAX package's hard case, here at n = 600).  LOBPCG from a
    shared start against the reference's, and against the dense eigh."""
    rng = np.random.default_rng(42)
    n, K = 600, 12
    centers = rng.normal(0, 12, size=(6, 3))
    X = np.concatenate([rng.normal(c, 1.0, size=(n // 6, 3)) for c in centers])
    jbasis = jspectral.gl_setup(jnp.asarray(X), sparse=True, threshold=0.0134)   # r = 8
    basis = gl_basis_from_jax(jbasis)
    assert basis.knn_idx.shape == (n, 8)
    dense = spectral.gl_spectrum_at(basis, 1.0, K)
    jdense = jspectral.gl_spectrum_at(jbasis, jnp.asarray(1.0), K)
    dv = dense.values.numpy()
    assert dv[0] - dv[5] < 1e-3, dv[:8]
    np.testing.assert_allclose(dv, np.asarray(jdense.values), rtol=0, atol=1e-9)

    X0 = rng.normal(size=(n, K))
    it, resid = spectral.gl_spectrum_lobpcg_status(None, basis, 1.0, K, iters=150, X0=T(X0))
    vals = jnp.exp(-jbasis.sq_dists / (1.0 * jbasis.dist_mean))
    jW, jsda = jglgp_operator(jsymmetrize_knn(jbasis.knn_idx, vals, n))
    jres = jlobpcg(jW.matvec, jnp.asarray(X0), iters=150)
    np.testing.assert_allclose(it.values.numpy(), np.asarray(jres.eigenvalues), rtol=0, atol=1e-8)
    np.testing.assert_allclose(it.values.numpy(), dv, rtol=0, atol=1e-7)
    assert float(resid.max()) < 1e-5, resid
    idx = slice(0, n, 37)
    H_d = heat_kernel(dense, 2.0, K, idx, idx).numpy()
    H_i = heat_kernel(it, 2.0, K, idx, idx).numpy()
    jidx = jnp.arange(0, n, 37)
    H_j = np.asarray(jheat_kernel(jdense, 2.0, K, jidx, jidx))
    # rotations inside the 6-fold cluster are only approximately heat-kernel
    # invariant (its eigenvalues differ at ~1e-4): the reference's own scale
    np.testing.assert_allclose(H_i, H_d, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(H_d, H_j, rtol=1e-4, atol=1e-3)
