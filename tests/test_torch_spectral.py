"""The bandwidth-grid bases of flgp_tpu_torch against flgp_tpu,
float64, on the same points (and, where the setup subsamples, the same
anchors or the reference's own basis carried over by ``convert``).

Eigenvalues agree to 1e-9; eigenvectors are compared through heat kernels
(blind to the sign of a vector) to 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu import GraphConfig as JGraphConfig
from flgp_tpu.fit import spectral as jspectral
from flgp_tpu.ops.heat_kernel import heat_kernel as jheat_kernel
from flgp_tpu.ops.kmeans import SubsampleResult as JSubsampleResult
from flgp_tpu.ops.lobpcg import lobpcg_standard as jlobpcg
from flgp_tpu.ops.sparse_graph import glgp_operator as jglgp_operator
from flgp_tpu.ops.sparse_graph import symmetrize_knn as jsymmetrize_knn

from flgp_tpu_torch import GraphConfig
from flgp_tpu_torch.convert import (
    anchors_from_numpy,
    gl_basis_from_jax,
    nystrom_basis_from_jax,
    se_grid_basis_from_jax,
)
from flgp_tpu_torch.fit import spectral
from flgp_tpu_torch.ops.heat_kernel import heat_kernel

torch.set_num_threads(1)

A2S = (0.3, 1.0, 4.0)


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _cloud(rng, n=240, d=2):
    return rng.normal(size=(n, d)) * np.array([1.0, 0.4, 0.7][:d])


def _same_pair(got, ref, K, rows=40, atol_vec=1e-7):
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=1e-9)
    assert got.vectors.shape == tuple(ref.vectors.shape)
    H = heat_kernel(got, 2.0, K, slice(0, rows), slice(0, rows)).numpy()
    jidx = jnp.arange(rows)
    np.testing.assert_allclose(H, np.asarray(jheat_kernel(ref, 2.0, K, jidx, jidx)), rtol=0,
                               atol=atol_vec)


def test_se_grid_setup_and_spectrum_match_reference(rng):
    X = _cloud(rng)
    s, r, K = 24, 3, 10
    centers = X[rng.choice(len(X), s, replace=False)]
    counts = rng.integers(1, 20, size=s).astype(np.float64)
    g, jg = GraphConfig(s=s, r=r, K=K, kernel="se"), JGraphConfig(s=s, r=r, K=K, kernel="se")
    basis = spectral.se_grid_setup(None, T(X), g, anchors_from_numpy(centers, counts))
    jbasis = jspectral.se_grid_setup(jax.random.PRNGKey(0), jnp.asarray(X), jg,
                                     JSubsampleResult(jnp.asarray(centers), jnp.asarray(counts)))
    np.testing.assert_array_equal(basis.knn_res.indices.numpy(), np.asarray(jbasis.knn_res.indices))
    np.testing.assert_allclose(basis.knn_res.sqdists.numpy(), np.asarray(jbasis.knn_res.sqdists),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(basis.dist_mean), float(jbasis.dist_mean), rtol=1e-12)
    carried = se_grid_basis_from_jax(jbasis)
    for a2 in A2S:
        ref = jspectral.se_spectrum_at(jbasis, jnp.asarray(a2), jg)
        _same_pair(spectral.se_spectrum_at(basis, a2, g), ref, K)
        _same_pair(spectral.se_spectrum_at(carried, a2, g), ref, K)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "knn-sparse"])
def test_gl_setup_and_dense_spectrum_match_reference(rng, sparse):
    X = _cloud(rng, n=150, d=3)
    K = 8
    basis = spectral.gl_setup(T(X), sparse, 0.05)
    jbasis = jspectral.gl_setup(jnp.asarray(X), sparse, 0.05)
    if sparse:
        assert basis.knn_idx.shape == (150, 8)      # r = round(0.05·150)
        np.testing.assert_array_equal(basis.knn_idx.numpy(), np.asarray(jbasis.knn_idx))
        # the nearest neighbour is the point itself, at d² ≈ 0 from the
        # expanded form (not clamped on either side)
        np.testing.assert_array_equal(basis.knn_idx[:, 0].numpy(), np.arange(150))
    else:
        assert basis.knn_idx is None and jbasis.knn_idx is None
    np.testing.assert_allclose(basis.sq_dists.numpy(), np.asarray(jbasis.sq_dists), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(float(basis.dist_mean), float(jbasis.dist_mean), rtol=1e-12)
    for a2 in A2S:
        _same_pair(spectral.gl_spectrum_at(basis, a2, K),
                   jspectral.gl_spectrum_at(jbasis, jnp.asarray(a2), K), K)
    _same_pair(spectral.gl_spectrum_at(gl_basis_from_jax(jbasis), 1.0, K),
               jspectral.gl_spectrum_at(jbasis, jnp.asarray(1.0), K), K)


def test_gl_spectrum_lobpcg_matches_reference_from_the_same_start(rng):
    """The reference draws X0 from its key; both sides get one numpy X0
    (the reference through its own building blocks, as its function does)."""
    n, K = 150, 6
    X = _cloud(rng, n=n, d=3)
    basis = spectral.gl_setup(T(X), True, 0.05)
    jbasis = jspectral.gl_setup(jnp.asarray(X), True, 0.05)
    X0 = rng.normal(size=(n, K))
    eig, resid = spectral.gl_spectrum_lobpcg_status(None, basis, 1.0, K, iters=100, X0=T(X0))
    vals = jnp.exp(-jbasis.sq_dists / (1.0 * jbasis.dist_mean))
    jW, jsda = jglgp_operator(jsymmetrize_knn(jbasis.knn_idx, vals, n))
    jres = jlobpcg(jW.matvec, jnp.asarray(X0), iters=100)
    V = jsda[:, None] * jres.eigenvectors
    V = jnp.sqrt(float(n)) * V / (jnp.linalg.norm(V, axis=0)[None, :] + 1e-9)
    _same_pair(eig, type(jspectral.gl_spectrum_at(jbasis, jnp.asarray(1.0), K))(
        jres.eigenvalues, V), K)
    np.testing.assert_allclose(resid.numpy(), np.asarray(jres.residual_norms), rtol=0, atol=1e-6)
    # and the iterative solve finds the dense one's eigensystem
    dense = spectral.gl_spectrum_at(basis, 1.0, K)
    np.testing.assert_allclose(eig.values.numpy(), dense.values.numpy(), rtol=0, atol=1e-6)
    # a generator draws the start when none is given
    drawn = spectral.gl_spectrum_lobpcg(torch.Generator().manual_seed(0), basis, 1.0, K, iters=100)
    np.testing.assert_allclose(drawn.values.numpy(), dense.values.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sparse"):
        spectral.gl_spectrum_lobpcg(None, spectral.gl_setup(T(X), False, 0.05), 1.0, K)


@pytest.mark.parametrize("rcond", [0.0, 1e-3])
def test_nystrom_basis_matches_reference(rng, rcond):
    X = _cloud(rng)
    s, K, m = 24, 10, 50
    jg = JGraphConfig(s=s, r=3, K=K)
    jbasis = jspectral.nystrom_setup(jax.random.PRNGKey(3), jnp.asarray(X), jg)
    basis = nystrom_basis_from_jax(jbasis)
    # the port's own setup on the reference's centers gives the same distances
    assert spectral.nystrom_setup(torch.Generator().manual_seed(0), T(X),
                                  GraphConfig(s=s, r=3, K=K)).dist_allU.shape == (len(X), s)
    for a2 in A2S:
        anchor, Z_UU = spectral.nystrom_anchor_eigs(basis, a2, K)
        janchor, jZ_UU = jspectral.nystrom_anchor_eigs(jbasis, jnp.asarray(a2), K)
        np.testing.assert_allclose(Z_UU.numpy(), np.asarray(jZ_UU), rtol=1e-12)
        _same_pair(anchor, janchor, K, rows=s)
        for rows, from_cols in ((slice(0, m), False), (slice(None), True)):
            ext = spectral.nystrom_extend(anchor, Z_UU, basis.dist_allU[rows], a2,
                                          basis.dist_mean, from_cols, rcond=rcond)
            jext = jspectral.nystrom_extend(janchor, jZ_UU, jbasis.dist_allU[rows],
                                            jnp.asarray(a2), jbasis.dist_mean, from_cols,
                                            rcond=rcond)
            # 1/λ amplifies the trailing columns (λ down to ~1e-6 at rcond 0)
            _same_pair(ext, jext, K, atol_vec=1e-7 if rcond else 1e-5)
