"""The sparse GLGP operator and LOBPCG of flgp_tpu_torch against flgp_tpu,
float64, on the same kNN graphs and the same start block.

The port's ``SymCoo`` keeps the ELL arrays and, for the kernel, the CSR
structure of the transposed entries whose reverse edge the graph lacks (the
others fold into the forward weights); its plain product is gather +
scatter-add, the kernel's plain version (``ell_sym_matmat_plain``) a gather
plus a scatter-add over the CSR entries.  The reference sums over a 2·n·r-edge COO list.  Same sum, another
order: products agree to 1e-12 in float64 and 1e-5 in float32.  LOBPCG is deterministic given X0: eigenvalues to
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
from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.ops.heat_kernel import heat_kernel
from flgp_tpu_torch.ops.lobpcg import lobpcg_standard
from flgp_tpu_torch.ops.sparse_graph import SymCoo, glgp_operator, sym_structure, symmetrize_knn
from flgp_tpu_torch.types import EllMatrix

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


def _awkward_graph(rng, n=40, r=4):
    """Column 7 is a hub (every row names it), columns 3 and 30 have no
    in-edges, row 5 names one column twice and column 7 twice, row 7 names
    column 5 twice (so 5 ↔ 7 is mutual with duplicates on both sides), row 9
    names itself."""
    idx = rng.integers(0, n, size=(n, r))
    idx[idx == 3] = 4
    idx[idx == 30] = 31
    idx[:, 0] = 7
    idx[5, 1] = idx[5, 2]
    idx[7, 1] = idx[7, 2] = 5
    idx[5, 3] = 7
    idx[9, 3] = 9
    return idx.astype(np.int32), rng.uniform(0.1, 1.0, size=(n, r))


def test_transpose_structure_round_trips_to_dense(rng):
    n, r = 40, 4
    idx, vals = _awkward_graph(rng, n, r)
    Z = EllMatrix(T(vals), T(idx, torch.int32), n)
    tr = Z.transpose_structure()
    ptr, src, perm = tr.ptr.numpy(), tr.src.numpy(), tr.perm.numpy()
    assert tr.ptr.dtype == tr.src.dtype == torch.int32 and tr.perm.dtype == torch.int64
    assert ptr[0] == 0 and ptr[-1] == n * r and np.all(np.diff(ptr) >= 0)
    assert ptr[8] - ptr[7] == np.sum(idx == 7) >= n                 # the hub
    assert ptr[4] == ptr[3] and ptr[31] == ptr[30]                  # rows with no in-edge
    np.testing.assert_array_equal(np.sort(perm), np.arange(n * r))
    np.testing.assert_array_equal(src, perm // r)
    dense_t = np.zeros((n, n))
    vt = vals.reshape(-1)[perm]
    for i in range(n):
        seg = slice(ptr[i], ptr[i + 1])
        assert np.all(np.diff(perm[seg]) > 0)                 # stable: flat order within a row
        np.testing.assert_array_equal(idx.reshape(-1)[perm[seg]], i)
        np.add.at(dense_t[i], src[seg], vt[seg])
    np.testing.assert_allclose(dense_t, Z.to_dense().numpy().T, rtol=0, atol=1e-15)
    # an index outside [0, n) belongs to no row of the transpose
    bad = idx.copy()
    bad[0, 0], bad[1, 0] = n, -1
    tr_bad = EllMatrix(T(vals), T(bad, torch.int32), n).transpose_structure()
    assert int(tr_bad.ptr[-1]) == n * r - 2
    assert int(tr_bad.ptr[8] - tr_bad.ptr[7]) == np.sum(idx == 7) - 2
    assert set(tr_bad.perm[-2:].tolist()) == {0, r}
    # and so does an entry the caller masks out
    skip = torch.zeros(n * r, dtype=torch.bool)
    skip[[2 * r, 3 * r]] = True                                  # rows 2 and 3, k = 0: the hub
    tr_skip = Z.transpose_structure(skip=skip)
    assert int(tr_skip.ptr[-1]) == n * r - 2 and set(tr_skip.perm[-2:].tolist()) == {2 * r, 3 * r}


def test_sym_structure_folds_mutual_edges(rng):
    """An entry whose reverse edge is in the graph is mutual: its transposed
    copy folds into the forward weight of the reverse edge's first copy, and
    the CSR keeps the rest.  Forward(folded) + CSR is Z + Zᵀ as a dense
    matrix, with duplicates, a self-loop, a hub and out-of-range indices."""
    n, r = 40, 4
    idx, vals = _awkward_graph(rng, n, r)
    idx[0, 1], idx[1, 1] = n, -1                                 # in neither half
    sym = SymCoo(T(idx, torch.int32), T(vals), n)
    forward, tr, vt = sym.kernel_arrays()
    st = sym.structure
    edges = {(i, int(j)) for i in range(n) for j in idx[i] if 0 <= j < n}
    want = np.array([[0 <= j < n and (int(j), i) in edges for j in idx[i]] for i in range(n)])
    np.testing.assert_array_equal(st.mutual.numpy().reshape(n, r), want)
    assert want[9, 3] and want[5].sum() >= 2 and want[7, 1] and want[7, 2]
    twin = st.twin.numpy().reshape(n, r)
    for i, k in zip(*np.nonzero(want)):
        j = idx[i, k]
        assert twin[i, k] == j * r + list(idx[j]).index(i)      # the first copy of j → i
    assert int(tr.ptr[-1]) == len([1 for i in range(n) for j in idx[i] if 0 <= j < n]) - want.sum()
    ok = (idx >= 0) & (idx < n)
    dense = np.zeros((n, n))
    np.add.at(dense, (np.arange(n)[:, None].repeat(r, 1)[ok], idx[ok]), vals[ok])
    got = np.zeros((n, n))
    np.add.at(got, (np.arange(n)[:, None].repeat(r, 1)[ok], idx[ok]), forward.numpy()[ok])
    ptr, src = tr.ptr.numpy(), tr.src.numpy()
    for i in range(n):
        np.add.at(got[i], src[ptr[i]:ptr[i + 1]], vt.numpy()[ptr[i]:ptr[i + 1]])
    np.testing.assert_allclose(got, dense + dense.T, rtol=0, atol=1e-14)
    # the values are folded again for a rescaled operator, the structure is not rebuilt
    idx[0, 1] = idx[1, 1] = 0                                   # scale_sym gathers d at the indices
    clean = SymCoo(T(idx, torch.int32), T(vals), n)
    f1, tr1, _ = clean.kernel_arrays()
    scaled = clean.scale_sym(T(rng.uniform(0.5, 2.0, size=n)))
    assert scaled.structure is clean.structure
    f2, tr2, _ = scaled.kernel_arrays()
    assert tr2 is tr1 and not np.allclose(f2.numpy(), f1.numpy())


@pytest.mark.parametrize("how", ["assign", "in_place", "structure"])
def test_kernel_arrays_follow_values_and_structure(rng, how):
    """The folded values a ``SymCoo`` keeps for the kernel are made again
    when ``values`` is assigned or written in place, or ``structure`` is
    assigned: the kernel's arrays always give the product of the plain
    composition, which reads ``values`` directly."""
    n, r = 40, 4
    idx, vals = _awkward_graph(rng, n, r)
    sym = symmetrize_knn(T(idx, torch.int32), T(vals), n)
    first = sym.kernel_arrays()
    assert sym.kernel_arrays()[0] is first[0]                   # unchanged: kept
    if how == "assign":
        sym.values = sym.values * 3.0
    elif how == "in_place":
        sym.values.mul_(3.0)
    else:
        sym.structure = sym_structure(sym.indices, n)
    forward, tr, vt = sym.kernel_arrays()
    assert forward is not first[0] and tr is sym.structure.transpose
    x = T(rng.normal(size=(n, 3)))
    got = hk.ell_sym_matmat_plain(forward, sym.indices, tr.ptr, tr.src, vt, x)
    np.testing.assert_allclose(got.numpy(), sym.matvec(x).numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "scale_sym"])
@pytest.mark.parametrize("cols", [None, 5], ids=["vector", "block"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_sym_product_matches_reference(rng, dtype, tol, cols, scaled):
    """``ell_sym_matmat_plain`` (on the operator's folded arrays and on the
    plain transpose) and ``SymCoo.matvec`` against the reference's COO
    ``SymCoo.matvec`` on a graph with a hub, empty in-rows, duplicate and
    mutual edges and a self-loop, for a vector and an (n, k) block, before
    and after ``scale_sym``.  The structure is made once and handed on by
    ``scale_sym``; only the values are prepared again."""
    n, r = 40, 4
    idx, vals = _awkward_graph(rng, n, r)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sym = symmetrize_knn(T(idx, torch.int32), T(vals, dtype), n)
    jsym = jsymmetrize_knn(jnp.asarray(idx), jnp.asarray(vals, jdt), n)
    st = sym_structure(sym.indices, n)
    sym.structure = st
    if scaled:
        d = rng.uniform(0.5, 2.0, size=n)
        sym, jsym = sym.scale_sym(T(d, dtype)), jsym.scale_sym(jnp.asarray(d, jdt))
        assert sym.structure is st
    x = rng.normal(size=n if cols is None else (n, cols))
    ref = np.asarray(jsym.matvec(jnp.asarray(x, jdt)))
    got = sym.matvec(T(x, dtype))
    assert got.shape == x.shape and got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    forward, tr, vt = sym.kernel_arrays()
    assert tr is st.transpose and 0 < int(tr.ptr[-1]) < n * r
    X = T(x, dtype).reshape(n, -1)
    for fn in (hk.ell_sym_matmat_plain, hk.ell_sym_matmat):      # the wrapper: plain on the CPU
        out = fn(forward, sym.indices, tr.ptr, tr.src, vt, X)
        np.testing.assert_allclose(out.numpy().reshape(x.shape), ref, rtol=tol, atol=tol)
    # the same product from the whole transpose, nothing folded; a small
    # entry block exercises the scatter's blocking and its ragged end
    full = EllMatrix(sym.values, sym.indices, n).transpose_structure()
    out = hk.ell_sym_matmat_plain(sym.values, sym.indices, full.ptr, full.src,
                                  sym.values.reshape(-1)[full.perm], X, block=37)
    np.testing.assert_allclose(out.numpy().reshape(x.shape), ref, rtol=tol, atol=tol)


def test_sparse_basis_carries_the_transpose_structure(rng):
    """``gl_setup`` sorts the kNN indices once; every bandwidth's operator
    (``symmetrize_knn`` → ``glgp_operator``) reuses that structure.  Every
    point is its own nearest neighbour, so the self-loops are all mutual."""
    X = T(rng.normal(size=(80, 3)))
    basis = spectral.gl_setup(X, True, 0.05)
    st = basis.structure
    assert st is not None and bool(st.mutual.reshape(80, 4)[:, 0].all())
    assert int(st.transpose.ptr[-1]) == 80 * 4 - int(st.mutual.sum())
    ref = sym_structure(basis.knn_idx, 80)
    for got, want in zip((*st.transpose, st.mutual, st.twin), (*ref.transpose, ref.mutual, ref.twin)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    W, _ = glgp_operator(symmetrize_knn(basis.knn_idx, torch.exp(-basis.sq_dists), 80, st))
    assert W.structure is st
    assert spectral.gl_setup(X, False, 0.05).structure is None
    assert SymCoo(basis.knn_idx, basis.sq_dists, 80).structure is None      # built at first need


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
