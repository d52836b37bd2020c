"""flgp_tpu_torch.ops.colmajor and kernels K6–K8 against flgp_tpu.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX Pallas kernels run in interpret mode, as tests/test_pallas.py runs them;
the JAX colmajor functions take their CPU composition.  The port's kernel
wrappers take their plain versions for CPU tensors.  Tolerances: float64
comparisons are exact up to summation order (1e-10 to 1e-12, 1e-7 for
eigenvectors as tests/test_colmajor.py); float32 ones follow
tests/test_pallas.py (2e-5 / 3e-5 for the tail kernels, 1e-5 for
eigenvalues and 5e-3 for eigenvectors of the f32 spectrum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.config import KernelType as JKernel
from flgp_tpu.config import LaplacianType as JLaplacian
from flgp_tpu.ops import colmajor as jcol
from flgp_tpu.ops import pallas_kernels as pk
from flgp_tpu.ops.knn import knn as jknn

from flgp_tpu_torch.config import EPS, KernelType, LaplacianType
from flgp_tpu_torch.ops import colmajor as col
from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.ops.spectrum import spectrum_fused

torch.set_num_threads(1)


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _data(n=517, d=3, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=(s, d))


def _chunked_graph(rng, nch=3, r=3, c=128, s=40):
    """Random chunked f32 graph with a zero-weight pad tail (build_graph_colmajor's
    contract), as tests/test_pallas.py makes it."""
    w = rng.uniform(0.1, 1.0, size=(nch, r, c)).astype(np.float32)
    idx = rng.integers(0, s, size=(nch, r, c)).astype(np.int32)
    w[-1, :, c // 2:] = 0.0
    cs = rng.uniform(0.5, 2.0, size=(s,)).astype(np.float32)
    return w, idx, cs, s


def _flat(a_c, n):
    a = np.asarray(a_c)
    nch, r, c = a.shape
    return np.moveaxis(a, 1, 2).reshape(nch * c, r)[:n]


def _up_to_sign(got, ref, atol):
    signs = np.sign(np.sum(ref * got, axis=0))
    np.testing.assert_allclose(got * signs, ref, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# K6–K8 plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("kernel", ["colsum", "norm_gram", "norm_matmat"])
def test_tail_t_plain_matches_pallas_interpret(rng, kernel, r):
    w, idx, cs, s = _chunked_graph(rng, r=r)
    wt, it, ct = T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32)
    if kernel == "colsum":
        got = hk.ell_colsum_t(wt, it, s)
        ref = pk.ell_colsum_t(jnp.asarray(w), jnp.asarray(idx), s, block=64, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5)
    elif kernel == "norm_gram":
        G, D = hk.ell_norm_gram_t(wt, it, ct)
        Gr, Dr = pk.ell_norm_gram_t(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(cs), block=64,
                                    interpret=True)
        np.testing.assert_allclose(D.numpy(), np.asarray(Dr), atol=3e-5)
        np.testing.assert_allclose(G.numpy(), np.asarray(Gr), atol=3e-5)
    else:
        W = rng.normal(size=(s, 8)).astype(np.float32)
        got = hk.ell_norm_matmat_t(wt, it, ct, T(W, torch.float32))
        ref = pk.ell_norm_matmat_t(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(cs),
                                   jnp.asarray(W), block=64, interpret=True)
        assert got.shape == (3 * 128, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)
        np.testing.assert_array_equal(got.numpy()[-64:], 0.0)     # pad rows


@pytest.mark.parametrize("r", [2, 4])
def test_norm_gram_t_with_a_repeated_anchor_matches_pallas_interpret(rng, r):
    """Rows that name one anchor twice (every third point's first two
    slots): the two slots' product belongs on Ĝ's diagonal twice, which the
    CUDA kernel's upper-triangle accumulation has to repeat; here the plain
    version against the Pallas kernel."""
    w, idx, cs, s = _chunked_graph(rng, r=r)
    idx[:, 1, ::3] = idx[:, 0, ::3]
    G, D = hk.ell_norm_gram_t(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32))
    Gr, Dr = pk.ell_norm_gram_t(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(cs), block=64,
                                interpret=True)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dr), atol=3e-5)
    np.testing.assert_allclose(G.numpy(), np.asarray(Gr), atol=3e-5)
    # the upper triangle with doubled repeated-anchor products, mirrored, is Ĝ
    wn = hk._normalized_t(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32),
                          EPS).double().numpy()
    up = np.zeros((s, s))
    for a in range(r):
        for b in range(a, r):
            lo, hi = np.minimum(idx[:, a], idx[:, b]), np.maximum(idx[:, a], idx[:, b])
            twice = np.where((b > a) & (lo == hi), 2.0, 1.0)
            np.add.at(up, (lo.ravel(), hi.ravel()), (twice * wn[:, a] * wn[:, b]).ravel())
    np.testing.assert_allclose(up + np.triu(up, 1).T, G.double().numpy(), atol=3e-5)


def test_tail_t_plain_versions_equal_point_major_ones_f64(rng):
    """K6–K8's plain versions on the chunked layout equal K3–K5's on the
    same graph laid out (n, r) (f64: up to summation order)."""
    w, idx, cs, s = _chunked_graph(rng)
    n = 2 * 128 + 64
    wt, it, ct = T(w), T(idx, torch.int32), T(cs)
    wp, ip = col.point_major(wt, n), col.point_major(it, n)
    W = T(rng.normal(size=(s, 6)))
    np.testing.assert_allclose(hk.ell_colsum_t_plain(wt, it, s).numpy(),
                               hk.ell_colsum_plain(wp, ip, s).numpy(), rtol=1e-12, atol=1e-12)
    for a, b in zip(hk.ell_norm_gram_t_plain(wt, it, ct), hk.ell_norm_gram_plain(wp, ip, ct)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(hk.ell_norm_matmat_t_plain(wt, it, ct, W).numpy()[:n],
                               hk.ell_norm_matmat_plain(wp, ip, ct, W).numpy(),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# build_graph_colmajor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["lae", "se"])
def test_build_graph_matches_reference_f64(kernel):
    X, U = _data(seed=0 if kernel == "lae" else 3)
    n = X.shape[0]
    eps4 = 4.0 * 0.7 ** 2
    idx, w = col.build_graph_colmajor(T(X).T, T(U), 3, KernelType(kernel), eps4, chunk=128)
    jidx, jw = jcol.build_graph_colmajor(jnp.asarray(X.T), jnp.asarray(U), 3, JKernel(kernel),
                                         jnp.asarray(eps4), chunk=128)
    assert idx.shape == w.shape == (5, 3, 128) and idx.dtype == torch.int32
    np.testing.assert_array_equal(_flat(idx, n), _flat(jidx, n))
    np.testing.assert_allclose(_flat(w, n), _flat(jw, n), rtol=0,
                               atol=1e-10 if kernel == "lae" else 1e-12)
    np.testing.assert_array_equal(_flat(w, 5 * 128)[n:], 0.0)    # pads weigh exactly 0


def test_build_graph_lae_weights_match_fista_t():
    """The chunk weights (K2's plain version) equal the TPU layout's own
    FISTA, ``_fista_t_xla``, on the same neighbours."""
    X, U = _data(seed=1)
    n = X.shape[0]
    idx, w = col.build_graph_colmajor(T(X).T, T(U), 3, chunk=128)
    ii = _flat(idx, n)
    Ui = U[ii]                                                   # (n, r, d)
    Gt = np.einsum("nrd,nsd->nrs", Ui, Ui).reshape(n, 9).T
    bt = np.einsum("nd,nrd->nr", X, Ui).T
    ref = jcol._fista_t_xla(jnp.asarray(Gt), jnp.asarray(bt), iters=150)
    np.testing.assert_allclose(_flat(w, n), np.asarray(ref).T, rtol=0, atol=1e-12)


def test_build_graph_se_needs_its_bandwidth():
    X, U = _data(n=50)
    with pytest.raises(ValueError, match="epsilon_sq4"):
        col.build_graph_colmajor(T(X).T, T(U), 3, KernelType.SE)


# ---------------------------------------------------------------------------
# normalize_colmajor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gl", ["rw", "normalized", "cluster-normalized"])
@pytest.mark.parametrize("layout", ["flat", "chunked"])
def test_normalize_matches_reference(gl, layout):
    X, U = _data(seed=1)
    s = U.shape[0]
    res = jknn(jnp.asarray(X), jnp.asarray(U), 3)
    vals, ii = np.exp(-np.asarray(res.sqdists) / 2.0).T, np.asarray(res.indices).T   # (r, n)
    if layout == "chunked":                                      # (r, 517) → (1, r, 517)
        vals, ii = vals[None], ii[None]
    counts = np.random.default_rng(2).integers(1, 30, size=(s,)).astype(np.float64)
    got = col.normalize_colmajor(T(ii, torch.int32), T(vals), s, LaplacianType(gl), T(counts))
    ref = jcol.normalize_colmajor(jnp.asarray(ii), jnp.asarray(vals), s, JLaplacian(gl),
                                  jnp.asarray(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# heat_kernel_spectrum_colmajor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,s", [(3, 24), (24, 48)])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kernel", ["lae", "se"])
def test_spectrum_matches_reference(kernel, dtype, r, s):
    """f64: the exact composition on both sides.  f32: the port's fused
    K6 → K7 → eigh → K8 tail (plain versions) against the reference's f32
    composition; at r = 24 the same (K1 takes its plain version there, the
    reference its XLA product), with r < s: at r = s every point's LAE
    problem spans all the anchors, and the two float32 paths each land some
    5e-6 from the float64 eigenvalues, on either side."""
    X, U = _data(n=413, s=s, seed=5)
    K, eps4 = 10, 4.0 * 0.8 ** 2
    npd, tdt = (np.float64, torch.float64) if dtype == "f64" else (np.float32, torch.float32)
    got = col.heat_kernel_spectrum_colmajor(T(X, tdt).T, T(U, tdt), r, K,
                                            LaplacianType.NORMALIZED, True, KernelType(kernel),
                                            eps4, chunk=128)
    ref = jcol.heat_kernel_spectrum_colmajor(jnp.asarray(X.T, npd), jnp.asarray(U, npd), r, K,
                                             JLaplacian.NORMALIZED, True, kernel=JKernel(kernel),
                                             epsilon_sq4=jnp.asarray(eps4, npd), chunk=128)
    assert got.vectors.shape == (413, K) and got.vectors.dtype == tdt
    vtol, etol = (1e-10, 1e-7) if dtype == "f64" else (1e-5, 5e-3)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=vtol)
    _up_to_sign(got.vectors.numpy(), np.asarray(ref.vectors), etol)


def test_float32_spectrum_at_r_equal_s_is_each_package_s_float64_one():
    """P2: at r = s = 24 every point's LAE problem spans all the anchors.
    Each package's float32 chunked spectrum (the port's fused K6 → K7 →
    eigh → K8 tail, plain versions here; the reference's float32
    composition) against that package's float64 one: the eigenvalues
    within 1e-5 each, the float32 tolerance of
    ``test_spectrum_matches_reference``."""
    X, U = _data(n=413, s=24, seed=5)
    r, K = 24, 10
    port = {dt: col.heat_kernel_spectrum_colmajor(T(X, dt).T, T(U, dt), r, K,
                                                  LaplacianType.NORMALIZED, True, KernelType.LAE,
                                                  chunk=128).values.double().numpy()
            for dt in (torch.float32, torch.float64)}
    ref = {npd: np.asarray(jcol.heat_kernel_spectrum_colmajor(
        jnp.asarray(X.T, npd), jnp.asarray(U, npd), r, K, JLaplacian.NORMALIZED, True,
        kernel=JKernel.LAE, chunk=128).values, dtype=np.float64)
        for npd in (np.float32, np.float64)}
    assert port[torch.float32].shape == ref[np.float32].shape == (K,)
    np.testing.assert_allclose(port[torch.float32], port[torch.float64], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref[np.float32], ref[np.float64], rtol=0, atol=1e-5)


def test_spectrum_cluster_normalized_matches_reference_f64():
    X, U = _data(n=300, s=16, seed=7)
    counts = np.random.default_rng(8).integers(1, 40, size=(16,)).astype(np.float64)
    got = col.heat_kernel_spectrum_colmajor(T(X).T, T(U), 3, 8, LaplacianType.CLUSTER_NORMALIZED,
                                            False, cluster_sizes=T(counts), chunk=128)
    ref = jcol.heat_kernel_spectrum_colmajor(jnp.asarray(X.T), jnp.asarray(U), 3, 8,
                                             JLaplacian.CLUSTER_NORMALIZED, False,
                                             cluster_sizes=jnp.asarray(counts), chunk=128)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=1e-10)
    _up_to_sign(got.vectors.numpy(), np.asarray(ref.vectors), 1e-7)


def test_fused_chunked_tail_matches_point_major_tail_f32(rng):
    """The chunked fused tail (K6–K8) against the point-major one (K3–K5)
    on the same graph: what chip_smoke.py checks with the kernels."""
    X, U = _data(n=600, s=40, seed=9)
    n, s, K = X.shape[0], U.shape[0], 12
    Xt, U32 = T(X, torch.float32).T, T(U, torch.float32)
    idx, w = col.build_graph_colmajor(Xt, U32, 3, chunk=256)
    counts = col.cluster_sizes_colmajor(Xt, U32, chunk=256)
    got = col.spectrum_fused_colmajor(idx, w, s, K, LaplacianType.CLUSTER_NORMALIZED, True, n,
                                      counts)
    ref = spectrum_fused(col.point_major(w, n).contiguous(), col.point_major(idx, n).contiguous(),
                         s, K, LaplacianType.CLUSTER_NORMALIZED, True, counts)
    np.testing.assert_allclose(got.values.numpy(), ref.values.numpy(), rtol=1e-5, atol=0)
    _up_to_sign(got.vectors.numpy(), ref.vectors.numpy(), 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_normalized_without_sizes_raises(dtype):
    """Fault F1 of the reference (``cluster_sizes=None`` silently becomes
    ones): the port raises on the fused and on the composed branch."""
    X, U = _data(n=200, s=16)
    with pytest.raises(ValueError, match="cluster sizes"):
        col.heat_kernel_spectrum_colmajor(T(X, dtype).T, T(U, dtype), 3, 4,
                                          LaplacianType.CLUSTER_NORMALIZED, chunk=128)


# ---------------------------------------------------------------------------
# anchors and cluster sizes
# ---------------------------------------------------------------------------


def test_kmeans_anchors_find_blobs():
    rng = np.random.default_rng(0)
    blobs = np.array([[4.0, 0, 0], [-4, 0, 0], [0, 4, 0], [0, -4, 0]])
    X = np.concatenate([b + 0.2 * rng.normal(size=(500, 3)) for b in blobs])
    rng.shuffle(X)
    centers = col.kmeans_anchors_colmajor(torch.Generator().manual_seed(0), T(X).T, 4,
                                          n_sample=1024)
    assert centers.shape == (4, 3)
    np.testing.assert_allclose(np.sort(centers.numpy(), axis=0), np.sort(blobs, axis=0),
                               atol=0.15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_sizes_equal_bincount_of_1nn(dtype):
    X, U = _data(n=517, s=32, seed=3)
    lab = np.argmin(((X[:, None, :] - U[None]) ** 2).sum(-1), axis=1)
    got = col.cluster_sizes_colmajor(T(X, dtype).T, T(U, dtype), chunk=128)   # ragged last chunk
    np.testing.assert_array_equal(got.numpy(), np.bincount(lab, minlength=32))
    ref = jcol.cluster_sizes_colmajor(jnp.asarray(X.T), jnp.asarray(U), chunk=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
