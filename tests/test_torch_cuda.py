"""The CUDA kernels K1–K8 against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a kernel written
in CUDA has no interpret mode).  On a machine with an H100 and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

This file imports no JAX, so it runs without the reference package.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    from flgp_tpu_torch.config import pin_full_precision

    pin_full_precision()
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _cuda(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev).contiguous()


@pytest.mark.parametrize("r", [1, 3, 8, 16])
@pytest.mark.parametrize("d", [2, 5])
def test_knn_kernel_matches_plain(dev, gen, r, d):
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    X = _cuda(gen.normal(size=(3000, d)), dev)
    Unp = gen.normal(size=(700, d))
    Unp[9] = Unp[4]                                   # an exact tie: index 4 must win
    U = _cuda(Unp, dev)
    before = hk.LAUNCHES["knn"]
    got = hk.knn(X, U, r)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["knn"] == before + 1
    ref = knn_plain(X, U, r)
    differ = torch.any(got.indices != ref.indices, dim=1)
    assert int(differ.sum()) <= 1                     # near-ties only
    torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=1e-5)
    rows = got.indices.cpu().numpy()
    assert not any(9 in row and 4 not in row for row in rows)


@pytest.mark.parametrize("r", [2, 3, 6])
def test_lae_kernel_matches_plain(dev, gen, r):
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    X = _cuda(gen.normal(size=(5000, 3)), dev)
    U = _cuda(gen.normal(size=(200, 3)), dev)
    idx = knn_plain(X, U, r).indices
    got = hk.lae_weights(X, U, idx)
    torch.cuda.synchronize()
    ref = lae_weights_plain(X, U, idx)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-4)
    assert float(torch.max(torch.abs(got.sum(1) - 1))) <= 1e-5 and float(got.min()) >= 0


@pytest.mark.parametrize("r", [1, 3, 5])
def test_ell_kernels_match_plain(dev, gen, r):
    from flgp_tpu_torch.ops import hopper_kernels as hk

    n, s, K = 4000, 64, 40
    vals = _cuda(gen.uniform(0.1, 1.0, size=(n, r)), dev)
    idx = _cuda(gen.integers(0, s, size=(n, r)), dev, torch.int32)    # with duplicates
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    W = _cuda(gen.normal(size=(s, K)), dev)
    C = hk.ell_colsum(vals, idx, s)
    G, D = hk.ell_norm_gram(vals, idx, cs)
    out = hk.ell_norm_matmat(vals, idx, cs, W)
    torch.cuda.synchronize()
    torch.testing.assert_close(C, hk.ell_colsum_plain(vals, idx, s), rtol=1e-5, atol=0)
    Gp, Dp = hk.ell_norm_gram_plain(vals, idx, cs)
    assert float(torch.max(torch.abs(G - Gp))) <= 1e-5 * float(torch.max(torch.abs(Gp)))
    assert float(torch.max(torch.abs(D - Dp))) <= 1e-5 * float(torch.max(torch.abs(Dp)))
    torch.testing.assert_close(out, hk.ell_norm_matmat_plain(vals, idx, cs, W), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev, gen):
    from flgp_tpu_torch.ops import hopper_kernels as hk

    X = _cuda(gen.normal(size=(50, 2)), dev)
    U = _cuda(gen.normal(size=(20, 2)), dev)
    with pytest.raises(TypeError):
        hk.knn(X.double(), U.double(), 3)             # float64 never reaches a kernel
    with pytest.raises(ValueError):
        hk.knn(X, U, 17)                              # r above the instantiated 16
    with pytest.raises(ValueError):
        hk.knn(X.T.contiguous().T, U, 3)              # not contiguous
    with pytest.raises(ValueError):
        hk.knn(X, U.cpu(), 3)                         # mixed devices
    vals = _cuda(gen.uniform(size=(50, 3)), dev)
    with pytest.raises(TypeError):
        hk.ell_colsum(vals, _cuda(np.zeros((50, 3)), dev, torch.int64), 20)


def test_fit_launches_every_kernel(dev):
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.ops import hopper_kernels as hk

    tor = torus_rings(n=2400, m_train=100, seed=1234)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=240, r=3, K=60), n_gibbs=10, gibbs_avg_sweeps=5,
                       dtype=torch.float32, solve_dtype=torch.float64)
    hk.reset_launches()
    res = ft.fit_lae_logit_gp(torch.Generator(device=dev).manual_seed(0), tor.x_train,
                              tor.y_train, tor.x_test, cfg=cfg)
    main_path = ("knn", "lae_weights", "ell_colsum", "ell_norm_gram", "ell_norm_matmat")
    assert all(hk.LAUNCHES[k] > 0 for k in main_path), hk.LAUNCHES
    assert np.all(np.isfinite(res.posterior_mean))


def _chunked_graph(gen, dev, nch, r, c, s, n_pad):
    vals = gen.uniform(0.1, 1.0, size=(nch, r, c))
    vals[-1, :, c - n_pad:] = 0.0                       # zero-weight pad tail
    idx = gen.integers(0, s, size=(nch, r, c))        # with duplicates
    return _cuda(vals, dev), _cuda(idx, dev, torch.int32)


@pytest.mark.parametrize("r,s", [(1, 64), (3, 64), (5, 64), (3, 13000)])
def test_ell_t_kernels_match_plain(dev, gen, r, s):
    """K6–K8 on a chunked graph whose c is not a power of two; s = 13000
    takes K6's global-atomic branch (its shared histogram holds 12288)."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    nch, c, K = 4, 1000, 40
    vals, idx = _chunked_graph(gen, dev, nch, r, c, s, n_pad=333)
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    W = _cuda(gen.normal(size=(s, K)), dev)
    before = dict(hk.LAUNCHES)
    C = hk.ell_colsum_t(vals, idx, s)
    G, D = hk.ell_norm_gram_t(vals, idx, cs)
    out = hk.ell_norm_matmat_t(vals, idx, cs, W)
    torch.cuda.synchronize()
    for name in ("ell_colsum_t", "ell_norm_gram_t", "ell_norm_matmat_t"):
        assert hk.LAUNCHES[name] == before[name] + 1
    torch.testing.assert_close(C, hk.ell_colsum_t_plain(vals, idx, s), rtol=1e-5, atol=0)
    Gp, Dp = hk.ell_norm_gram_t_plain(vals, idx, cs)
    assert float(torch.max(torch.abs(G - Gp))) <= 1e-5 * float(torch.max(torch.abs(Gp)))
    assert float(torch.max(torch.abs(D - Dp))) <= 1e-5 * float(torch.max(torch.abs(Dp)))
    assert out.shape == (nch * c, K)
    torch.testing.assert_close(out, hk.ell_norm_matmat_t_plain(vals, idx, cs, W), rtol=1e-5,
                               atol=1e-5)
    assert float(torch.max(torch.abs(out[-333:]))) == 0.0            # pad rows


def test_ell_t_wrappers_reject_what_the_kernels_do_not_take(dev, gen):
    from flgp_tpu_torch.ops import hopper_kernels as hk

    vals, idx = _chunked_graph(gen, dev, 2, 3, 100, 20, n_pad=10)
    cs = _cuda(np.ones(20), dev)
    W = _cuda(np.ones((20, 8)), dev)
    with pytest.raises(TypeError):
        hk.ell_colsum_t(vals.double(), idx, 20)                 # float64 values
    with pytest.raises(TypeError):
        hk.ell_norm_gram_t(vals, idx.long(), cs)                # int64 indices
    with pytest.raises(ValueError):
        hk.ell_norm_gram_t(vals[0], idx[0], cs)                 # (r, c), not (nch, r, c)
    with pytest.raises(ValueError):
        hk.ell_norm_matmat_t(vals, idx[:, :2], cs, W)           # shapes disagree
    with pytest.raises(ValueError):
        hk.ell_norm_matmat_t(vals.transpose(1, 2).contiguous().transpose(1, 2), idx, cs, W)
    with pytest.raises(ValueError):
        hk.ell_norm_matmat_t(vals, idx, cs, W.T.contiguous().T)  # W not contiguous
    with pytest.raises(ValueError):
        hk.ell_colsum_t(vals, idx.cpu(), 20)                     # mixed devices


def test_colmajor_fit_launches_every_kernel_of_its_path(dev):
    """A small huge-n-path fit (chunked graph, fused K6–K8 tail, low-rank
    predict tail) launches K1, K2, K6, K7 and K8."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc
    from flgp_tpu_torch.fit.streaming import _gpc_lowrank_tail
    from flgp_tpu_torch.ops import colmajor as col
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.types import EigenPair

    n, m, s, K = 4800, 100, 600, 100
    tor = torus_rings(n=n, m_train=m, seed=1234)
    Xt = torch.as_tensor(np.concatenate([tor.x_train, tor.x_test]).T, dtype=torch.float32,
                         device=dev).contiguous()
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=s, r=3, K=K), n_gibbs=10, gibbs_avg_sweeps=5,
                       dtype=torch.float32, solve_dtype=torch.float64)
    g = cfg.graph
    gen = torch.Generator(device=dev).manual_seed(0)
    hk.reset_launches()
    U = col.kmeans_anchors_colmajor(gen, Xt, s, n_sample=n)
    counts = col.cluster_sizes_colmajor(Xt, U, chunk=1024)
    eig = col.heat_kernel_spectrum_colmajor(Xt, U, g.r, K, g.gl, g.root, cluster_sizes=counts,
                                            chunk=1024)
    Y = torch.as_tensor(tor.y_train, dtype=torch.float32, device=dev)
    N = torch.ones(m, dtype=torch.float32, device=dev)
    scfg, eig_m, (Ys, Ns) = _solve_cast(cfg, EigenPair(eig.values, eig.vectors[:m]), Y, N)
    res = _train_gpc(eig_m, Ys, Ns, slice(0, m), K, scfg)
    labels, probs, mean, var = _gpc_lowrank_tail(gen, eig, Ys, Ns, torch.arange(m, device=dev), K,
                                                 scfg, res.x, 1, chunk=1024)
    torch.cuda.synchronize()
    for name in ("knn", "lae_weights", "ell_colsum_t", "ell_norm_gram_t", "ell_norm_matmat_t"):
        assert hk.LAUNCHES[name] > 0, hk.LAUNCHES
    assert eig.vectors.shape == (n, K) and labels.shape == (n,)
    assert bool(torch.all(torch.isfinite(mean))) and bool(torch.all(var > 0))
    assert float(torch.mean((labels[m:].cpu() != torch.as_tensor(tor.y_test)).double())) <= 0.03
