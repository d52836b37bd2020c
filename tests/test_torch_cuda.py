"""The CUDA kernels K1–K5 against their plain versions, on the card.

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
    assert all(v > 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES
    assert np.all(np.isfinite(res.posterior_mean))
