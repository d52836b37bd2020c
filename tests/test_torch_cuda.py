"""The CUDA kernels K1–K9 and ``ell_sym_matmat`` against their plain versions,
on the card.

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


@pytest.mark.parametrize("r", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 17])
@pytest.mark.parametrize("n,s", [(300_000, 700), (3000, 700)], ids=["grid-filling", "anchor-split"])
def test_knn_kernel_every_width_and_split(dev, gen, n, s, d, r):
    """Both template widths (d = 2, 3) and the run-time one, both numbers of
    rows a thread (r ≤ 8, r > 8), at a shape whose rows fill the card (no
    anchor split) and at one that takes the anchor-split path; then every
    split forced.  The list does not depend on the split, bit for bit; at
    d = 2 no row differs from the plain version."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    X = _cuda(gen.normal(size=(n, d)), dev)
    Unp = gen.normal(size=(s, d))
    Unp[9] = Unp[4]                                   # an exact tie: index 4 before index 9
    Unp[10] = Unp[4]                                  # a lane's own tie when the split is 2
    U = _cuda(Unp, dev)
    got = hk.knn(X, U, r)
    torch.cuda.synchronize()
    ref = knn_plain(X, U, r)
    differ = torch.any(got.indices != ref.indices, dim=1)
    assert int(differ.sum()) <= (0 if d <= 2 else max(1, n // 10_000))     # near-ties only
    torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=2e-5)
    for split in (1, 2, 4, 8, 16, 32):
        forced = hk._knn(X, U, r, split)
        assert torch.equal(forced.indices, got.indices), split
        assert torch.equal(forced.sqdists, got.sqdists), split
    rows = got.indices[:3000].cpu().tolist()
    for row in rows:
        where = [row.index(j) for j in (4, 9, 10) if j in row]
        assert where == sorted(where)
        assert 4 in row or not (9 in row or 10 in row)
    with pytest.raises(RuntimeError, match="cudaError"):
        hk._knn(X, U, r, 3)                           # not a power of two


def _near_ties_only(got, ref, X, U, share):
    """The rows where two kNN lists differ: at most ``share`` of them, each
    a near-tie (the sorted d² within 1e-5·(|x|² + max|u|²))."""
    differ = torch.any(got.indices != ref.indices, dim=1)
    x2 = torch.sum(X.double() ** 2, dim=1)[differ]
    gap = torch.abs(got.sqdists[differ].double() - ref.sqdists[differ].double())
    bound = 1e-5 * (x2 + float(torch.max(torch.sum(U.double() ** 2, dim=1))))
    assert int(differ.sum()) <= max(1, int(share * X.shape[0]))
    assert not bool(torch.any(gap > bound[:, None]))


@pytest.mark.parametrize("r", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("d", [1, 4, 5, 16, 17, 33, 64, 256, 784])
def test_knn_tiled_body_is_the_old_body_bit_for_bit(dev, d, r):
    """K1's tiled body (every d but 2 and 3) against the old run-time-d body
    that ``legacy`` forces: the same indices and d² bit for bit, at ragged n
    (3,001 and 70,001), ragged s (601 and 700) and the anchor-split shape
    (n = 3000, s = 700), with exact ties at anchors 4, 9 and 10 (4 first);
    one launch counted a call; and against ``knn_plain``, rows differing on
    near-ties only (at most 1% of them: at d = 784 and r = 16 some 0.1% of
    the rows swap two neighbours whose d² the two roundings order
    otherwise), d² within 1e-5."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    g = torch.Generator(device=dev).manual_seed(100 * d + r)
    for n, s in ((3001, 601), (70_001, 700), (3000, 700)):
        X = torch.randn((n, d), generator=g, device=dev)
        U = torch.randn((s, d), generator=g, device=dev)
        U[9] = U[4]
        U[10] = U[4]
        before = hk.LAUNCHES["knn"]
        got = hk.knn(X, U, r)
        old = hk._knn(X, U, r, 0, legacy=True)
        torch.cuda.synchronize()
        assert hk.LAUNCHES["knn"] == before + 2
        assert torch.equal(got.indices, old.indices), (n, s)
        assert torch.equal(got.sqdists, old.sqdists), (n, s)
        ref = knn_plain(X, U, r)
        _near_ties_only(got, ref, X, U, 1e-2)
        torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=2e-5)
        for row in got.indices[:3000].cpu().tolist():
            where = [row.index(j) for j in (4, 9, 10) if j in row]
            assert where == sorted(where)
            assert 4 in row or not (9 in row or 10 in row)


@pytest.mark.parametrize("r", [8, 12])
def test_knn_kernel_self_neighbours(dev, gen, r):
    """s = n, as the GLGP graph calls it: many anchor tiles, and each point's
    nearest neighbour is itself at d² ≈ 0 (either sign, from the expanded
    form).  Point 9 is an exact twin of point 4: both lists start {4, 9}."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    Xnp = gen.normal(size=(20000, 3))
    Xnp[9] = Xnp[4]
    X = _cuda(Xnp, dev)
    got = hk.knn(X, X, r)
    torch.cuda.synchronize()
    ref = knn_plain(X, X, r)
    differ = torch.any(got.indices != ref.indices, dim=1)
    # near-ties only: 4e8 pairs, and the kernel and the matmul round x·u
    # differently, so a few rows swap two neighbours of equal d² (below)
    assert int(differ.sum()) <= 20
    torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=1e-5)
    me = torch.arange(20000, device=dev, dtype=got.indices.dtype)
    not_self = (got.indices[:, 0] != me).nonzero()[:, 0].tolist()
    assert set(not_self) <= {4, 9}
    assert set(got.indices[9, :2].tolist()) == set(got.indices[4, :2].tolist()) == {4, 9}
    assert float(got.sqdists[:, 0].abs().max()) < 1e-4


@pytest.mark.parametrize("r", [2, 3, 6])
@pytest.mark.parametrize("d", [2, 3])
def test_lae_kernel_matches_plain(dev, gen, r, d):
    """K2's two entries against the plain version: point-major (n, r), and
    feature-major over a chunked index array whose n is not a multiple of c.
    The kernel repeats the plain version's roundings: equal bit for bit, the
    stated gate being 2e-4."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    n, c = 5000, 768
    X = _cuda(gen.normal(size=(n, d)), dev)
    U = _cuda(gen.normal(size=(200, d)), dev)
    idx = knn_plain(X, U, r).indices
    before = hk.LAUNCHES["lae_weights"]
    got = hk.lae_weights(X, U, idx)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["lae_weights"] == before + 1
    ref = lae_weights_plain(X, U, idx)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-4)
    assert float(torch.max(torch.abs(got.sum(1) - 1))) <= 1e-5 and float(got.min()) >= 0
    assert float(torch.max(torch.abs(got - ref))) == 0.0

    nch = -(-n // c)
    padded = torch.zeros((nch * c, r), dtype=torch.int32, device=dev)
    padded[:n] = idx
    idx_t = padded.view(nch, c, r).transpose(1, 2).contiguous()
    got_t = hk.lae_weights_t(X.T.contiguous(), U, idx_t)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["lae_weights"] == before + 2
    flat = got_t.transpose(1, 2).reshape(nch * c, r)
    assert torch.equal(flat[:n], got)
    assert float(torch.max(torch.abs(flat[n:]))) == 0.0              # the pad points
    assert torch.equal(hk.lae_weights_t_plain(X.T.contiguous(), U, idx_t), got_t)


@pytest.mark.parametrize("r", [2, 3, 6])
def test_lae_kernel_fused_variant(dev, gen, r):
    """The fused-multiply-add variant, which no fit launches: on
    well-conditioned data (Gaussian anchors at d = 3, FISTA converged) it
    meets the same 2e-4 gate and its rows lie on the simplex."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    X = _cuda(gen.normal(size=(5000, 3)), dev)
    U = _cuda(gen.normal(size=(200, 3)), dev)
    idx = knn_plain(X, U, r).indices
    got = hk._lae_weights(X, U, idx, 150, fused=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lae_weights_plain(X, U, idx), rtol=0, atol=2e-4)
    assert float(torch.max(torch.abs(got.sum(1) - 1))) <= 1e-5 and float(got.min()) >= 0


@pytest.mark.parametrize("m", list(range(1, 17)))
def test_lae_constant_division_is_the_ieee_quotient(dev, m):
    """The simplex projection divides by the constants 2..r with a
    multiplication by the rounded reciprocal and one residual correction;
    the kernel source carries a sweep over every float x = 0 or
    2^-60 <= |x| <= 2^60 that counts where this is not x / m."""
    from flgp_tpu_torch.ops import _build

    bad = torch.zeros((1,), dtype=torch.int64, device=dev)
    err = _build.load().flgp_lae_div_check(m, bad.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and int(bad) == 0


def test_lae_wrappers_reject_what_the_kernel_does_not_take(dev, gen):
    from flgp_tpu_torch.ops import hopper_kernels as hk

    Xt = _cuda(gen.normal(size=(2, 300)), dev)
    U = _cuda(gen.normal(size=(20, 2)), dev)
    idx_t = _cuda(gen.integers(0, 20, size=(3, 3, 128)), dev, torch.int32)
    with pytest.raises(ValueError):
        hk.lae_weights_t(Xt, U, idx_t[:2])                      # 256 slots for 300 points
    with pytest.raises(ValueError):
        hk.lae_weights_t(Xt, U, idx_t[0])                       # (r, c), not (nch, r, c)
    with pytest.raises(TypeError):
        hk.lae_weights_t(Xt, U, idx_t.long())
    with pytest.raises(ValueError):
        hk.lae_weights_t(Xt.T.contiguous().T, U, idx_t)         # a point-major cloud's view
    with pytest.raises(ValueError):
        hk.lae_weights_t(Xt, _cuda(gen.normal(size=(20, 3)), dev), idx_t)   # anchors of another d
    with pytest.raises(ValueError):
        hk.lae_weights(Xt.T.contiguous(), U, idx_t[0, :, :3].contiguous())  # 3 rows for 300 points


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


def _point_major_graph(gen, dev, n, r, s):
    """An (n, r) graph with duplicates, a repeated anchor in every third row
    and an out-of-range index at [0, 0]; also the plain versions' inputs,
    where that entry is a zero weight on anchor 0 (it adds nothing)."""
    vals = gen.uniform(0.1, 1.0, size=(n, r))
    idx = gen.integers(0, s, size=(n, r))
    if r > 1:
        idx[::3, 1] = idx[::3, 0]
    idx[0, 0] = s
    v, i = _cuda(vals, dev), _cuda(idx, dev, torch.int32)
    v0, i0 = v.clone(), i.clone()
    v0[0, 0], i0[0, 0] = 0.0, 0
    return v, i, v0, i0


def _chunked(a, c):
    """The (nch, r, c) layout of an (n, r) array, zero pads past n."""
    n, r = a.shape
    nch = -(-n // c)
    out = a.new_zeros((nch * c, r))
    out[:n] = a
    return out.view(nch, c, r).transpose(1, 2).contiguous()


@pytest.mark.parametrize("s", [64, 13000])
@pytest.mark.parametrize("r", [1, 3, 5, 9, 16])
def test_ell_colsum_is_exact(dev, gen, r, s):
    """K3 (and K6, on the chunked layout of the same graph) sum in fixed
    point: C equals ``_colsum_fixed_plain`` bit for bit, whatever the layout,
    the launch or s (s = 13000 keeps the histogram out of shared memory and
    every term goes to the float64 cells), and lies within 1e-5·max|C| of the
    float64 plain version.  A few negative terms and one of 200 (beyond the
    fixed-point range) ride along; an out-of-range index adds nothing."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    v, i, v0, i0 = _point_major_graph(gen, dev, 4000, r, s)
    v[1::97, -1] *= -1.0
    v0[1::97, -1] *= -1.0
    v[2, 0] = v0[2, 0] = 200.0
    before = dict(hk.LAUNCHES)
    C = hk.ell_colsum(v, i, s)
    C_t = hk.ell_colsum_t(_chunked(v, 768), _chunked(i, 768), s)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_colsum"] == before["ell_colsum"] + 1
    assert hk.LAUNCHES["ell_colsum_t"] == before["ell_colsum_t"] + 1
    assert torch.equal(C, hk._colsum_fixed_plain(v, i, s))
    assert torch.equal(C_t, C)
    assert torch.equal(hk.ell_colsum(v, i, s), C)
    ref = hk.ell_colsum_plain(v0.double(), i0, s)
    assert float(torch.max(torch.abs(C - ref))) <= 1e-5 * float(torch.max(torch.abs(ref)))


@pytest.mark.parametrize("table_slots", [0, 2, 64, 16384])
@pytest.mark.parametrize("s", [64, 13000])
@pytest.mark.parametrize("r", [1, 3, 5, 9, 16])
def test_ell_norm_gram_is_exact(dev, gen, r, s, table_slots):
    """K4 through K7's body with c = 1: within 1e-5·max of the float64 plain
    version; repeated anchors (their product on the diagonal twice) and an
    out-of-range index; r = 9, 16 take the rolled instances; s = 13000 keeps
    D out of shared memory.  Every sum is exact, so Ĝ and D are the same
    bits on a second launch, with any table size, and on K7 over the chunked
    layout of the same graph; the counts add up to the r(r+1)/2 pairs of
    every point with a weight."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    n = 4000
    v, i, v0, i0 = _point_major_graph(gen, dev, n, r, s)
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    before = hk.LAUNCHES["ell_norm_gram"]
    G, D, stats = hk._ell_norm_gram(v, i, cs, EPS, table_slots)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_norm_gram"] == before + 1
    Gp, Dp = hk.ell_norm_gram_plain(v0.double(), i0, cs.double(), EPS)
    assert float(torch.max(torch.abs(G - Gp))) <= 1e-5 * float(torch.max(torch.abs(Gp)))
    assert float(torch.max(torch.abs(D - Dp))) <= 1e-5 * float(torch.max(torch.abs(Dp)))
    kept, spilled = (int(x) for x in stats)
    assert kept + spilled == n * r * (r + 1) // 2 - r
    if table_slots == 2:
        assert spilled > 0.9 * (kept + spilled)
    if table_slots in (0, 16384) and s == 64:
        assert spilled == 0
    G2, D2 = hk.ell_norm_gram(v, i, cs)
    assert torch.equal(G, G2) and torch.equal(D, D2)
    G3, D3 = hk.ell_norm_gram_t(_chunked(v, 768), _chunked(i, 768), cs)
    assert torch.equal(G, G3) and torch.equal(D, D3)
    with pytest.raises(RuntimeError, match="cudaError"):
        hk._ell_norm_gram(v, i, cs, EPS, 48)            # not a power of two


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


@pytest.mark.parametrize("table_slots", [0, 2, 64, 16384])
@pytest.mark.parametrize("r,s", [(2, 64), (4, 64), (4, 13000), (9, 64)])
def test_ell_norm_gram_t_table_and_repeated_anchors(dev, gen, r, s, table_slots):
    """K7's shared-memory table: the default, forced so small that most pair
    additions find no slot and go to the global cells, and in between; rows
    that name one anchor twice (their product belongs on the diagonal
    twice); s = 13000 keeps D out of shared memory; r = 9 takes the
    instances whose pair loops stay rolled.  The result does not
    depend on the table; the counts add up to the r(r+1)/2 pairs of every
    point with a weight."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    nch, c, n_pad = 5, 1000, 333
    vals, idx = _chunked_graph(gen, dev, nch, r, c, s, n_pad)
    idx[:, 1, ::3] = idx[:, 0, ::3]                     # a repeated anchor in every third row
    idx[0, 0, 5] = s                                    # out of range: the entry adds nothing
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    G, D, stats = hk._ell_norm_gram_t(vals, idx, cs, EPS, table_slots)
    torch.cuda.synchronize()
    v0, i0 = vals.clone(), idx.clone()
    v0[0, 0, 5], i0[0, 0, 5] = 0.0, 0
    Gp, Dp = hk.ell_norm_gram_t_plain(v0.double(), i0, cs.double(), EPS)
    assert float(torch.max(torch.abs(G - Gp))) <= 1e-5 * float(torch.max(torch.abs(Gp)))
    assert float(torch.max(torch.abs(D - Dp))) <= 1e-5 * float(torch.max(torch.abs(Dp)))
    kept, spilled = (int(x) for x in stats)
    assert kept + spilled == (nch * c - n_pad) * r * (r + 1) // 2 - r
    if table_slots == 2:
        assert spilled > 0.9 * (kept + spilled)
    if table_slots in (0, 16384) and s == 64:
        assert spilled == 0
        # sums kept in shared memory are fixed point, the flush adds multiples
        # of 2^-24 in float64: exact, so a second launch gives the same bits
        G2, D2, _ = hk._ell_norm_gram_t(vals, idx, cs, EPS, table_slots)
        assert torch.equal(G, G2) and torch.equal(D, D2)
    with pytest.raises(RuntimeError, match="cudaError"):
        hk._ell_norm_gram_t(vals, idx, cs, EPS, 48)     # not a power of two


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


@pytest.mark.parametrize("n,s,r,K", [(3001, 3001, 48, 300), (777, 50, 1, 7), (4097, 129, 8, 384),
                                     (1000, 1000, 3, 130), (64, 5000, 16, 4)])
def test_ell_matmat_kernel_matches_plain(dev, gen, n, s, r, K):
    """K9 at odd shapes: s = n with the GLGP fan-in r = 48, K not a multiple
    of 4 (the scalar kernel) and of 4 (the 16-byte one), duplicate indices in
    a row, an out-of-range index (contributes nothing) and zero weights (kept:
    0·W is 0 unless W is not finite)."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.types import EllMatrix

    vals = gen.uniform(-1.0, 1.0, size=(n, r))
    vals[::7, 0] = 0.0
    idx = gen.integers(0, s, size=(n, r))
    if r > 1:
        idx[::3, 1] = idx[::3, 0]
    W = _cuda(gen.normal(size=(s, K)), dev)
    v, i = _cuda(vals, dev), _cuda(idx, dev, torch.int32)
    before = hk.LAUNCHES["ell_matmat"]
    got = hk.ell_matmat(v, i, W)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_matmat"] == before + 1
    ref = hk.ell_matmat_plain(v, i, W)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # EllMatrix.matmat routes float32 CUDA tensors through the kernel, float64 not
    assert torch.equal(EllMatrix(v, i, s).matmat(W), got)
    assert hk.LAUNCHES["ell_matmat"] == before + 2
    EllMatrix(v.double(), i, s).matmat(W.double())
    assert hk.LAUNCHES["ell_matmat"] == before + 2
    # an index outside [0, s) adds nothing
    i_bad = i.clone()
    i_bad[0, 0] = s
    v0 = v.clone()
    v0[0, 0] = 0.0
    torch.testing.assert_close(hk.ell_matmat(v, i_bad, W), hk.ell_matmat_plain(v0, i, W),
                               rtol=1e-5, atol=1e-5)
    # an unaligned W (a view one float into a buffer) takes the scalar kernel
    buf = torch.empty(s * K + 1, dtype=torch.float32, device=dev)
    W_off = buf[1:].view(s, K).copy_(W)
    torch.testing.assert_close(hk.ell_matmat(v, i, W_off), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slab_cols", [0, 4, 24, 64, 100, 1000])
@pytest.mark.parametrize("n,s,r,K", [(3001, 3001, 48, 300), (4097, 129, 8, 384), (1000, 1000, 3, 130),
                                     (2000, 300_000, 5, 40)])
def test_ell_matmat_kernel_slabs(dev, gen, n, s, r, K, slab_cols):
    """K9's two bodies: the row kernel (slab_cols = 0 with W small) and the
    slab kernel with forced slab widths, narrower than a lane group, ragged
    against K, wider than K; s·K·4 above 32 MB takes slabs unforced.  Vector
    (K % 4 == 0) and scalar (K = 130, and an unaligned W) paths.  All give
    the same fmaf chain: equal bit for bit, and within 1e-5 of the plain
    version."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    vals = gen.uniform(-1.0, 1.0, size=(n, r))
    idx = gen.integers(0, s, size=(n, r))
    idx[::3, 1] = idx[::3, 0]
    idx[0, 0] = s                                      # out of range: adds nothing
    W = _cuda(gen.normal(size=(s, K)), dev)
    v, i = _cuda(vals, dev), _cuda(idx, dev, torch.int32)
    got = hk._ell_matmat(v, i, W, slab_cols)
    torch.cuda.synchronize()
    v0, i0 = v.clone(), i.clone()
    v0[0, 0], i0[0, 0] = 0.0, 0
    torch.testing.assert_close(got, hk.ell_matmat_plain(v0, i0, W), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, hk.ell_matmat(v, i, W))
    buf = torch.empty(s * K + 1, dtype=torch.float32, device=dev)
    W_off = buf[1:].view(s, K).copy_(W)               # unaligned: the scalar path
    assert torch.equal(hk._ell_matmat(v, i, W_off, slab_cols), got)


@pytest.mark.parametrize("slab_cols", [0, 8, 64, 1000])
@pytest.mark.parametrize("n,r,K", [(3001, 48, 300), (5000, 8, 384), (1000, 3, 130), (90_000, 4, 96)])
def test_ell_sym_matmat_kernel_matches_plain(dev, gen, n, r, K, slab_cols):
    """The symmetric product against its plain version: r = 48 > 32 (two
    rounds of a 32-lane group), a hub whose in-degree is n (many rounds),
    rows with in-degree 0, a duplicate edge, an out-of-range index, scalar
    and vector paths, forced slabs and (n = 90,000, K = 96: 34.6 MB) unforced
    ones.  The slab width does not change a bit of the result."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.sparse_graph import SymCoo
    from flgp_tpu_torch.types import EllMatrix

    idx = gen.integers(0, n, size=(n, r))
    idx[(idx >= 100) & (idx < 200)] = 7                # rows 100..199 have no in-edge
    idx[:, 0] = 7                                      # a hub
    idx[5, 1] = idx[5, 2]
    idx[0, 1] = n                                      # out of range: in neither half
    vals = gen.uniform(-1.0, 1.0, size=(n, r))
    v, i = _cuda(vals, dev), _cuda(idx, dev, torch.int32)
    X = _cuda(gen.normal(size=(n, K)), dev)
    tr = EllMatrix(v, i, n).transpose_structure()
    assert int(tr.ptr[200] - tr.ptr[100]) == 0 and int(tr.ptr[-1]) == n * r - 1
    vt = v.reshape(-1)[tr.perm]
    before = hk.LAUNCHES["ell_sym_matmat"]
    got = hk._ell_sym_matmat(v, i, tr.ptr, tr.src, vt, X, slab_cols)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_sym_matmat"] == before + 1
    v0, i0 = v.clone(), i.clone()
    v0[0, 1], i0[0, 1] = 0.0, 0
    tr0 = EllMatrix(v0, i0, n).transpose_structure()
    ref = hk.ell_sym_matmat_plain(v0, i0, tr0.ptr, tr0.src, v0.reshape(-1)[tr0.perm], X)
    # the hub's row sums n + r terms of either sign: 1e-5 of the sum's scale
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * max(1.0, scale)
    assert torch.equal(got, hk.ell_sym_matmat(v, i, tr.ptr, tr.src, vt, X))
    # the operator takes the kernel for float32 CUDA tensors, once per product,
    # on its folded arrays: the hub's own edges 7 → j are mutual with j → 7
    op = SymCoo(i0, v0, n)
    torch.testing.assert_close(op.matvec(X), ref, rtol=1e-5, atol=1e-5 * max(1.0, scale))
    assert hk.LAUNCHES["ell_sym_matmat"] == before + 3
    assert r <= int(op.structure.mutual.sum()) == n * r - int(op.structure.transpose.ptr[-1])
    op.matvec(X[:, 0].contiguous())
    assert hk.LAUNCHES["ell_sym_matmat"] == before + 4
    SymCoo(i0, v0.double(), n).matvec(X.double())
    assert hk.LAUNCHES["ell_sym_matmat"] == before + 4


def test_ell_sym_matmat_wrapper_rejects_what_the_kernel_does_not_take(dev, gen):
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.types import EllMatrix

    n, r = 50, 3
    v = _cuda(gen.uniform(size=(n, r)), dev)
    i = _cuda(gen.integers(0, n, size=(n, r)), dev, torch.int32)
    X = _cuda(gen.normal(size=(n, 8)), dev)
    tr = EllMatrix(v, i, n).transpose_structure()
    vt = v.reshape(-1)[tr.perm]
    with pytest.raises(TypeError):
        hk.ell_sym_matmat(v, i, tr.ptr.long(), tr.src, vt, X)
    with pytest.raises(TypeError):
        hk.ell_sym_matmat(v.double(), i, tr.ptr, tr.src, vt.double(), X.double())
    with pytest.raises(ValueError):
        hk.ell_sym_matmat(v, i, tr.ptr[:-1], tr.src, vt, X)
    with pytest.raises(ValueError):
        hk.ell_sym_matmat(v, i, tr.ptr, tr.src, vt, X[:-1])          # X must have n rows
    with pytest.raises(ValueError):
        hk.ell_sym_matmat(v, i, tr.ptr, tr.src, vt, X.T.contiguous().T)
    with pytest.raises(ValueError):
        hk.ell_sym_matmat(v, i, tr.ptr, tr.src.cpu(), vt, X)


def test_ell_matmat_wrapper_rejects_what_the_kernel_does_not_take(dev, gen):
    from flgp_tpu_torch.ops import hopper_kernels as hk

    v = _cuda(gen.uniform(size=(50, 3)), dev)
    i = _cuda(gen.integers(0, 20, size=(50, 3)), dev, torch.int32)
    W = _cuda(gen.normal(size=(20, 8)), dev)
    with pytest.raises(TypeError):
        hk.ell_matmat(v.double(), i, W.double())
    with pytest.raises(TypeError):
        hk.ell_matmat(v, i.long(), W)
    with pytest.raises(ValueError):
        hk.ell_matmat(v, i[:, :2], W)
    with pytest.raises(ValueError):
        hk.ell_matmat(v, i, W.T.contiguous().T)
    with pytest.raises(ValueError):
        hk.ell_matmat(v, i, W.cpu())


def test_sparse_glgp_operator_and_fit_launch_the_kernel(dev, gen):
    """SymCoo.matvec is one ``ell_sym_matmat`` launch; a small sparse-LOBPCG
    GLGP fit through the entry point (on the card by default) launches it
    once per LOBPCG iteration and start, for every bandwidth, and never the
    forward-only K9."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.sparse_graph import glgp_operator, symmetrize_knn

    n, r = 2000, 6
    idx = _cuda(gen.integers(0, n, size=(n, r)), dev, torch.int32)
    vals = _cuda(gen.uniform(0.1, 1.0, size=(n, r)), dev)
    W, _ = glgp_operator(symmetrize_knn(idx, vals, n))
    X = _cuda(gen.normal(size=(n, 24)), dev)
    hk.reset_launches()
    got = W.matvec(X)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_sym_matmat"] == 1 and hk.LAUNCHES["ell_matmat"] == 0
    W64, _ = glgp_operator(symmetrize_knn(idx, vals.double(), n))
    torch.testing.assert_close(got.double(), W64.matvec(X.double()), rtol=1e-4, atol=1e-6)
    assert hk.LAUNCHES["ell_sym_matmat"] == 1

    rng = np.random.default_rng(2)
    y = (rng.uniform(size=1200) < 0.5).astype(np.float64)
    Xb = rng.normal(size=(1200, 2)) * 0.5 + np.where(y[:, None] > 0, 1.5, -1.5)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=64, r=3, K=16), a2s=(0.5, 1.0, 2.0), n_gibbs=10,
                       gibbs_avg_sweeps=5, gl_sparse=True, gl_threshold=0.01, gl_solver="lobpcg",
                       gl_lobpcg_iters=40, dtype=torch.float32, solve_dtype=torch.float64)
    hk.reset_launches()
    res = ft.fit_gl_logit_gp(torch.Generator(device=dev).manual_seed(0), Xb[:100], y[:100],
                             Xb[100:], cfg=cfg)
    assert hk.LAUNCHES["ell_sym_matmat"] == 3 * 41 and hk.LAUNCHES["ell_matmat"] == 0, hk.LAUNCHES
    assert hk.LAUNCHES["knn"] == 1                      # the self-kNN, r = 12
    assert np.isfinite(res.metrics["gl_eigensolve_max_residual"])
    assert np.mean(res.y_test != y[100:]) <= 0.02
    with pytest.raises(ValueError, match="generator"):
        ft.fit_gl_logit_gp(torch.Generator().manual_seed(0), Xb[:100], y[:100], Xb[100:], cfg=cfg)


@pytest.mark.parametrize("name,gl_solver", [
    ("fit_lae_logit_gp", "dense"), ("fit_lae_regression_gp", "dense"),
    ("fit_se_logit_gp", "dense"), ("fit_se_regression_gp", "dense"),
    ("fit_nystrom_logit_gp", "dense"), ("fit_nystrom_regression_gp", "dense"),
    ("fit_gl_logit_gp", "dense"), ("fit_gl_regression_gp", "dense"),
    ("fit_gl_logit_gp", "lobpcg"), ("fit_gl_regression_gp", "lobpcg")])
def test_every_entry_point_fits_on_the_card_by_default(dev, name, gl_solver):
    """No ``device=`` argument: the fit runs on the card (f32 graph stage,
    f64 tail), gives finite outputs of the right shape and a sane accuracy."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import spiral

    rng = np.random.default_rng(2)
    n, m = 1200, 100
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=64, r=3, K=16, nystrom_rcond=1e-3),
                       a2s=(0.5, 1.0, 2.0), n_gibbs=10, gibbs_avg_sweeps=5,
                       gl_sparse=True, gl_threshold=0.01, gl_solver=gl_solver, gl_lobpcg_iters=40,
                       train=ft.TrainConfig(adam_steps=50), dtype=torch.float32,
                       solve_dtype=torch.float64)
    gen_dev = torch.Generator(device=dev).manual_seed(0)
    if name.endswith("logit_gp"):
        y = (rng.uniform(size=n) < 0.5).astype(np.float64)
        X = rng.normal(size=(n, 2)) * 0.5 + np.where(y[:, None] > 0, 1.5, -1.5)
        res = getattr(ft, name)(gen_dev, X[:m], y[:m], X[m:], cfg=cfg)
        assert np.mean(res.y_test != y[m:]) <= 0.02
    else:
        ds = spiral(n=n, m_train=m, noise_sd=0.3, seed=5)
        res = getattr(ft, name)(gen_dev, ds.x_train, ds.y_train, ds.x_test, cfg=cfg)
        assert np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)) < 3.5     # the targets' own sd
    assert res.eigenpair.vectors.device.type == "cuda"
    for arr in (res.y_test, res.posterior_mean, res.posterior_cov):
        assert arr.shape == (n - m,) and np.all(np.isfinite(arr))
    if "_gl_" in name:
        resid = res.metrics["gl_eigensolve_max_residual"]
        assert resid == 0.0 if gl_solver == "dense" else 0.0 < resid < 1.0


@pytest.mark.parametrize("method", ["kmeans", "minibatchkmeans"])
def test_subsample_twice_from_one_seed_is_the_same_bits(dev, method):
    """k-means‖ + Lloyd (and mini-batch k-means) sum every cluster in an order
    fixed by the data: one seed gives one set of centers and counts, bit for
    bit, on the card."""
    from flgp_tpu_torch.ops.kmeans import subsample

    rng = np.random.default_rng(7)
    X = _cuda(rng.normal(size=(200_000, 2)) + 6.0 * rng.integers(0, 4, size=(200_000, 1)), dev)
    subs = [subsample(torch.Generator(device=dev).manual_seed(3), X, 1024, method=method)
            for _ in range(2)]
    assert torch.equal(subs[0].centers, subs[1].centers)
    assert torch.equal(subs[0].counts, subs[1].counts)
    assert float(subs[0].counts.sum()) == 200_000


@pytest.mark.parametrize("name,graph", [
    ("fit_lae_logit_mult_gp", dict(s=30, r=3, K=15)), ("fit_se_logit_mult_gp", dict(s=30, r=3, K=15)),
    ("fit_nystrom_logit_mult_gp", dict(s=30, r=3, K=15)), ("fit_gl_logit_mult_gp", dict(K=20))])
def test_multiclass_entry_point_on_the_card(dev, name, graph):
    """Three blobs, no ``device=`` argument: f32 graph stage, f64 tail, the
    reference tests' gate."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import gaussian_blobs

    data = gaussian_blobs(n_per_class=40, n_classes=3, sep=6.0)
    cfg = ft.FitConfig(graph=ft.GraphConfig(**graph), train=ft.TrainConfig(grid_size=16),
                       dtype=torch.float32, solve_dtype=torch.float64)
    res = getattr(ft, name)(torch.Generator(device=dev).manual_seed(0), data.x_train,
                            data.y_train, data.x_test, cfg=cfg)
    assert res.eigenpair.vectors.device.type == "cuda"
    assert np.mean(res.y_test != data.y_test) < 0.15
    assert res.posterior_mean.shape == res.posterior_cov.shape == (60, 3)
    assert np.all(np.isfinite(res.posterior_mean)) and np.all(np.isfinite(res.pars["t"]))


def test_extras_on_the_card(dev):
    """``heat_kernel_covariance`` on float32 points launches K1–K5;
    ``lae_eigenmap`` gives sorted Laplacian eigenvalues in [0, 2]."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.ops import hopper_kernels as hk

    tor = torus_rings(n=2400, m_train=100, seed=1)
    hk.reset_launches()
    H = ft.heat_kernel_covariance(torch.Generator(device=dev).manual_seed(0),
                                  tor.x_train.astype(np.float32), tor.x_test.astype(np.float32),
                                  1.0, ft.GraphConfig(s=300, r=3, K=60))
    assert H.shape == (2400, 100) and H.is_cuda and bool(torch.all(torch.isfinite(H)))
    assert all(hk.LAUNCHES[k] > 0 for k in ("knn", "lae_weights", "ell_colsum", "ell_norm_gram",
                                             "ell_norm_matmat")), hk.LAUNCHES
    X = np.concatenate([tor.x_train, tor.x_test]).astype(np.float32)
    vals, vecs = ft.lae_eigenmap(torch.Generator(device=dev).manual_seed(0), X, 300, 3, 10)
    assert vecs.shape == (2400, 10) and vecs.is_cuda
    # 1 − σ, σ ≤ 1 up to the float32 rounding of the (s, s) Gram's eigenvalues
    assert bool(torch.all(vals[1:] >= vals[:-1])) and float(vals[0]) >= -1e-4
    assert float(vals[-1]) <= 2.0


# ---------------------------------------------------------------------------
# the posterior-sampling path: whitened model, samplers, checkpointed HMC
# ---------------------------------------------------------------------------


def _whitened_gpc(dev, m=100, K=100, seed=0):
    from flgp_tpu_torch.models.latent import GpcLogPost, WhitenedGP

    rng = np.random.default_rng(seed)
    gp = WhitenedGP(_cuda(rng.normal(size=(m, K)), dev),
                    _cuda(np.sort(rng.uniform(0.0, 1.0, K)), dev), 1e-3)
    Y = _cuda((rng.uniform(size=m) > 0.5).astype(float), dev)
    return GpcLogPost(gp, Y, torch.ones(m, device=dev), 1e-2, 10.0, 2.0)


def test_latent_analytic_gradient_matches_autograd_on_the_card(dev):
    post = _whitened_gpc(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = 0.3 * torch.randn((64, post.dim), generator=g, device=dev)
    x[:, -1] += 2.0
    lp, grad = post.value_and_grad(x)
    xg = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(post(xg).sum(), xg)
    assert torch.equal(post(x), lp)
    assert float(torch.max(torch.abs(grad - auto))) <= 1e-4 * float(torch.max(torch.abs(auto)))


@pytest.mark.parametrize("before", [False, True])
def test_tf32_density_restores_allow_tf32(dev, before):
    from flgp_tpu_torch.models.latent import logpost_with_precision

    post = _whitened_gpc(dev)
    x = 0.3 * torch.randn((256, post.dim), generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    full = post.value_and_grad(x)
    torch.backends.cuda.matmul.allow_tf32 = before
    try:
        fast = logpost_with_precision(post, "tf32").value_and_grad(x)
        assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rel = torch.max(torch.abs(fast[0] - full[0]) / torch.abs(full[0]))
    assert float(rel) <= 1e-2


def test_hmc_gaussian_moments_on_the_card(dev):
    from flgp_tpu_torch.inference.diagnostics import split_rhat
    from flgp_tpu_torch.inference.hmc import run_hmc

    mean = torch.tensor([1.0, -2.0, 0.5], device=dev)
    scales = torch.tensor([1.0, 0.5, 2.0], device=dev)

    def logprob(x):
        return -0.5 * torch.sum(((x - mean) / scales) ** 2, dim=-1)

    run = run_hmc(torch.Generator(device=dev).manual_seed(0), logprob,
                  torch.zeros((16, 3), device=dev), n_warmup=300, n_samples=600, n_leapfrog=8)
    draws = run.samples.reshape(-1, 3).double().cpu().numpy()
    np.testing.assert_allclose(draws.mean(0), mean.cpu().numpy(), atol=0.2)
    np.testing.assert_allclose(draws.std(0), scales.cpu().numpy(), rtol=0.25)
    assert float(run.accept_prob.mean()) > 0.5
    assert bool(torch.all(split_rhat(run.samples) < 1.1))
    with pytest.raises(ValueError, match="generator is on"):
        run_hmc(torch.Generator().manual_seed(0), logprob, torch.zeros((4, 3), device=dev),
                n_warmup=2, n_samples=2)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_nuts_and_chees_on_the_card(dev, sampler):
    from flgp_tpu_torch.inference import chees, nuts

    post = _whitened_gpc(dev, m=60, K=20)
    g = torch.Generator(device=dev).manual_seed(2)
    x0 = 0.1 * torch.randn((32, post.dim), generator=g, device=dev)
    if sampler == "nuts":
        run = nuts.run_nuts(g, post, x0, n_warmup=60, n_samples=20, max_depth=6)
        assert int(run.n_leapfrog.max()) <= 63 and int(run.n_leapfrog.min()) >= 1
    else:
        run = chees.run_chees(g, post, x0, n_warmup=60, n_samples=20)
    assert run.samples.shape == (20, 32, post.dim) and run.samples.device.type == "cuda"
    assert bool(torch.all(torch.isfinite(run.samples)))


def test_checkpointed_hmc_kill_and_resume_bit_for_bit_on_the_card(dev, tmp_path):
    import shutil

    from flgp_tpu_torch.inference.resume import run_hmc_checkpointed

    post = _whitened_gpc(dev, m=60, K=30)
    x0 = 0.1 * torch.randn((8, post.dim), generator=torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    kw = dict(n_warmup=32, n_samples=48, segment=16, n_leapfrog=8)
    full = run_hmc_checkpointed(11, post, x0, str(tmp_path / "full"), **kw)
    again = run_hmc_checkpointed(11, post, x0, str(tmp_path / "again"), **kw)
    for i in range(2):
        for name in (f"seg_{i}", f"phase_{i}"):
            shutil.copytree(tmp_path / "full" / name, tmp_path / "resumed" / name)
    resumed = run_hmc_checkpointed(11, post, x0, str(tmp_path / "resumed"), **kw)
    assert full.samples.device.type == "cuda"
    for a, b, c in zip(full, again, resumed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("mutation", ["hmc", "rwm"])
def test_smc_gaussian_evidence_on_the_card(dev, mutation):
    """The reference's SMC gate (log Z within 0.15 / 0.2, mean within 0.15)
    with the particles, the generator and the ladder on the card."""
    import math

    from flgp_tpu_torch.inference.smc import run_smc

    mu, s2 = torch.tensor([0.5, -0.5], device=dev), 0.25

    def log_prior(x):
        return -0.5 * torch.sum(x * x, dim=-1) - math.log(2 * math.pi)

    def log_like(x):
        return -0.5 * torch.sum((x - mu) ** 2, dim=-1) / s2 - math.log(2 * math.pi * s2)

    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((512, 2), generator=g, device=dev)
    kw = dict(n_mutation_steps=5) if mutation == "hmc" else dict(n_mutation_steps=10,
                                                                 step_size=0.5)
    res = run_smc(g, log_prior, log_like, x0, mutation=mutation, **kw)
    var = 1.0 + s2
    log_z = float(np.sum(-0.5 * np.log(2 * np.pi * var) - 0.5 * np.array([0.5, -0.5]) ** 2 / var))
    assert res.particles.device.type == "cuda"
    assert abs(float(res.log_evidence) - log_z) < (0.15 if mutation == "hmc" else 0.2)
    np.testing.assert_allclose(res.particles.mean(0).cpu().numpy(), [0.4, -0.4], atol=0.15)


def test_report_changes_no_output_bit_on_the_card(dev):
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.utils.metrics import MetricsReport

    tor = torus_rings(n=2400, m_train=100, seed=1234)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=300, r=3, K=60), sigma=1e-3,
                       dtype=torch.float32, solve_dtype=torch.float64)

    def run(report):
        return ft.fit_lae_logit_gp(torch.Generator(device=dev).manual_seed(0), tor.x_train,
                                   tor.y_train, tor.x_test, cfg=cfg, report=report)

    plain = run(None)
    hk.reset_launches()
    report = MetricsReport()
    inst = run(report)
    assert all(hk.LAUNCHES[k] > 0 for k in ("knn", "lae_weights", "ell_colsum", "ell_norm_gram",
                                            "ell_norm_matmat"))
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        assert np.array_equal(getattr(plain, name), getattr(inst, name)), name
    assert np.array_equal(plain.pars["t"], inst.pars["t"]) and plain.obj == inst.obj
    assert [s.name for s in report.stages] == ["spectrum", "train", "predict"]
    assert inst.metrics["spectrum_orth_residual"] < 1e-3 and inst.metrics["newton_iters"] >= 1


def test_metrics_stage_waits_for_the_queued_work(dev):
    """A stage with a CUDA tensor in its ``_sync`` slot covers the work queued
    for it; without the slot the clock stops while the card still runs."""
    from flgp_tpu_torch.utils.metrics import MetricsReport

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    A = torch.randn((4096, 4096), device=dev)
    torch.cuda.synchronize()
    report = MetricsReport()
    for name, sync in (("synced", True), ("unsynced", False)):
        with report.stage(name) as slot:
            start.record()
            B = A
            for _ in range(20):
                B = A @ B
            end.record()
            if sync:
                slot["_sync"] = B
        torch.cuda.synchronize()
        queued_ms = start.elapsed_time(end)
        if sync:
            assert report.stages[-1].wall_s * 1e3 >= 0.95 * queued_ms
        else:
            assert report.stages[-1].wall_s * 1e3 < 0.5 * queued_ms


def test_resumable_grid_resumed_on_the_card_is_the_same_bits(dev, tmp_path):
    import shutil

    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import spiral
    from flgp_tpu_torch.fit.resumable import fit_se_regression_gp_resumable
    from flgp_tpu_torch.ops import hopper_kernels as hk

    ds = spiral(n=1500, m_train=100, seed=3)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=200, r=3, K=40), sigma=1e-5, dtype=torch.float32,
                       solve_dtype=torch.float64, a2s=[0.3, 1.0, 3.0, 10.0],
                       train=ft.TrainConfig(adam_steps=60))

    def run(path):
        return fit_se_regression_gp_resumable(torch.Generator(device=dev).manual_seed(0),
                                              ds.x_train, ds.y_train, ds.x_test,
                                              str(tmp_path / path), cfg)

    hk.reset_launches()
    full = run("full")
    assert hk.LAUNCHES["knn"] > 0 and hk.LAUNCHES["ell_matmat"] > 0
    assert full.eigenpair.vectors.device.type == "cuda"
    for i in range(2):
        shutil.copytree(tmp_path / "full" / f"a2_{i}", tmp_path / "resumed" / f"a2_{i}")
    resumed = run("resumed")
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        assert np.array_equal(getattr(full, name), getattr(resumed, name)), name
    assert all(np.array_equal(full.pars[k], resumed.pars[k]) for k in full.pars)


def test_se_spectrum_is_the_same_bits_every_run_on_the_card(dev):
    """The SE spectrum's column sums add in a fixed order
    (``EllMatrix.colsum_ordered``), where ``index_add_``'s atomics land in
    any order: one graph gives one spectrum, bit for bit, and the ordered
    sums are the float64 sums rounded once (within a float32 ulp of the
    CPU's float64 scatter-add)."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.fit import spectral
    from flgp_tpu_torch.types import EllMatrix

    tor = torus_rings(n=4800, m_train=100, seed=1234)
    X = torch.as_tensor(np.concatenate([tor.x_train, tor.x_test]), dtype=torch.float32,
                        device=dev)
    g = ft.GraphConfig(s=600, r=3, K=100)
    basis = spectral.se_grid_setup(torch.Generator(device=dev).manual_seed(0), X, g)
    first = spectral.se_spectrum_at(basis, 0.5, g)
    for _ in range(3):
        again = spectral.se_spectrum_at(basis, 0.5, g)
        assert torch.equal(again.values, first.values)
        assert torch.equal(again.vectors, first.vectors)
    Z = EllMatrix(basis.knn_res.sqdists, basis.knn_res.indices, 600)
    ref = EllMatrix(Z.values.double().cpu(), Z.indices.cpu(), 600).colsum().float()
    got = Z.colsum_ordered()
    assert torch.equal(got, Z.colsum_ordered())
    torch.testing.assert_close(got.cpu(), ref, rtol=2.0**-23, atol=0)


# ---------------------------------------------------------------------------
# the out-of-core fits and the multi-device layer
# ---------------------------------------------------------------------------


def _torus_file(tmp_path, dev, n=100_000):
    """A torus cloud written as float32 FLGP0001, its rows on the card, and
    k-means anchors with their cluster sizes (s = 256)."""
    from flgp_tpu_torch import native
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.ops.kmeans import kmeans

    ds = torus_rings(n=n, m_train=100, seed=3)
    X = np.concatenate([ds.x_train, ds.x_test]).astype(np.float32)
    path = str(tmp_path / "x.flgp")
    native.write_matrix(path, X)
    X_dev = torch.as_tensor(X, device=dev)
    sub = kmeans(torch.Generator(device=dev).manual_seed(0), X_dev[:20_000], 256)
    return path, X_dev, sub


def test_streamed_spectrum_is_the_in_memory_spectrum_bit_for_bit(dev, tmp_path):
    import flgp_tpu_torch as ft
    from flgp_tpu_torch import native
    from flgp_tpu_torch.fit import streaming
    from flgp_tpu_torch.fit.spectral import build_spectrum
    from flgp_tpu_torch.ops import hopper_kernels as hk

    path, X, sub = _torus_file(tmp_path, dev)
    g = ft.GraphConfig(s=256, r=3, K=64)
    gen = torch.Generator(device=dev)
    mem, _ = build_spectrum(gen, X, g, anchors=sub)
    with native.MatrixFile(path) as mat:
        hk.reset_launches()
        st, _ = streaming.streamed_build_spectrum(gen, mat, g, 1 << 14, anchors=sub)
        torch.cuda.synchronize()
    chunks = -(-X.shape[0] // (1 << 14))
    assert hk.LAUNCHES["knn"] == chunks and hk.LAUNCHES["lae_weights"] == chunks
    assert torch.equal(st.values, mem.values) and torch.equal(st.vectors, mem.vectors)


def test_overlapped_pass_and_chunk_sizes_give_the_serial_pass_s_bits(dev, tmp_path):
    """The overlapped pass against the serial one, and chunks of 65,536 rows
    against chunks of 1,000 (a short tail chunk each): the same graph."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch import native
    from flgp_tpu_torch.fit import streaming

    path, _, sub = _torus_file(tmp_path, dev)
    for kernel in ("lae", "se"):
        g = ft.GraphConfig(s=256, r=3, K=64, kernel=kernel)
        with native.MatrixFile(path) as mat:
            over = streaming.streamed_ell_graph(mat, sub.centers, g, 1 << 16)
            serial = streaming.streamed_ell_graph(mat, sub.centers, g, 1 << 16, _overlap=False)
            small = streaming.streamed_ell_graph(mat, sub.centers, g, 1000)
        for Z in (serial, small):
            assert torch.equal(Z.values, over.values) and torch.equal(Z.indices, over.indices)


def test_pinned_buffers_are_reused_over_50_chunks(dev, tmp_path):
    """A 50-chunk pass reads into two pinned host buffers, one after the
    other, and the process's resident memory does not grow from one pass to
    the next."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch import native
    from flgp_tpu_torch.fit import streaming

    class Targets(native.MatrixFile):
        def __init__(self, path):
            super().__init__(path)
            self.ptrs = []

        def read_into(self, start, count, data_ptr):
            self.ptrs.append(data_ptr)
            return super().read_into(start, count, data_ptr)

    chunk = 4096
    X = np.random.default_rng(0).normal(size=(50 * chunk, 2)).astype(np.float32)
    path = str(tmp_path / "x.flgp")
    native.write_matrix(path, X)
    U = torch.as_tensor(X[:128], device=dev)
    g = ft.GraphConfig(s=128, r=3, K=16)

    def resident() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096

    mat = Targets(path)
    try:
        streaming.streamed_ell_graph(mat, U, g, chunk)
        assert len(mat.ptrs) == 50 and len(set(mat.ptrs)) == 2
        assert mat.ptrs[0::2] == [mat.ptrs[0]] * 25 and mat.ptrs[1::2] == [mat.ptrs[1]] * 25
        before = resident()
        for _ in range(3):
            streaming.streamed_ell_graph(mat, U, g, chunk)
        torch.cuda.synchronize()
        assert resident() - before < 8 * 2 ** 20
    finally:
        mat.close()


def test_partial_sums_of_row_blocks_add_to_the_whole_graph_s_bits(dev):
    """K3's and K4's float64 partials are exact: two row blocks' partials add
    to the whole graph's sums, and rounded once they are ell_colsum's and
    ell_norm_gram's bits (what lets the sharded spectrum on several cards be
    the single card's)."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    rng = np.random.default_rng(1)
    n, r, s = 300_001, 3, 512
    w = _cuda(rng.uniform(size=(n, r)), dev)
    idx = torch.as_tensor(rng.integers(0, s, size=(n, r)), dtype=torch.int32, device=dev)
    cscale = _cuda(rng.uniform(0.5, 2.0, size=s), dev)
    h = 123_457
    C = hk.ell_colsum_partial(w[:h], idx[:h], s) + hk.ell_colsum_partial(w[h:], idx[h:], s)
    assert torch.equal(C, hk.ell_colsum_partial(w, idx, s))
    assert torch.equal(C.float(), hk.ell_colsum(w, idx, s))
    G1, D1 = hk.ell_norm_gram_partial(w[:h], idx[:h], cscale)
    G2, D2 = hk.ell_norm_gram_partial(w[h:], idx[h:], cscale)
    G, D = hk.ell_norm_gram(w, idx, cscale)
    assert torch.equal((G1 + G2).float(), G) and torch.equal((D1 + D2).float(), D)


def test_sharded_spectrum_under_nccl_is_spectrum_fused(dev, tmp_path):
    import socket

    import torch.distributed as dist

    import flgp_tpu_torch as ft
    from flgp_tpu_torch.ops.spectrum import spectrum_fused
    from flgp_tpu_torch.parallel import mesh as pmesh
    from flgp_tpu_torch.parallel.spectral import (
        _local_ell,
        sharded_spectrum_fn,
        sharded_spectrum_from_ell_fn,
    )

    _, X, sub = _torus_file(tmp_path, dev)
    g = ft.GraphConfig(s=256, r=3, K=64)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = pmesh.global_mesh(("data",))
        assert mesh.size == 1 and mesh.device.type == "cuda"
        Z = _local_ell(X, sub.centers, g)
        ref = spectrum_fused(Z.values, Z.indices, 256, 64, g.gl, g.root, sub.counts)
        for values, vectors in (sharded_spectrum_from_ell_fn(mesh, g)(Z.values, Z.indices,
                                                                      sub.counts),
                                sharded_spectrum_fn(mesh, g)(X, sub.centers, sub.counts)):
            assert torch.equal(values, ref.values) and torch.equal(vectors, ref.vectors)
    finally:
        dist.destroy_process_group()


def test_streamed_fit_runs_on_the_card_by_default(dev, tmp_path):
    import flgp_tpu_torch as ft
    from flgp_tpu_torch import native
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.fit import streaming

    ds = torus_rings(n=4800, m_train=100, seed=1234)
    path = str(tmp_path / "t.flgp")
    native.write_matrix(path, np.concatenate([ds.x_train, ds.x_test]).astype(np.float32))
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=600, r=3, K=100), sigma=1e-3,
                       dtype=torch.float32, solve_dtype=torch.float64)
    with native.MatrixFile(path) as mat:
        res = streaming.fit_lae_logit_gp_streamed(torch.Generator(device=dev).manual_seed(0),
                                                  mat, ds.y_train, np.arange(100), cfg=cfg,
                                                  chunk_rows=1000)
    assert res.labels.device.type == "cuda" and res.pars["t"].dtype == torch.float64
    assert float(torch.mean((res.labels[100:].cpu() != torch.as_tensor(ds.y_test)).double())) <= 0.03
