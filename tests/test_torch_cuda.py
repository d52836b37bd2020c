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
def test_knn_tiled_body_matches_plain(dev, d, r):
    """K1's tiled body (every d but 2 and 3) against ``knn_plain``, at ragged
    n (3,001 and 70,001), ragged s (601 and 700) and the anchor-split shape
    (n = 3000, s = 700): one launch counted a call; rows differing on
    near-ties only (at most 1% of them: at d = 784 and r = 16 some 0.1% of
    the rows swap two neighbours whose d² the two roundings order
    otherwise), d² within 1e-5; and with exact ties at anchors 4, 9 and 10,
    in every row that lists anchor 9 or 10, anchor 4 before it, and 9
    before 10."""
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
        torch.cuda.synchronize()
        assert hk.LAUNCHES["knn"] == before + 1
        ref = knn_plain(X, U, r)
        _near_ties_only(got, ref, X, U, 1e-2)
        torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=2e-5)
        slot = torch.arange(r, device=dev)
        p4, p9, p10 = (torch.where(got.indices == j, slot, r).amin(dim=1) for j in (4, 9, 10))
        assert bool(torch.all((p9 == r) | (p4 < p9))), (n, s)
        assert bool(torch.all((p10 == r) | ((p4 < p10) & (p9 < p10)))), (n, s)


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


def _tied_anchors_in_order(idx):
    """Anchors 4, 9 and 10 coincide: in every row 4 comes first, and 9 or 10
    only after it."""
    for row in idx[:3000].cpu().tolist():
        where = [row.index(j) for j in (4, 9, 10) if j in row]
        assert where == sorted(where)
        assert 4 in row or not (9 in row or 10 in row)


@pytest.mark.parametrize("r", [17, 24, 32, 33, 48, 100, 1000, "s"])
@pytest.mark.parametrize("d", [2, 3, 5, 16, 784])
def test_knn_runtime_r_body_matches_plain(dev, d, r):
    """K1 above r = 16 (csrc/knn_wide.cu) against ``knn_plain``: rows
    differing on near-ties only, d² within 1e-5, at a ragged shape (n =
    3001, s = 1201: ten anchor tiles, the last partial) and at the
    anchor-split shape (n = 3000, s = 700), where every split 1, 2, ..., 32
    gives the same bits; r = "s" takes every anchor.  At d = 2 the d² are
    the plain version's bits, so at most one row may differ; at other d a
    list of hundreds of neighbours holds pairs whose d² the two roundings
    order otherwise in many rows, each of them a near-tie.  Exact ties at
    anchors 4, 9 and 10 keep 4 first; one launch counted a call; r > s
    raises."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    g = torch.Generator(device=dev).manual_seed(1000 * d + (0 if r == "s" else r))
    for n, s in ((3001, 1201), (3000, 700)):
        rr = s if r == "s" else r
        if rr > s:
            continue
        X = torch.randn((n, d), generator=g, device=dev)
        U = torch.randn((s, d), generator=g, device=dev)
        U[9] = U[4]
        U[10] = U[4]
        before = hk.LAUNCHES["knn"]
        got = hk.knn(X, U, rr)
        torch.cuda.synchronize()
        assert hk.LAUNCHES["knn"] == before + 1
        ref = knn_plain(X, U, rr)
        _near_ties_only(got, ref, X, U, 0.0 if d == 2 else 1.0)
        torch.testing.assert_close(got.sqdists, ref.sqdists, rtol=1e-5, atol=1e-5)
        _tied_anchors_in_order(got.indices)
        if s == 700:
            for split in (1, 2, 4, 8, 16, 32):
                forced = hk._knn(X, U, rr, split)
                assert torch.equal(forced.indices, got.indices), split
                assert torch.equal(forced.sqdists, got.sqdists), split
        with pytest.raises(ValueError):
            hk.knn(X, U, s + 1)


@pytest.mark.parametrize("r", [1, 3, 16])
@pytest.mark.parametrize("d", [2, 3, 5, 16])
def test_knn_runtime_r_body_is_the_templated_body_bit_for_bit(dev, d, r):
    """The run-time-r body forced at r ≤ 16 (``runtime_r``) against the
    templated bodies (d = 2, 3: the template bodies; 5, 16: the tiled one):
    the same indices and d² bit for bit, at ragged n and s, a shape whose
    rows fill the card and the anchor-split shape, every split of the
    run-time-r body forced there."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    g = torch.Generator(device=dev).manual_seed(10 * d + r)
    for n, s in ((3001, 601), (70_001, 700), (3000, 700)):
        X = torch.randn((n, d), generator=g, device=dev)
        U = torch.randn((s, d), generator=g, device=dev)
        U[9] = U[4]
        U[10] = U[4]
        got = hk.knn(X, U, r)
        for split in ((0, 1, 2, 4, 8, 16, 32) if s == 700 and n == 3000 else (0,)):
            forced = hk._knn(X, U, r, split, runtime_r=True)
            assert torch.equal(forced.indices, got.indices), (n, s, split)
            assert torch.equal(forced.sqdists, got.sqdists), (n, s, split)


@pytest.mark.parametrize("r", [48, 100])
def test_knn_runtime_r_self_neighbours(dev, gen, r):
    """The GLGP self-kNN above r = 16 (s = n, the torus GLGP cell's r = 48):
    each point first in its own list at d² ≈ 0, point 9 an exact twin of
    point 4 (both lists start {4, 9}); rows differ from ``knn_plain`` on
    near-ties only, d² within 1e-5."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.knn import knn_plain

    Xnp = gen.normal(size=(20000, 3))
    Xnp[9] = Xnp[4]
    X = _cuda(Xnp, dev)
    got = hk.knn(X, X, r)
    torch.cuda.synchronize()
    ref = knn_plain(X, X, r)
    _near_ties_only(got, ref, X, X, 1e-2)
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
        hk.knn(X, U, 21)                              # r above s = 20
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


@pytest.mark.parametrize("driver", ["fit_lae_logit_gp", "fit_lae_logit_mult_gp",
                                    "mult_t_posterior"])
def test_host_syncs_count_every_synchronizing_call_of_a_fit(dev, driver):
    """Every call of the two LAE drivers' fit path that makes the host wait
    for the card, as ``torch.cuda.set_sync_debug_mode("warn")`` reports
    them (reads, uploads, and the library calls that read on the host), is
    counted in ``host_syncs``; so is every one of a short SMC ladder over
    four classes' log t (``mult_t_posterior``: its β reads and its Newton
    rounds' reads), composed as the benchmark's hyperposterior job composes it."""
    import warnings

    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import mnist_like, torus_rings
    from flgp_tpu_torch.utils import metrics

    if driver == "fit_lae_logit_gp":
        ds = torus_rings(n=2400, m_train=100, seed=1234)
        graph = ft.GraphConfig(s=240, r=3, K=60)
    else:
        ds = mnist_like(n=3000, n_classes=4, d=16, m_train=200, seed=4)
        graph = ft.GraphConfig(s=150, r=3, K=40)
    cfg = ft.FitConfig(graph=graph, n_gibbs=10, gibbs_avg_sweeps=5, dtype=torch.float32,
                       solve_dtype=torch.float64)

    def fit():
        gen = torch.Generator(device=dev).manual_seed(0)
        if driver != "mult_t_posterior":
            return getattr(ft, driver)(gen, ds.x_train, ds.y_train, ds.x_test, cfg=cfg)
        from flgp_tpu_torch.fit import drivers, spectral
        from flgp_tpu_torch.fit.multiclass import one_hot_labels
        from flgp_tpu_torch.inference import hyperparam

        X = torch.cat([metrics.to_device(ds.x_train, cfg.dtype, dev),
                       metrics.to_device(ds.x_test, cfg.dtype, dev)])
        Y = metrics.to_device(ds.y_train, cfg.dtype, dev)
        eig, _ = spectral.build_spectrum(gen, X, cfg.graph)
        _, seig, (aug,) = drivers._solve_cast(cfg, eig, one_hot_labels(Y, 4))
        stages = metrics.COUNTS["smc_stages"]
        post = hyperparam.mult_t_posterior(gen, seig, aug, torch.arange(200, device=dev), 40,
                                           cfg.sigma, n_particles=16, n_mutation_steps=2)
        assert metrics.COUNTS["smc_stages"] - stages == post.smc.n_stages > 1
        return post

    fit()                                   # the kernels' first launches
    torch.cuda.synchronize()
    before = metrics.COUNTS["host_syncs"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)
    assert metrics.COUNTS["host_syncs"] - before == syncs > 0


def test_streamed_fit_counts_its_syncs_apart_from_its_buffer_waits(dev, tmp_path):
    """The out-of-core binary fit: ``host_syncs`` is what the sync debug mode
    reports, and the host's waits on a pinned buffer's copy are counted apart
    (``stream_buffer_waits``: each of the two passes through the pinned
    buffers waits once a chunk but for the first two), beside three passes of
    ``stream_chunks``."""
    import math
    import warnings

    import flgp_tpu_torch as ft
    from flgp_tpu_torch import native
    from flgp_tpu_torch.datasets import torus_rings
    from flgp_tpu_torch.fit import streaming
    from flgp_tpu_torch.utils import metrics

    ds = torus_rings(n=24000, m_train=200, seed=1234)
    path = str(tmp_path / "x.flgp")
    native.write_matrix(path, np.concatenate([ds.x_train, ds.x_test]).astype(np.float32))
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=240, r=3, K=60), n_gibbs=10, gibbs_avg_sweeps=5,
                       dtype=torch.float32, solve_dtype=torch.float64)
    rows = 5000
    chunks = math.ceil(24000 / rows)

    def fit(mat):
        return streaming.fit_lae_logit_gp_streamed(
            torch.Generator(device=dev).manual_seed(0), mat, ds.y_train, np.arange(200), cfg=cfg,
            chunk_rows=rows)

    with native.MatrixFile(path) as mat:
        fit(mat)                            # the kernels' first launches
        torch.cuda.synchronize()
        before = metrics.COUNTS.copy()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fit(mat)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)
    got = metrics.COUNTS - before
    assert got["host_syncs"] == syncs > 0
    assert got["stream_chunks"] == 3 * chunks
    assert got["stream_buffer_waits"] == 2 * (chunks - 2)


# ---------------------------------------------------------------------------
# K2–K8 above r = 16: the run-time-r bodies
# ---------------------------------------------------------------------------


def _lae_problem(gen, dev, n, r, d=3, s=400):
    from flgp_tpu_torch.ops.knn import knn_plain

    X = _cuda(gen.normal(size=(n, d)), dev)
    U = _cuda(gen.normal(size=(s, d)), dev)
    return X, U, knn_plain(X, U, r).indices


def _feature_major(X, idx, c):
    """(Xt (d, n), the (nch, r, c) index array with index 0 on the pads)."""
    return X.T.contiguous(), _chunked(idx, c)


@pytest.mark.parametrize("r", [17, 24, 32, 33, 64, 65, 100])
def test_lae_wide_body_is_the_plain_version_bit_for_bit(dev, gen, r):
    """K2 above r = 16 (a warp a point, G in shared memory; one, two and
    four slots a lane, partial warps) equals ``lae_weights_plain`` bit for
    bit in both layouts, on a ragged n, with exact zeros on the pad points."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    n, c = 3001, 768
    X, U, idx = _lae_problem(gen, dev, n, r)
    before = hk.LAUNCHES["lae_weights"]
    got = hk.lae_weights(X, U, idx)
    Xt, idx_t = _feature_major(X, idx, c)
    got_t = hk.lae_weights_t(Xt, U, idx_t)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["lae_weights"] == before + 2
    assert torch.equal(got, lae_weights_plain(X, U, idx))
    flat = got_t.transpose(1, 2).reshape(-1, r)
    assert torch.equal(flat[:n], got)
    assert float(torch.max(torch.abs(flat[n:]))) == 0.0              # the pad points
    assert float(torch.max(torch.abs(got.sum(1) - 1))) <= 1e-5 and float(got.min()) >= 0


def test_lae_above_its_shared_memory_limit_raises(dev, gen):
    """K2's one fan-in limit: r² Gram floats and the momentum table in 227 KB
    (r = 240 at 150 steps).  Above it the wrapper raises; at it, the kernel
    runs."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    assert hk.lae_max_r(150) == 240 and hk.lae_max_r(12288) < 240
    X, U, idx = _lae_problem(gen, dev, 40, 241, s=300)
    with pytest.raises(ValueError, match="240"):
        hk.lae_weights(X, U, idx)
    Xt, idx_t = _feature_major(X, idx, 128)
    with pytest.raises(ValueError, match="240"):
        hk.lae_weights_t(Xt, U, idx_t)
    assert torch.equal(hk.lae_weights(X, U, idx[:, :240].contiguous()),
                       lae_weights_plain(X, U, idx[:, :240]))


@pytest.mark.parametrize("r", [1, 3, 16])
def test_runtime_r_bodies_are_the_templated_bodies_bit_for_bit(dev, gen, r):
    """The run-time-r body of each kernel family, forced at r ≤ 16
    (``runtime_r``), gives the templated body's bits: K2 in both layouts,
    K4 and K7 (Ĝ, D and the counts' total), K5 and K8; K4/K7 and K5/K8 also
    with one pair a point held in shared memory, the rest formed again from
    the graph.  K3 and K6 have one body for every r."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    X, U, idx = _lae_problem(gen, dev, 3001, r)
    assert torch.equal(hk._lae_weights(X, U, idx, 150, runtime_r=True),
                       hk.lae_weights(X, U, idx))
    Xt, idx_t = _feature_major(X, idx, 768)
    assert torch.equal(hk._lae_weights_t(Xt, U, idx_t, 150, runtime_r=True),
                       hk.lae_weights_t(Xt, U, idx_t))

    v, i, _, _ = _point_major_graph(gen, dev, 4001, r, 64)
    cs = _cuda(gen.uniform(0.5, 2.0, size=64), dev)
    W = _cuda(gen.normal(size=(64, 40)), dev)
    vt, it = _chunked(v, 999), _chunked(i, 999)
    for cap in (0, 1):
        G, D, stats = hk._ell_norm_gram(v, i, cs, EPS, 0)
        Gw, Dw, stats_w = hk._ell_norm_gram(v, i, cs, EPS, 0, runtime_r=True, pair_cap=cap)
        assert torch.equal(G, Gw) and torch.equal(D, Dw)
        assert int(stats.sum()) == int(stats_w.sum())
        Gt, Dt, _ = hk._ell_norm_gram_t(vt, it, cs, EPS, 0, runtime_r=True, pair_cap=cap)
        assert torch.equal(G, Gt) and torch.equal(D, Dt)
        assert torch.equal(hk._ell_norm_matmat(v, i, cs, W, EPS, runtime_r=True, pair_cap=cap),
                           hk.ell_norm_matmat(v, i, cs, W))
        assert torch.equal(hk._ell_norm_matmat_t(vt, it, cs, W, EPS, runtime_r=True,
                                                 pair_cap=cap),
                           hk.ell_norm_matmat_t(vt, it, cs, W))


@pytest.mark.parametrize("pair_cap", [0, 5])
@pytest.mark.parametrize("s", [64, 13000])
@pytest.mark.parametrize("r", [17, 24, 40])
def test_ell_colsum_and_gram_at_wide_r_are_exact(dev, gen, r, s, pair_cap):
    """K3/K6 and K4/K7 above r = 16, with a repeated anchor in every third
    row and an out-of-range index: C equals ``_colsum_fixed_plain`` bit for
    bit; Ĝ and D lie within 1e-5·max of the float64 plain version and are
    the same bits in both layouts, with pairs formed again from the graph
    (``pair_cap``) or not; the counts add up to the r(r+1)/2 pairs of every
    point with a weight."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    n = 4000
    v, i, v0, i0 = _point_major_graph(gen, dev, n, r, s)
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    before = dict(hk.LAUNCHES)
    C = hk.ell_colsum(v, i, s)
    assert torch.equal(C, hk._colsum_fixed_plain(v, i, s))
    assert torch.equal(hk.ell_colsum_t(_chunked(v, 768), _chunked(i, 768), s), C)
    G, D, stats = hk._ell_norm_gram(v, i, cs, EPS, 0, runtime_r=pair_cap > 0, pair_cap=pair_cap)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_norm_gram"] == before["ell_norm_gram"] + 1
    Gp, Dp = hk.ell_norm_gram_plain(v0.double(), i0, cs.double(), EPS)
    assert float(torch.max(torch.abs(G - Gp))) <= 1e-5 * float(torch.max(torch.abs(Gp)))
    assert float(torch.max(torch.abs(D - Dp))) <= 1e-5 * float(torch.max(torch.abs(Dp)))
    assert int(stats.sum()) == n * r * (r + 1) // 2 - r
    G2, D2 = hk.ell_norm_gram(v, i, cs)
    assert torch.equal(G, G2) and torch.equal(D, D2)
    G3, D3 = hk.ell_norm_gram_t(_chunked(v, 768), _chunked(i, 768), cs)
    assert torch.equal(G, G3) and torch.equal(D, D3)


@pytest.mark.parametrize("pair_cap", [0, 7])
@pytest.mark.parametrize("K", [3, 40, 128])
@pytest.mark.parametrize("r", [17, 24, 120])
def test_ell_norm_matmat_at_wide_r_matches_plain(dev, gen, r, K, pair_cap):
    """K5 and K8 above r = 16 (r = 120: more than the 113 pairs a point the
    shared slices hold) against the plain version at the tolerance of
    ``test_ell_kernels_match_plain``, on a ragged n and the chunked layout
    with a zero-weight pad tail; the same bits whatever share of the pairs
    is formed again from the graph, and the pad rows exact zeros."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    n, s = 4001, 300
    v, i, v0, i0 = _point_major_graph(gen, dev, n, r, s)
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    W = _cuda(gen.normal(size=(s, K)), dev)
    before = hk.LAUNCHES["ell_norm_matmat"]
    got = hk.ell_norm_matmat(v, i, cs, W)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_norm_matmat"] == before + 1
    torch.testing.assert_close(got, hk.ell_norm_matmat_plain(v0, i0, cs, W), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(hk._ell_norm_matmat(v, i, cs, W, EPS, runtime_r=True, pair_cap=pair_cap),
                       got)
    vt, it = _chunked(v, 999), _chunked(i, 999)
    got_t = hk._ell_norm_matmat_t(vt, it, cs, W, EPS, runtime_r=True, pair_cap=pair_cap)
    assert torch.equal(got_t[:n], got)
    assert float(torch.max(torch.abs(got_t[n:]))) == 0.0


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


def _misaligned(t):
    """A contiguous copy of t whose storage starts one float in: its data
    pointer is not 16-byte aligned."""
    buf = t.new_empty((t.numel() + 1,))
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("case", ["point-major", "few-points", "many-tiles", "chunked",
                                  "misaligned"])
@pytest.mark.parametrize("K", [1, 3, 40, 100, 128, 130])
@pytest.mark.parametrize("r", [1, 3, 5, 16])
def test_ell_norm_matmat_tiled_body_matches_plain(dev, gen, r, K, case):
    """K5 and K8's tiled body against ``ell_norm_matmat_plain`` and
    ``_t_plain`` at the tolerance of ``test_ell_norm_matmat_at_wide_r_matches_plain``
    (the plain side given the graph with its out-of-range entries as zero
    weights on anchor 0, which add nothing), at K % 4 == 0 (16-byte pieces)
    and not, on a ragged n (4001, 5 points, and 70,001, where warps walk
    several tiles); on the chunked layout with c = 999 (tiles straddle
    chunks) and a zero-weight pad tail, whose first n rows are the
    point-major output's bits; with a W and an output that are not 16-byte
    aligned (the 4-byte pieces), the aligned output's bits and no NaN left;
    duplicate anchors in a row, out-of-range indices and a point with no
    weight, whose row and the pad rows must be exact zeros."""
    from flgp_tpu_torch.config import EPS
    from flgp_tpu_torch.ops import hopper_kernels as hk

    s, nan = 300, float("nan")
    n = {"few-points": 5, "many-tiles": 70_001}.get(case, 4001)
    vals = gen.uniform(0.1, 1.0, size=(n, r))
    idx = gen.integers(0, s, size=(n, r))
    if r > 1:
        idx[::3, 1] = idx[::3, 0]                          # one anchor twice in a row
    idx[0, 0] = s                                          # out of range, both sides
    idx[n - 1, r - 1] = -7
    vals[n // 2] = 0.0                                     # no weight: a row of zeros
    v, i = _cuda(vals, dev), _cuda(idx, dev, torch.int32)
    v0, i0 = v.clone(), i.clone()
    for row, k in ((0, 0), (n - 1, r - 1)):
        v0[row, k], i0[row, k] = 0.0, 0
    cs = _cuda(gen.uniform(0.5, 2.0, size=s), dev)
    W = _cuda(gen.normal(size=(s, K)), dev)
    before = hk.LAUNCHES["ell_norm_matmat"]
    got = hk._ell_norm_matmat(v, i, cs, W, EPS)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["ell_norm_matmat"] == before + 1
    if case == "chunked":
        c = 999
        vt, it = _chunked(v, c), _chunked(i, c)
        got_t = hk._ell_norm_matmat_t(vt, it, cs, W, EPS)
        torch.cuda.synchronize()
        assert got_t.shape == (vt.shape[0] * c, K)
        torch.testing.assert_close(
            got_t, hk.ell_norm_matmat_t_plain(_chunked(v0, c), _chunked(i0, c), cs, W),
            rtol=1e-5, atol=1e-5)
        assert float(torch.max(torch.abs(got_t[n:]))) == 0.0         # pad rows
        assert torch.equal(got_t[:n], got)                  # the two layouts agree
    elif case == "misaligned":
        Wm = _misaligned(W)
        got_m = hk._ell_norm_matmat(v, i, cs, Wm, EPS, out=_misaligned(W.new_full((n, K), nan)))
        c = 1000
        vt, it = _chunked(v, c), _chunked(i, c)
        got_t = hk._ell_norm_matmat_t(vt, it, cs, Wm, EPS,
                                      out=_misaligned(W.new_full((vt.shape[0] * c, K), nan)))
        aligned_t = hk._ell_norm_matmat_t(vt, it, cs, W, EPS)
        torch.cuda.synchronize()
        assert got_m.data_ptr() % 16 != 0
        assert torch.equal(got_m, got) and torch.equal(got_t, aligned_t)
        assert not bool(torch.any(torch.isnan(got_t)))
        assert torch.equal(got_t[:n], got)                  # the two layouts agree too
    else:
        assert torch.equal(hk.ell_norm_matmat(v, i, cs, W), got)      # the public wrapper
    torch.testing.assert_close(got, hk.ell_norm_matmat_plain(v0, i0, cs, W), rtol=1e-5,
                               atol=1e-5)
    assert not bool(torch.any(torch.isnan(got)))
    assert float(torch.max(torch.abs(got[n // 2]))) == 0.0


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


def _seed_case(dev, s, C, seed):
    """Weighted k-means++ inputs at (s, C) on the card: C candidates from four
    clusters with 1-NN masses for weights (whole numbers, zeros, the largest
    tied), their float32 squared distances, and the noise of s − 1 steps."""
    from flgp_tpu_torch.ops import kmeans

    rng = np.random.default_rng(seed)
    cands = _cuda(rng.normal(size=(C, 2)) + 6.0 * rng.integers(0, 4, size=(C, 1)), dev)
    w = rng.integers(0, 50, size=C).astype(np.float64)
    w[rng.choice(C, min(3, C), replace=False)] = 60.0        # argmax(w) ties: the first wins
    w = _cuda(w, dev)
    dcc = torch.clamp(kmeans.sqdist(cands, cands), min=0.0)
    noise = kmeans._gumbel_rows(torch.Generator(device=dev).manual_seed(seed), s - 1, C, w)
    return dcc, w, noise


@pytest.mark.parametrize("s,C", [(1024, 2049), (600, 1201), (37, 75), (2048, 4097), (1, 1),
                                 (65, 28_672)])
def test_weighted_kmeanspp_kernel_picks_the_plain_loop_s_indices(dev, s, C):
    """The kernel and ``_weighted_kmeanspp_plain`` on the same noise give the
    same s indices, in order, at the cells' shapes (C = 2s + 1), a small and a
    large one, and at the most candidates the kernel takes (dynamic shared
    memory above 48 KB); one launch."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops import kmeans

    dcc, w, noise = _seed_case(dev, s, C, seed=C)
    before = hk.LAUNCHES["weighted_kmeanspp"]
    got = hk.weighted_kmeanspp(dcc, w, noise)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["weighted_kmeanspp"] == before + 1
    ref = kmeans._weighted_kmeanspp_plain(dcc, w, noise)
    assert got.dtype == torch.int64 and got.shape == (s,)
    assert torch.equal(got, ref), int(torch.sum(got != ref))
    assert torch.equal(hk.weighted_kmeanspp(dcc, w, noise), got)   # the same bits again


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kmeanspar_rows_on_the_card_gives_the_parent_s_centers_bit_for_bit(dev, dtype):
    """k-means‖ at the torus cell's s on the card: the seeding with its noise
    drawn up front (and, in float32, its one launch) gives the centers of the
    loop it replaced, bit for bit, from one seed; one ``seedings`` either way."""
    from collections import Counter

    import kmeans_parent
    from flgp_tpu_torch.ops import kmeans
    from flgp_tpu_torch.utils import metrics

    rng = np.random.default_rng(7)
    X = _cuda(rng.normal(size=(200_000, 2)) + 6.0 * rng.integers(0, 4, size=(200_000, 1)), dev,
              dtype)
    before = Counter(metrics.COUNTS)
    got = kmeans._kmeanspar_rows(torch.Generator(device=dev).manual_seed(3), X, 1024)
    counted = {k: metrics.COUNTS[k] - before[k]
               for k in ("seedings", "kernel_launches:weighted_kmeanspp")}
    ref = kmeans_parent.kmeanspar_rows(torch.Generator(device=dev).manual_seed(3), X, 1024)
    assert torch.equal(got, ref)
    kernel = dtype == torch.float32
    assert kmeans.seed_on_kernel("cuda", dtype, 2049) is kernel
    assert counted == {"seedings": 1, "kernel_launches:weighted_kmeanspp": int(kernel)}


def test_weighted_kmeanspp_kernel_refuses_what_it_does_not_take(dev):
    """No fallback: a CPU tensor, another dtype, a non-contiguous input, a
    wrong shape or more candidates than shared memory holds raises."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    dcc, w, noise = _seed_case(dev, 37, 75, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hk.weighted_kmeanspp(dcc.cpu(), w.cpu(), noise.cpu())
    for args in ((dcc.double(), w, noise), (dcc, w.double(), noise), (dcc, w, noise.double()),
                 (dcc, w, noise.half())):
        with pytest.raises(TypeError):
            hk.weighted_kmeanspp(*args)
    wide = torch.zeros((75, 150), device=dev)
    for args in ((dcc.t(), w, noise), (dcc, wide[:, ::2][0], noise),
                 (dcc, w, noise.t().contiguous().t()), (dcc[:, :74], w, noise),
                 (dcc, w, noise[:, :74]), (dcc, w, noise[0]), (dcc, w[:0], noise)):
        with pytest.raises(ValueError):
            hk.weighted_kmeanspp(*args)
    with pytest.raises(ValueError):
        hk.weighted_kmeanspp(dcc.cpu(), w, noise)
    C = hk.KMEANSPP_MAX_C + 1
    with pytest.raises(ValueError):
        hk.weighted_kmeanspp(torch.zeros((1, 1), device=dev).expand(C, C),
                             torch.ones((C,), device=dev), torch.zeros((0, C), device=dev))


def _lloyd_cloud(dev, d, n=1_000_000):
    """The torus cell's points at d = 2, standard normal points otherwise."""
    from flgp_tpu_torch.datasets import torus_rings

    if d == 2:
        ds = torus_rings(n=n, m_train=1000, seed=0)
        return _cuda(np.concatenate([ds.x_train, ds.x_test]), dev)
    return _cuda(np.random.default_rng(d).normal(size=(n, d)), dev)


def _nearest_f64(X, U, block=1 << 16):
    """Each row's two nearest float64 squared distances, and its nearest
    anchor (first on ties)."""
    X64, U64 = X.double(), U.double()
    two, first = [], []
    for i in range(0, X.shape[0], block):
        dist = torch.cdist(X64[i:i + block], U64) ** 2
        two.append(torch.topk(dist, 2, dim=1, largest=False).values)
        first.append(torch.argmin(dist, dim=1))
    return torch.cat(two), torch.cat(first)


@pytest.mark.parametrize("d", [2, 3, 16])
def test_lloyd_assign_on_k1_is_the_plain_pass_but_near_ties(dev, d):
    """At the torus cell's n and s: K1 at r = 1 and the blocked distance
    matrix pick the same center on every row but those whose float64 first
    and second nearest lie within a few float32 ulps of the row's scale
    (|x|² + max |u|², what the expansion rounds), and give its distance to
    float32 rounding."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops import kmeans

    X = _lloyd_cloud(dev, d)
    g = torch.Generator(device=dev).manual_seed(1)
    U = X[torch.randperm(X.shape[0], generator=g, device=dev)[:1024]].contiguous()
    assert kmeans.assign_on_kernel("cuda", torch.float32, d)
    before = hk.LAUNCHES["knn"]
    a, m = kmeans._assign(X, U, True)
    assert hk.LAUNCHES["knn"] == before + 1
    ap, mp = kmeans._assign_plain(X, U)
    assert a.dtype == torch.int32 and ap.dtype == torch.int64
    two, _ = _nearest_f64(X, U)
    ulp = (torch.sum(X.double() ** 2, dim=1) + torch.max(torch.sum(U.double() ** 2, dim=1))) * 2.0 ** -23
    differ = a.long() != ap
    near_tie = two[:, 1] - two[:, 0] <= 8 * ulp
    assert not bool(torch.any(differ & ~near_tie)), int(torch.sum(differ & ~near_tie))
    assert bool(torch.all(torch.abs(m.double() - mp.double()) <= 8 * ulp))


def test_lloyd_on_k1_counts_its_passes_and_its_counts_hold(dev, monkeypatch):
    """A 20-round Lloyd from one init at the torus cell's shape, on K1 and on
    the plain pass: ``lloyd_kernel_rounds`` counts each of K1's passes (the
    rounds and the last one) and none of the plain pass's, and the share of
    points whose float64 nearest center is not the one counted stays under
    the cell's limit of 3e-4 (the benchmark's ``count_gap``)."""
    from collections import Counter

    from flgp_tpu_torch.ops import kmeans
    from flgp_tpu_torch.utils import metrics

    X = _lloyd_cloud(dev, 2)
    n, s = X.shape[0], 1024
    g = torch.Generator(device=dev).manual_seed(2)
    init = X[torch.randperm(n, generator=g, device=dev)[:s]].contiguous()
    out = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            monkeypatch.setattr(kmeans, "_KERNEL_ASSIGN_MAX_D", 0)
        before = Counter(metrics.COUNTS)
        centers, counts, wss = kmeans.lloyd(X, init, 20)
        rounds = metrics.COUNTS["lloyd_rounds"] - before["lloyd_rounds"]
        passes = metrics.COUNTS["lloyd_kernel_rounds"] - before["lloyd_kernel_rounds"]
        assert passes == (rounds + 1 if path == "kernel" else 0), (path, rounds, passes)
        _, nearest = _nearest_f64(X, centers)
        counts64 = torch.bincount(nearest, minlength=s).double()
        gap = float(torch.abs(counts64 - counts.double()).sum()) / (2 * n)
        assert gap <= 3e-4, (path, gap)
        out[path] = float(wss)
    assert abs(out["kernel"] - out["plain"]) <= 1e-2 * out["plain"], out


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


def test_ten_classes_in_one_t_search_are_their_lone_trainings(dev):
    """Ten classes trained as the problems of one t-search (float32 graph,
    float64 tail): each class's window shifts and objective (within 1e-9) of
    its lone training, its t inside the lone training's last bracket, the
    labels of the lone trainings' t, and at least three times fewer Newton
    rounds than the ten lone trainings together.  Batched cuBLAS and
    cuSOLVER may round an objective differently at ten times the batch, and
    where two cells of the last refinement round are that close the search
    takes the other: t moves by one cell, 9e-6 of t at 32 points a round."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import mnist_like
    from flgp_tpu_torch.fit import multiclass as mc
    from flgp_tpu_torch.fit import spectral
    from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc
    from flgp_tpu_torch.utils import metrics

    ds = mnist_like(n=20000, n_classes=10, d=64, m_train=500, seed=4)
    X = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32, device=dev)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=600, r=3, K=100), n_gibbs=50, gibbs_avg_sweeps=25,
                       dtype=torch.float32, solve_dtype=torch.float64)
    m, n, K = len(ds.y_train), X.shape[0], 100
    eig, _ = spectral.build_spectrum(torch.Generator(device=dev).manual_seed(0), X, cfg.graph)
    aug = mc.one_hot_labels(torch.as_tensor(ds.y_train, dtype=torch.float32, device=dev), 10)
    scfg, seig, (aug_s,) = _solve_cast(cfg, eig, aug)
    before = metrics.COUNTS["newton_rounds"]
    joint = mc._train_mult(seig, aug_s, m, K, scfg)
    joint_rounds = metrics.COUNTS["newton_rounds"] - before
    N = torch.ones(m, dtype=torch.float64, device=dev)
    before = metrics.COUNTS["newton_rounds"]
    lone = [_train_gpc(seig, aug_s[:, j], N, slice(0, m), K, scfg) for j in range(10)]
    lone_rounds = metrics.COUNTS["newton_rounds"] - before
    t_lone = torch.stack([r.x for r in lone])
    gap = torch.abs(torch.log(joint.x) - torch.log(t_lone))
    assert bool(torch.all(gap <= torch.stack([r.bracket_logwidth for r in lone]))), gap
    torch.testing.assert_close(joint.obj, torch.stack([r.obj for r in lone]), rtol=1e-9, atol=0)
    assert joint.n_expansions == [r.n_expansions for r in lone]
    assert 0 < 3 * joint_rounds <= lone_rounds, (joint_rounds, lone_rounds)
    labels = [mc._predict_mult(torch.Generator(device=dev).manual_seed(1), seig, aug_s, t, m, n,
                               K, scfg)[0] for t in (joint.x, t_lone)]
    assert torch.equal(labels[0], labels[1])


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



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graphed_adam_is_the_eager_adam_s_bits_on_the_card(dev, dtype, monkeypatch):
    """The GPR grid's training (ten lanes, m = 1000, K = 128, the float64
    Woodbury objective) with its steps replayed from one CUDA graph against
    the same steps launched one by one: the same iterate, value and gradient
    norm, bit for bit, and one ``adam_steps`` a step either way."""
    from flgp_tpu_torch.inference import optimize as opt
    from flgp_tpu_torch.models import gpr
    from flgp_tpu_torch.types import EigenPair
    from flgp_tpu_torch.utils import metrics

    rng = np.random.default_rng(4)
    lanes, m, K = 10, 1000, 128
    vals = np.sort(rng.uniform(0.0, 1.0, size=(lanes, K)), axis=1)[:, ::-1].copy()
    pair = EigenPair(_cuda(vals, dev, torch.float64)[:, None],
                     _cuda(rng.normal(size=(lanes, m, K)), dev, torch.float64)[:, None])
    Y = _cuda(rng.normal(size=m), dev, torch.float64)

    def fn(x):
        t, noise = 1e-3 + torch.exp(x[:, :1]), 1e-4 + torch.exp(x[:, 1:])
        return gpr.gpr_nmll_posterior(pair, Y, slice(0, m), K, t.double(), noise.double(),
                                      1e-5)[:, 0]

    x0 = _cuda(np.stack([np.log(rng.uniform(1, 100, lanes)), np.zeros(lanes)], 1), dev, dtype)
    before = metrics.COUNTS["adam_steps"]
    graphed = opt.adam_minimize(fn, x0, steps=200)
    assert metrics.COUNTS["adam_steps"] - before == 200
    monkeypatch.setattr(opt, "_GRAPH_WARMUP", 200)
    before = metrics.COUNTS["adam_steps"]
    eager = opt.adam_minimize(fn, x0, steps=200)
    assert metrics.COUNTS["adam_steps"] - before == 200
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b), (a, b)


def test_se_regression_fit_with_graphed_adam_is_the_eager_fit_s_bits_on_the_card(dev,
                                                                                  monkeypatch):
    """``fit_se_regression_gp`` on the card, its training's steps from one CUDA
    graph or launched one by one: the same (a², t, noise) and predictive
    moments, bit for bit."""
    import flgp_tpu_torch as ft
    from flgp_tpu_torch.datasets import spiral
    from flgp_tpu_torch.inference import optimize as opt

    ds = spiral(n=4000, m_train=200, seed=7)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=256, r=3, K=64, kernel="se"), sigma=1e-5)

    def fit():
        return ft.fit_se_regression_gp(torch.Generator(device=dev).manual_seed(3), ds.x_train,
                                       ds.y_train, ds.x_test, cfg=cfg)

    graphed = fit()
    monkeypatch.setattr(opt, "_GRAPH_WARMUP", 10**6)
    eager = fit()
    assert all(np.array_equal(graphed.pars[k], eager.pars[k]) for k in ("a2", "t", "noise"))
    assert np.array_equal(graphed.posterior_mean, eager.posterior_mean)
    assert np.array_equal(graphed.posterior_cov, eager.posterior_cov)


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


# ---------------------------------------------------------------------------
# The Pólya-Gamma sampler (csrc/polya_gamma.cu)
# ---------------------------------------------------------------------------

PG_CS = (0.0, 0.1, 1.0, 2.5, 10.0, 40.0)


def _pg_draws(dev, cs, S, dtype=torch.float64, seed=0):
    """S draws of PG(1, c) for each c of cs, through ``ops.polya_gamma``, (len(cs), S)."""
    from flgp_tpu_torch.ops.polya_gamma import polya_gamma

    c = _cuda(np.repeat(np.asarray(cs, np.float64)[:, None], S, axis=1), dev, dtype)
    return polya_gamma(torch.Generator(device=dev).manual_seed(seed), c)


def _pg_moments(c):
    """Closed-form mean and variance of PG(1, c)."""
    c = np.asarray(c, dtype=np.float64)
    mean = np.where(c == 0, 0.25, np.tanh(c / 2) / (2 * np.where(c == 0, 1, c)))
    cs = np.where(c == 0, 1.0, c)
    var = np.where(c == 0, 1 / 24, (np.sinh(cs) - cs) / (4 * cs**3 * np.cosh(cs / 2) ** 2))
    return mean, var


def _pg_within_mc_error(x, cs, k=4.0):
    """Whether each row of draws x (len(cs), S) has PG(1, c)'s mean and variance
    within k Monte Carlo standard errors (the variance's from the draws'
    own squared deviations)."""
    mean, var = _pg_moments(cs)
    S = x.shape[1]
    m = x.mean(1)
    dev2 = (x - m[:, None]) ** 2
    ok_mean = np.abs(m - mean) <= k * np.sqrt(var / S)
    ok_var = np.abs(dev2.mean(1) * S / (S - 1) - var) <= k * dev2.std(1) / np.sqrt(S)
    return ok_mean, ok_var


def _pg_problem(dev, m=300, n=2000):
    """A binary GP problem: (C (m, m), Cnv (n, m), Y (m,)) in float64 on the card."""
    rng = np.random.default_rng(5)
    x, xt = np.sort(rng.uniform(-3, 3, m)), rng.uniform(-3, 3, n)

    def k(a, b):
        return 4.0 * np.exp(-0.5 * (a[:, None] - b[None, :]) ** 2)

    C = k(x, x) + 1e-6 * np.eye(m)
    Y = (np.sin(2 * x) > 0).astype(np.float64)
    return _cuda(C, dev, torch.float64), _cuda(k(xt, x), dev, torch.float64), _cuda(
        Y, dev, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_polya_gamma_kernel_moments_match_the_closed_form(dev, dtype):
    """2e5 kernel draws at each c, one launch: PG(1, c)'s mean and variance
    within 4 Monte Carlo standard errors, in both types."""
    from flgp_tpu_torch.ops import hopper_kernels as hk

    S = 200_000
    before = hk.LAUNCHES["polya_gamma"]
    x = _pg_draws(dev, PG_CS, S, dtype)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["polya_gamma"] == before + 1 and x.dtype == dtype
    x = x.double().cpu().numpy()
    assert np.all(np.isfinite(x)) and np.all(x > 0)
    ok_mean, ok_var = _pg_within_mc_error(x, PG_CS)
    assert ok_mean.all() and ok_var.all(), (x.mean(1), x.var(1))


@pytest.mark.parametrize("c", [0.5, 3.0, 12.0])
def test_polya_gamma_kernel_against_the_native_oracle(dev, c):
    """Two-sample Kolmogorov-Smirnov against the host sampler
    (``native.polya_gamma``, the CPU statistical oracle), 1e5 draws each."""
    from scipy.stats import ks_2samp

    from flgp_tpu_torch import native

    S = 100_000
    got = _pg_draws(dev, [c], S, seed=3)[0].cpu().numpy()
    ref = native.polya_gamma(2024, np.ones(S, np.int32), np.full(S, c), n_threads=4)
    assert ks_2samp(got, ref).pvalue > 1e-4


@pytest.mark.parametrize("row", [0, 1, 2])
def test_polya_gamma_kernel_against_the_reference_sampler(dev, row):
    """Two-sample Kolmogorov-Smirnov against the reference package's sampler
    (``flgp_tpu.ops.polya_gamma``) at c = 0.5, 3 and 12: its 10,000 draws at
    each c are kept in tests/data/pg_jax_draws.npz, which
    ``tests/test_torch_models.py`` holds to the reference's output; 1e5
    kernel draws at the same c."""
    from pathlib import Path

    from scipy.stats import ks_2samp

    saved = np.load(Path(__file__).parent / "data" / "pg_jax_draws.npz")
    c, ref = float(saved["c"][row]), saved["draws"][row]
    got = _pg_draws(dev, [c], 100_000, seed=5 + row)[0].cpu().numpy()
    assert ks_2samp(got, ref).pvalue > 1e-4


def test_polya_gamma_kernel_one_seed_gives_one_set_of_bits(dev):
    """One generator seed gives the same bits twice, for a draw and for a
    whole ``test_pgbinary``; another seed gives other draws."""
    from flgp_tpu_torch.inference import pg_gibbs
    from flgp_tpu_torch.ops.polya_gamma import polya_gamma

    c = _cuda(np.random.default_rng(1).normal(scale=3.0, size=5000), dev, torch.float64)

    def draw(seed):
        return polya_gamma(torch.Generator(device=dev).manual_seed(seed), c)

    assert torch.equal(draw(9), draw(9)) and not torch.equal(draw(9), draw(10))
    C, Cnv, Y = _pg_problem(dev)

    def chain():
        return pg_gibbs.test_pgbinary(torch.Generator(device=dev).manual_seed(3), C, Y, Cnv,
                                      n_sweeps=20, avg_sweeps=10)

    (l1, p1), (l2, p2) = chain(), chain()
    assert torch.equal(l1, l2) and torch.equal(p1, p2)


def test_polya_gamma_kernel_nan_lane_ends_at_the_caps(dev):
    """A NaN lane returns the loop's fallback (t/2 from the inner loops,
    accepted, or t, over 4), as the CPU loop's NaN lane does; the lanes
    beside it keep PG(1, 1)'s law."""
    from flgp_tpu_torch.ops import polya_gamma as pg

    S = 200_000
    c = np.ones(2 * S)
    c[::2] = np.nan
    x = pg.polya_gamma(torch.Generator(device=dev).manual_seed(4), _cuda(c, dev, torch.float64))
    x = x.cpu().numpy()
    fallbacks = np.array([pg._T / 8, pg._T / 4])
    assert np.all(np.isin(x[::2], fallbacks))
    loop = pg.polya_gamma(torch.Generator().manual_seed(4), torch.full((64,), float("nan"),
                                                                       dtype=torch.float64))
    assert np.all(np.isin(loop.numpy(), fallbacks))
    ok_mean, ok_var = _pg_within_mc_error(x[1::2][None], [1.0])
    assert ok_mean.all() and ok_var.all()


def test_polya_gamma_counts_and_int_on_the_card_scale_the_mean(dev):
    """PG(N, c) from ``polya_gamma_counts`` and PG(b, c) from
    ``polya_gamma_int`` on the card: the mean N (b) times PG(1, c)'s."""
    from flgp_tpu_torch.ops.polya_gamma import polya_gamma_counts, polya_gamma_int

    c = np.repeat([1.0, 3.0], 100_000)
    N = np.tile([1, 3], 100_000)
    draws = polya_gamma_counts(torch.Generator(device=dev).manual_seed(1),
                               _cuda(N, dev, torch.int64), _cuda(c, dev, torch.float64),
                               3).cpu().numpy()
    mean, var = _pg_moments(np.array([1.0, 3.0]))
    for i, cv in enumerate((1.0, 3.0)):
        for nv in (1, 3):
            sel = (c == cv) & (N == nv)
            assert abs(draws[sel].mean() - nv * mean[i]) < 4 * np.sqrt(nv * var[i] / sel.sum())
    b, S = 4, 50_000
    cs = np.array([0.0, 1.5, 6.0])
    x = polya_gamma_int(torch.Generator(device=dev).manual_seed(2), b,
                        _cuda(np.repeat(cs[:, None], S, axis=1), dev, torch.float64))
    mean, var = _pg_moments(cs)
    assert np.all(np.abs(x.cpu().numpy().mean(1) - b * mean) < 4 * np.sqrt(b * var / S))


def test_test_pgbinary_makes_no_host_read_on_the_card(dev):
    """A whole PG chain on the card draws on the kernel alone: no host sync
    (``host_syncs`` unchanged, and none that the sync debug mode reports),
    no host round of the loop, one draw and one launch a sweep."""
    import warnings

    from flgp_tpu_torch.inference import pg_gibbs
    from flgp_tpu_torch.utils import metrics

    C, Cnv, Y = _pg_problem(dev)
    pg_gibbs.test_pgbinary(torch.Generator(device=dev).manual_seed(0), C, Y, Cnv, n_sweeps=3,
                           avg_sweeps=2)             # the build and the first launches
    torch.cuda.synchronize()
    names = ("host_syncs", "pg_rounds", "pg_draws", "kernel_launches:polya_gamma")
    before = {k: metrics.COUNTS[k] for k in names}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            labels, pi = pg_gibbs.test_pgbinary(torch.Generator(device=dev).manual_seed(1), C, Y,
                                                Cnv, n_sweeps=20, avg_sweeps=10)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)
    counted = {k: metrics.COUNTS[k] - before[k] for k in names}
    assert syncs == 0
    assert counted == {"host_syncs": 0, "pg_rounds": 0, "pg_draws": 20,
                       "kernel_launches:polya_gamma": 20}
    assert bool(torch.all(torch.isfinite(pi))) and labels.shape == (Cnv.shape[0],)


def test_polya_gamma_kernel_refuses_what_it_does_not_take(dev):
    """No fallback: the wrong dtype, layout, device or key raises, and so does
    a half-precision draw on the card; the same key gives the same bits,
    another offset other draws; no lanes, no launch."""
    from flgp_tpu_torch.ops import hopper_kernels as hk
    from flgp_tpu_torch.ops import polya_gamma as pg

    z = torch.full((1000,), 0.5, dtype=torch.float64, device=dev)
    key = torch.tensor([12345, 678], dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        hk.polya_gamma(z.half(), key)
    with pytest.raises(TypeError):
        hk.polya_gamma(z, key.int())
    with pytest.raises(ValueError):
        hk.polya_gamma(z, key[:1])
    with pytest.raises(ValueError):
        hk.polya_gamma(z, key.cpu())
    with pytest.raises(ValueError):
        hk.polya_gamma(z[::2], key)
    with pytest.raises(ValueError):
        hk.polya_gamma(z.cpu(), key.cpu())
    with pytest.raises(TypeError, match="float32 or float64"):   # a draw on the card: no loop
        pg.polya_gamma(torch.Generator(device=dev).manual_seed(0), z.half())
    a = hk.polya_gamma(z, key)
    assert torch.equal(a, hk.polya_gamma(z, key))
    assert not torch.equal(a, hk.polya_gamma(z, key + torch.tensor([0, 1], device=dev)))
    before = hk.LAUNCHES["polya_gamma"]
    assert hk.polya_gamma(z[:0], key).shape == (0,)
    assert hk.LAUNCHES["polya_gamma"] == before            # nothing launched, nothing counted
