"""flgp_tpu_torch graph-stage ops against flgp_tpu on the same inputs.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them; the port's kernel wrappers take their plain versions for CPU tensors.
Tolerances: float64 comparisons are exact up to summation order (1e-10 to
1e-12); float32 ones follow tests/test_pallas.py (2e-5 for the ELL tail,
2e-4 for the 150-step FISTA loop).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.config import LaplacianType as JLaplacian
from flgp_tpu.ops import kmeans as jkmeans
from flgp_tpu.ops import pallas_kernels as pk
from flgp_tpu.ops.knn import knn_xla
from flgp_tpu.ops.lae import lae_weights_xla
from flgp_tpu.ops.lae import project_simplex as jproject_simplex
from flgp_tpu.ops.spectrum import spectrum_fused as jspectrum_fused
from flgp_tpu.types import EllMatrix as JEll

from flgp_tpu_torch.config import EPS, LaplacianType
from flgp_tpu_torch.ops import _build
from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.ops import kmeans
from flgp_tpu_torch.ops.knn import knn, knn_plain
from flgp_tpu_torch.ops.lae import (fista_momentum, lae_weights, lae_weights_plain,
                                    lae_weights_t, project_simplex)
from flgp_tpu_torch.ops.spectrum import spectrum_fused
from flgp_tpu_torch.types import EllMatrix

import kmeans_parent

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ell(rng, n=70, s=24, r=4):
    """Random ELL graph; with s small against n·r, rows repeat columns."""
    vals = rng.uniform(0.1, 1.0, size=(n, r))
    idx = rng.integers(0, s, size=(n, r)).astype(np.int32)
    return vals, idx, s


def _points(rng, n, s, d, dup_anchor=True):
    X = rng.normal(size=(n, d))
    U = rng.normal(size=(s, d))
    if dup_anchor:
        U[7] = U[3]      # an exact tie: the lower index must win
    return X, U


# ---------------------------------------------------------------------------
# EllMatrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "op", ["rowsum", "colsum", "scale_rows", "scale_cols", "matvec", "rmatvec", "to_dense",
           "matmat", "gram"],
)
def test_ell_matrix_ops_match_reference_f64(rng, op):
    vals, idx, s = _ell(rng)
    n = vals.shape[0]
    assert any(len(set(row)) < len(row) for row in idx)   # duplicates exercised
    Zt, Zj = EllMatrix(T(vals), T(idx, torch.int32), s), JEll(jnp.asarray(vals), jnp.asarray(idx), s)
    v_s, v_n, W = rng.normal(size=s), rng.normal(size=n), rng.normal(size=(s, 5))
    calls = {
        "rowsum": (lambda Z: Z.rowsum(), lambda Z: Z.rowsum()),
        "colsum": (lambda Z: Z.colsum(), lambda Z: Z.colsum()),
        "scale_rows": (lambda Z: Z.scale_rows(T(v_n)).values,
                       lambda Z: Z.scale_rows(jnp.asarray(v_n)).values),
        "scale_cols": (lambda Z: Z.scale_cols(T(v_s)).values,
                       lambda Z: Z.scale_cols(jnp.asarray(v_s)).values),
        "matvec": (lambda Z: Z.matvec(T(v_s)), lambda Z: Z.matvec(jnp.asarray(v_s))),
        "rmatvec": (lambda Z: Z.rmatvec(T(v_n)), lambda Z: Z.rmatvec(jnp.asarray(v_n))),
        "to_dense": (lambda Z: Z.to_dense(), lambda Z: Z.to_dense()),
        # small blocks exercise the row blocking and its ragged last block
        "matmat": (lambda Z: Z.matmat(T(W), block=16), lambda Z: Z.matmat(jnp.asarray(W), block=16)),
        "gram": (lambda Z: Z.gram(block=16), lambda Z: Z.gram(block=16)),
    }
    ft_, fj = calls[op]
    np.testing.assert_allclose(ft_(Zt).numpy(), np.asarray(fj(Zj)), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K1 kNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 3, 6, 24, 40])
def test_knn_f64_matches_knn_xla(rng, r):
    X, U = _points(rng, 200, 40, 3)               # r = 40 is r = s
    got = knn(T(X), T(U), r, block=64)            # f64: the plain version, blocked
    ref = knn_xla(jnp.asarray(X), jnp.asarray(U), r)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.sqdists.numpy(), np.asarray(ref.sqdists), rtol=1e-12, atol=1e-12)
    assert got.indices.dtype == torch.int32
    # the tied anchors 3 and 7: 7 is never chosen before 3
    rows = got.indices.numpy()
    for row in rows:
        if 7 in row:
            assert 3 in row and list(row).index(3) < list(row).index(7)


@pytest.mark.parametrize("n,s,r", [(96, 40, 3), (50, 16, 2), (96, 40, 24), (64, 64, 64)])
def test_knn_f32_matches_pallas_interpret(rng, n, s, r):
    """The port's float32 kNN against the TPU kernel in interpret mode, whose
    r masked row-min passes take any r ≤ s (its r ≤ 16 is only the
    reference's dispatch): r = 24 and r = s as well."""
    X, U = _points(rng, n, s, 5)
    got = knn(T(X, torch.float32), T(U, torch.float32), r)
    ref = pk.fused_knn(jnp.asarray(X, jnp.float32), jnp.asarray(U, jnp.float32), r, block=32,
                       interpret=True)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.sqdists.numpy(), np.asarray(ref.sqdists), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", [1, 3, 16, 24])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 17, 64, 256])
def test_knn_matches_reference_over_widths(rng, d, r):
    """``knn`` and ``knn_plain`` against the reference's plain path on the
    CPU at the widths the kernel has a body for (2 and 3 as template
    parameters, every other through the tiled one: 16, 64 and 256 are one,
    four and sixteen of its feature slabs), at the ends of the templated
    bodies' fan-in range and above it (r = 24, the run-time-r body).  float64: the same indices, d² to 1e-12.  float32 through
    the wrapper (its plain version on the CPU): the same indices as the
    float32 reference, d² to 1e-4.  Anchors 3 and 7 coincide, and so do 11 and
    5: the lower index always comes first."""
    X, U = _points(rng, 120, 40, d)
    U[11] = U[5]
    ref = knn_xla(jnp.asarray(X), jnp.asarray(U), r)
    for got in (knn(T(X), T(U), r), knn_plain(T(X), T(U), r, block=50)):
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
        np.testing.assert_allclose(got.sqdists.numpy(), np.asarray(ref.sqdists), rtol=1e-12,
                                   atol=1e-12)
    ref32 = knn_xla(jnp.asarray(X, jnp.float32), jnp.asarray(U, jnp.float32), r)
    got32 = hk.knn(T(X, torch.float32), T(U, torch.float32), r)
    assert got32.indices.dtype == torch.int32 and got32.sqdists.dtype == torch.float32
    np.testing.assert_array_equal(got32.indices.numpy(), np.asarray(ref32.indices))
    np.testing.assert_allclose(got32.sqdists.numpy(), np.asarray(ref32.sqdists), rtol=1e-4,
                               atol=1e-4)
    for lo, hi in ((3, 7), (5, 11)):
        for row in got32.indices.tolist():
            if hi in row:
                assert lo in row and row.index(lo) < row.index(hi)
            if r >= 2:
                assert (lo in row) == (hi in row) or row[-1] == lo


@pytest.mark.parametrize("n,s,split", [
    (70_000, 600, 1),          # the multiclass shape: 1094 row blocks fill the card
    (16_384, 600, 1),          # one streamed chunk: 256 row blocks
    (5000, 500, 1),            # the grid drivers: 79 row blocks, two splits would be 158
    (3000, 700, 2),            # the anchor-split shape: 47 row blocks, 6 anchor tiles
    (3001, 601, 2),            # ragged: 47 row blocks, 5 tiles
    (1000, 100_000, 8),        # few rows, many anchors: 16 row blocks
    (64, 128, 1),              # one row block, one tile: nothing to divide
    (65, 129, 2),              # ragged: two row blocks, two tiles, one a block
    (1, 1, 1),
    (10, 10_000_000, 32),      # the cap
])
def test_knn_anchor_split_fills_one_block_an_sm(n, s, split):
    """K1's tiled body divides a row block's anchor tiles among ``split``
    blocks (a power of two up to 32) only while the grid stays within one
    block an SM of the H100 and every block keeps a tile of 128 anchors;
    rows come 64 to a block, ragged edges rounded up."""
    got = hk.knn_anchor_split(n, s)
    assert got == split
    blocks, tiles = -(-n // 64), -(-s // 128)
    assert got & (got - 1) == 0 and 1 <= got <= 32
    assert got == 1 or (blocks * got <= 132 and tiles >= got)
    assert got == 32 or 2 * got * blocks > 132 or tiles < 2 * got


def test_sqdist_blocked_matches_reference(rng):
    from flgp_tpu.ops.distance import sqdist_blocked as jsqdist_blocked
    from flgp_tpu_torch.ops.distance import sqdist_blocked

    X, U = _points(rng, 100, 12, 3, dup_anchor=False)
    got = sqdist_blocked(T(X), T(U), block=32)      # four blocks, the last one ragged
    ref = jsqdist_blocked(jnp.asarray(X), jnp.asarray(U), block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_knn_rejects_r_above_s(rng):
    X, U = _points(rng, 10, 4, 2, dup_anchor=False)
    with pytest.raises(ValueError):
        knn_plain(T(X), T(U), 5)


# ---------------------------------------------------------------------------
# K2 LAE weights
# ---------------------------------------------------------------------------


def test_project_simplex_matches_reference(rng):
    v = rng.normal(size=(500, 5)) * 2.0
    got = project_simplex(T(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jproject_simplex(jnp.asarray(v))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize("r", [3, 4])
def test_lae_f64_matches_lae_weights_xla(rng, r):
    X, U = _points(rng, 300, 32, 3, dup_anchor=False)
    idx = knn_plain(T(X), T(U), r).indices
    got = lae_weights(T(X), T(U), idx, iters=150)
    ref = lae_weights_xla(jnp.asarray(X), jnp.asarray(U), jnp.asarray(idx.numpy()), iters=150)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,d,s,r,iters", [(700, 3, 64, 3, 150), (300, 4, 32, 4, 100),
                                            (256, 3, 64, 24, 150)])
def test_lae_f32_matches_pallas_interpret(rng, n, d, s, r, iters):
    X, U = _points(rng, n, s, d, dup_anchor=False)
    X32, U32 = T(X, torch.float32), T(U, torch.float32)
    idx = knn(X32, U32, r).indices
    got = lae_weights(X32, U32, idx, iters=iters).numpy()
    ref = pk.fused_lae(jnp.asarray(X, jnp.float32), jnp.asarray(U, jnp.float32),
                       jnp.asarray(idx.numpy()), iters=iters, block=256, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    assert got.min() >= 0.0


@pytest.mark.parametrize("iters", [1, 100, 150])
def test_lae_momentum_table_is_the_plain_versions_sequence(rng, iters):
    """The table K2's wrapper hands the kernel equals, element for element,
    the momentum factors of ``lae_weights_plain``'s recurrence in float32,
    and FISTA driven by the table gives that function's weights bit for bit."""
    table = hk._momentum_table(iters, torch.device("cpu"))
    assert table.dtype == torch.float32 and table.shape == (iters,)
    assert hk._momentum_table(iters, torch.device("cpu")) is table       # built once
    d_prev, d_curr = np.float32(0.0), np.float32(1.0)
    for it in range(iters):
        assert table[it].item() == float(np.float32((d_prev - 1) / d_curr))
        d_prev, d_curr = d_curr, (1 + np.sqrt(1 + 4 * d_curr * d_curr)) / 2
        assert d_curr.dtype == np.float32
    np.testing.assert_array_equal(table.numpy(), fista_momentum(iters))

    X, U = _points(rng, 200, 24, 2, dup_anchor=False)
    X32, U32 = T(X, torch.float32), T(U, torch.float32)
    idx = knn(X32, U32, 3).indices
    Ui = U32[idx.long()]
    G = Ui[:, :, None, 0] * Ui[:, None, :, 0] + Ui[:, :, None, 1] * Ui[:, None, :, 1]
    b = X32[:, None, 0] * Ui[:, :, 0] + X32[:, None, 1] * Ui[:, :, 1]
    absG = torch.abs(G)
    inv_L = (1.0 / (torch.amax(absG[:, :, 0] + absG[:, :, 1] + absG[:, :, 2], dim=1)
                    + 1e-12))[:, None]
    z_prev = z = torch.full_like(b, 1.0 / 3)
    for it in range(iters):
        v = z + table[it] * (z - z_prev)
        grad = v[:, 0:1] * G[:, 0, :] + v[:, 1:2] * G[:, 1, :] + v[:, 2:3] * G[:, 2, :]
        z_prev, z = z, project_simplex(v - inv_L * (grad - b))
    assert torch.equal(z, lae_weights_plain(X32, U32, idx, iters))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c", [(700, 256), (512, 256), (90, 128)])
def test_lae_feature_major_plain_equals_point_major_plain(rng, n, c, dtype):
    """K2's feature-major entry on the CPU (its plain version): the weights
    of ``lae_weights_plain`` on the same points, bit for bit, laid out
    (nch, r, c), and exact zeros on the pad points past n."""
    X, U = _points(rng, n, 32, 3, dup_anchor=False)
    Xp, Up = T(X, dtype), T(U, dtype)
    r = 4
    idx = knn_plain(Xp, Up, r).indices
    nch = -(-n // c)
    padded = torch.zeros((nch * c, r), dtype=torch.int32)
    padded[:n] = idx
    idx_t = padded.view(nch, c, r).transpose(1, 2).contiguous()
    for fn in (lae_weights_t, hk.lae_weights_t_plain):
        got = fn(Xp.T.contiguous(), Up, idx_t, 60)
        assert got.shape == (nch, r, c) and got.dtype == dtype
        flat = got.transpose(1, 2).reshape(nch * c, r)
        assert torch.equal(flat[:n], lae_weights_plain(Xp, Up, idx, 60))
        assert torch.equal(flat[n:], torch.zeros((nch * c - n, r), dtype=dtype))


# ---------------------------------------------------------------------------
# K3–K5: the ELL tail's plain versions
# ---------------------------------------------------------------------------


def _graph32(rng, n=450, d=3, s=48, r=3):
    X, U = _points(rng, n, s, d, dup_anchor=False)
    idx = knn_plain(T(X), T(U), r).indices.numpy()
    w = rng.uniform(0.1, 1.0, size=(n, r)).astype(np.float32)
    cs = rng.uniform(0.5, 2.0, size=(s,)).astype(np.float32)
    return w, idx, cs, s


@pytest.mark.parametrize("r", [3, 24])
def test_ell_colsum_plain_matches_pallas(rng, r):
    w, idx, _, s = _graph32(rng, r=r)
    got = hk.ell_colsum(T(w, torch.float32), T(idx, torch.int32), s)
    ref = pk.ell_colsum(jnp.asarray(w), jnp.asarray(idx), s, block=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("r", [3, 24])
def test_ell_norm_gram_plain_matches_pallas(rng, r):
    w, idx, cs, s = _graph32(rng, r=r)
    G, D = hk.ell_norm_gram(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32))
    Gr, Dr = pk.ell_norm_gram(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(cs), block=128,
                              interpret=True)
    np.testing.assert_allclose(G.numpy(), np.asarray(Gr), atol=2e-5)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dr), atol=2e-5)


@pytest.mark.parametrize("r", [3, 24])
def test_ell_norm_matmat_plain_matches_pallas(rng, r):
    w, idx, cs, s = _graph32(rng, r=r)
    W = rng.normal(size=(s, 8)).astype(np.float32)
    got = hk.ell_norm_matmat(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32),
                             T(W, torch.float32))
    ref = pk.ell_norm_matmat(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(cs), jnp.asarray(W),
                             block=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_ell_tail_plain_versions_match_composition_f64(rng):
    vals, idx, s = _ell(rng)
    cs = rng.uniform(0.5, 2.0, size=(s,))
    W = rng.normal(size=(s, 6))
    Zj = JEll(jnp.asarray(vals), jnp.asarray(idx), s).scale_cols(jnp.asarray(cs))
    Znj = Zj.scale_rows(1.0 / (Zj.rowsum() + EPS))
    v, i = T(vals), T(idx, torch.int32)
    np.testing.assert_allclose(hk.ell_colsum_plain(v, i, s).numpy(),
                               np.asarray(JEll(jnp.asarray(vals), jnp.asarray(idx), s).colsum()),
                               rtol=1e-12, atol=1e-12)
    G, D = hk.ell_norm_gram_plain(v, i, T(cs))
    np.testing.assert_allclose(G.numpy(), np.asarray(Znj.gram()), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(D.numpy(), np.asarray(Znj.colsum()), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(hk.ell_norm_matmat_plain(v, i, T(cs), T(W)).numpy(),
                               np.asarray(Znj.matmat(jnp.asarray(W))), rtol=1e-12, atol=1e-12)


def test_wrappers_take_plain_version_on_cpu_without_counting(rng):
    w, idx, cs, s = _graph32(rng, n=60, s=12)
    X, U = _points(rng, 60, 12, 2, dup_anchor=False)
    hk.reset_launches()
    X32, U32 = T(X, torch.float32), T(U, torch.float32)
    res = hk.knn(X32, U32, 3)
    hk.lae_weights(X32, U32, res.indices)
    hk.ell_colsum(T(w, torch.float32), T(idx, torch.int32), s)
    hk.ell_norm_gram(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32))
    hk.ell_norm_matmat(T(w, torch.float32), T(idx, torch.int32), T(cs, torch.float32),
                       torch.ones((s, 2)))
    wt, it = T(w.T[None], torch.float32), T(idx.T[None], torch.int32)   # (1, r, n) chunked
    hk.ell_colsum_t(wt, it, s)
    hk.ell_norm_gram_t(wt, it, T(cs, torch.float32))
    hk.ell_norm_matmat_t(wt, it, T(cs, torch.float32), torch.ones((s, 2)))
    hk.ell_matmat(T(w, torch.float32), T(idx, torch.int32), torch.ones((s, 2)))
    n = w.shape[0]
    self_idx = T(idx, torch.int32) % n                               # an (n, r) graph on n points
    tr = EllMatrix(T(w, torch.float32), self_idx, n).transpose_structure()
    hk.ell_sym_matmat(T(w, torch.float32), self_idx, tr.ptr, tr.src,
                      T(w, torch.float32).reshape(-1)[tr.perm], torch.ones((n, 2)))
    assert all(v == 0 for v in hk.LAUNCHES.values())
    assert set(hk.LAUNCHES) == {"knn", "lae_weights", "ell_colsum", "ell_norm_gram",
                                "ell_norm_matmat", "ell_colsum_t", "ell_norm_gram_t",
                                "ell_norm_matmat_t", "ell_matmat", "ell_sym_matmat", "polya_gamma",
                                "weighted_kmeanspp"}


# F9: the call sites of K1–K8 route every float32 graph to the kernels'
# wrappers at every r (here r = 24, above the templated bodies' 16); float64
# reaches none of them and takes the plain kNN, as the reference's x64 gate
# takes its XLA product.  The point-major, chunked, sharded and GLGP graphs
# reach K1 (``hk.knn``) in float32 and ``knn_plain`` only in float64.
ROUTES = {
    "lae_weights": {"lae_weights"},
    "lae_weights_t": {"lae_weights_t"},
    "spectrum_fused": {"ell_colsum", "ell_norm_gram", "ell_norm_matmat"},
    "build_spectrum": {"knn", "lae_weights", "ell_colsum", "ell_norm_gram", "ell_norm_matmat"},
    "heat_kernel_spectrum_colmajor": {"knn", "lae_weights_t", "ell_colsum_t", "ell_norm_gram_t",
                                      "ell_norm_matmat_t"},
    "sharded_spectrum": {"knn", "lae_weights", "ell_colsum_partial", "ell_norm_gram_partial",
                         "ell_norm_matmat"},
    "gl_setup": {"knn"},
}


@pytest.mark.parametrize("site", sorted(ROUTES))
def test_float32_graphs_reach_the_kernels_at_every_r(rng, monkeypatch, site):
    from flgp_tpu_torch.config import GraphConfig, KernelType
    from flgp_tpu_torch.fit.spectral import build_spectrum, gl_setup
    from flgp_tpu_torch.ops import colmajor as col
    from flgp_tpu_torch.ops.kmeans import SubsampleResult
    from flgp_tpu_torch.ops import knn as knn_mod
    from flgp_tpu_torch.ops import lae as lae_mod
    from flgp_tpu_torch.parallel.mesh import Mesh
    from flgp_tpu_torch.parallel.spectral import sharded_spectrum_fn

    calls = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for name in ("knn", "lae_weights", "lae_weights_t", "ell_colsum", "ell_colsum_partial",
                 "ell_norm_gram", "ell_norm_gram_partial", "ell_norm_matmat", "ell_colsum_t",
                 "ell_norm_gram_t", "ell_norm_matmat_t"):
        monkeypatch.setattr(hk, name, recorded(name, getattr(hk, name)))
    monkeypatch.setattr(knn_mod, "knn_plain", recorded("knn_plain", knn_mod.knn_plain))

    n, s, r, K = 200, 40, 24, 6
    X, U = _points(rng, n, s, 3, dup_anchor=False)
    counts = rng.integers(1, 20, size=(s,)).astype(np.float64)
    cn = LaplacianType.CLUSTER_NORMALIZED
    for dtype in (torch.float32, torch.float64):
        Xp, Up, cp = T(X, dtype), T(U, dtype), T(counts, dtype)
        idx = knn_plain(Xp, Up, r).indices
        w = lae_weights_plain(Xp, Up, idx, 20)
        calls.clear()
        if site == "lae_weights":
            out = lae_mod.lae_weights(Xp, Up, idx, iters=20)
        elif site == "lae_weights_t":
            out = lae_mod.lae_weights_t(Xp.T.contiguous(), Up, idx.T.contiguous()[None], 20)
        elif site == "spectrum_fused":
            out = spectrum_fused(w, idx, s, K, cn, True, cp).vectors
        elif site == "build_spectrum":
            g = GraphConfig(s=s, r=r, K=K, gl=cn, kernel=KernelType.LAE)
            out = build_spectrum(torch.Generator(), Xp, g, anchors=SubsampleResult(Up, cp))[0].vectors
        elif site == "gl_setup":
            out = gl_setup(Xp, True, r / n).sq_dists          # the self-kNN at r = 24
        elif site == "heat_kernel_spectrum_colmajor":
            out = col.heat_kernel_spectrum_colmajor(Xp.T.contiguous(), Up, r, K, cn, True,
                                                    cluster_sizes=cp, lae_iters=20,
                                                    chunk=128).vectors
        else:
            g = GraphConfig(s=s, r=r, K=K, gl=cn, kernel=KernelType.LAE)
            out = sharded_spectrum_fn(Mesh(None, "data", 0, 1, torch.device("cpu")), g)(
                Xp, Up, cp)[1]
        assert out.dtype == dtype and bool(torch.all(torch.isfinite(out)))
        kernels = set(calls) - {"knn_plain"}
        if dtype == torch.float32:
            assert kernels == ROUTES[site], calls
        else:
            assert kernels == set(), calls
        if "knn" in ROUTES[site]:
            # K1 above r = 16 in float32; the plain kNN only in float64
            assert ("knn_plain" in calls) == (dtype == torch.float64), calls


# ---------------------------------------------------------------------------
# spectrum
# ---------------------------------------------------------------------------


def _heat_block(values, vectors, t=1.0):
    """V·diag(exp(−t(1−λ)))·Vᵀ: blind to the sign and rotation of vectors."""
    w = np.exp(-t * (1.0 - values))
    return (vectors * w) @ vectors.T


@pytest.mark.parametrize("r", [3, 24])
@pytest.mark.parametrize("gl", ["rw", "normalized", "cluster-normalized"])
def test_spectrum_fused_f64_matches_reference(rng, gl, r):
    n, d, s = 300, 3, 32
    X, U = _points(rng, n, s, d, dup_anchor=False)
    idx = knn_plain(T(X), T(U), r).indices.numpy()
    w = rng.uniform(0.1, 1.0, size=(n, r))
    counts = rng.integers(1, 20, size=(s,)).astype(np.float64)
    got = spectrum_fused(T(w), T(idx, torch.int32), s, s, LaplacianType(gl), True, T(counts))
    ref = jspectrum_fused(jnp.asarray(w), jnp.asarray(idx), s, s, JLaplacian(gl), True,
                          jnp.asarray(counts))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_heat_block(got.values.numpy(), got.vectors.numpy()),
                               _heat_block(np.asarray(ref.values), np.asarray(ref.vectors)),
                               rtol=0, atol=1e-8)


def test_spectrum_fused_f32_tail_matches_f64_composition(rng):
    """The f32 path's reassociated algebra (K3–K5 plain versions) against the
    f64 composition of the reference."""
    n, d, s, r, K = 400, 3, 40, 3, 8
    X, U = _points(rng, n, s, d, dup_anchor=False)
    idx = knn_plain(T(X), T(U), r).indices.numpy()
    w = rng.uniform(0.1, 1.0, size=(n, r))
    counts = rng.integers(1, 20, size=(s,)).astype(np.float64)
    got = spectrum_fused(T(w, torch.float32), T(idx, torch.int32), s, K,
                         LaplacianType.CLUSTER_NORMALIZED, True, T(counts, torch.float32))
    ref = jspectrum_fused(jnp.asarray(w), jnp.asarray(idx), s, K, JLaplacian.CLUSTER_NORMALIZED,
                          True, jnp.asarray(counts))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values), atol=1e-5)
    Vr, Vg = np.asarray(ref.vectors), got.vectors.numpy()
    signs = np.sign(np.sum(Vr * Vg, axis=0))
    np.testing.assert_allclose(Vg * signs, Vr, atol=5e-3)


def test_spectrum_cluster_normalized_needs_sizes(rng):
    w, idx, _, s = _graph32(rng, n=40, s=8)
    with pytest.raises(ValueError):
        spectrum_fused(T(w, torch.float32), T(idx, torch.int32), s, 4,
                       LaplacianType.CLUSTER_NORMALIZED, True, None)


# ---------------------------------------------------------------------------
# subsampling
# ---------------------------------------------------------------------------


def _blobs(rng, n=600, d=2, k=6):
    centers = rng.normal(scale=4.0, size=(k, d))
    return centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))


def test_lloyd_from_same_init_matches_reference(rng):
    X = _blobs(rng)
    init = X[rng.choice(X.shape[0], 20, replace=False)]
    c, counts, wss = kmeans.lloyd(T(X), T(init), 100)
    cj, countsj, wssj = jkmeans.lloyd(jnp.asarray(X), jnp.asarray(init), 100)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(countsj))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(wss), float(wssj), rtol=1e-10)


def _inertia(X, centers):
    return float(np.min(((X[:, None, :] - centers[None]) ** 2).sum(-1), axis=1).sum())


def test_kmeans_subsample_inertia_in_reference_band(rng):
    """Seeding is random and the two RNG streams differ: compare by
    distribution.  Over 5 seeds each, the port's k-means‖ + Lloyd inertia
    lies within the band the reference spans (widened by 10%)."""
    import jax

    X = _blobs(rng, n=1200)
    s = 64                                        # n ≥ 4s and s ≥ 64: k-means‖ seeding
    jsub = jax.jit(lambda key: jkmeans.subsample(key, jnp.asarray(X), s).centers)
    ref = [_inertia(X, np.asarray(jsub(jax.random.PRNGKey(k)))) for k in range(5)]
    for seed in range(5):
        sub = kmeans.subsample(torch.Generator().manual_seed(seed), T(X), s)
        assert float(sub.counts.sum()) == X.shape[0]
        assert sub.centers.shape == (s, 2)
        assert 0.9 * min(ref) <= _inertia(X, sub.centers.numpy()) <= 1.1 * max(ref)


@pytest.mark.parametrize("method", ["random", "minibatchkmeans", "kmeans"])
def test_subsample_methods_count_every_point(rng, method):
    X = _blobs(rng, n=300)
    # n < 4s: "kmeans" seeds with k-means++ here
    sub = kmeans.subsample(torch.Generator().manual_seed(1), T(X), 80, method=method, iters=20)
    assert float(sub.counts.sum()) == X.shape[0]
    assert sub.centers.shape == (80, 2)


def _seed_inputs(rng, C, dtype):
    """Candidates with weights (their 1-NN masses: whole numbers, zeros and
    ties among them) and their clamped squared distances."""
    cands = T(rng.normal(size=(C, 3)), dtype)
    w = T(rng.integers(0, 5, size=C), dtype)
    return w, torch.clamp(torch.sum((cands[:, None] - cands[None]) ** 2, dim=-1), min=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,C", [(64, 129), (600, 1201)])
def test_gumbel_rows_are_the_per_step_draws_bit_for_bit(dtype, s, C):
    """Row k of the noise drawn up front is the k-th per-step ``_gumbel``
    draw, bit for bit, and the generator ends where the per-step draws leave
    it."""
    like = torch.empty(0, dtype=dtype)
    g_step, g_rows = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    steps = torch.stack([kmeans._gumbel(g_step, C, like) for _ in range(s - 1)])
    rows = kmeans._gumbel_rows(g_rows, s - 1, C, like)
    assert rows.shape == (s - 1, C) and rows.dtype == dtype
    assert torch.equal(rows, steps)
    assert torch.equal(g_rows.get_state(), g_step.get_state())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,C", [(37, 75), (64, 129), (600, 1201)])
def test_weighted_kmeanspp_plain_picks_the_parent_loop_s(rng, dtype, s, C):
    w, dcc = _seed_inputs(rng, C, dtype)
    parent = kmeans_parent.weighted_kmeanspp(torch.Generator().manual_seed(5), dcc, w, s)
    g = torch.Generator().manual_seed(5)
    picks = kmeans._weighted_kmeanspp_plain(dcc, w, kmeans._gumbel_rows(g, s - 1, C, w))
    assert picks.dtype == torch.int64 and picks.shape == (s,)
    assert torch.equal(picks, parent)
    assert len(set(picks.tolist())) == s          # no candidate picked twice


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kmeanspar_rows_gives_the_parent_s_centers_bit_for_bit(rng, dtype):
    X = T(_blobs(rng, n=2000), dtype)
    got = kmeans._kmeanspar_rows(torch.Generator().manual_seed(4), X, 96)
    ref = kmeans_parent.kmeanspar_rows(torch.Generator().manual_seed(4), X, 96)
    assert got.shape == (96, 2) and torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the kernel build
# ---------------------------------------------------------------------------


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.sources():
        (src / p.name).write_bytes(p.read_bytes())
    assert {p.name for p in _build.sources()} >= {"knn.cu", "lae.cu", "ell.cu", "common.cuh"}
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = _build.library_path()
    (src / "ell.cu").write_text((src / "ell.cu").read_text() + "\n// edited\n")
    assert _build.library_path() != before
    assert before.parent.parent == _build.BUILD_ROOT


# ---------------------------------------------------------------------------
# the package stands alone
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_flgp_tpu():
    offenders = []
    paths = sorted((REPO / "flgp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in paths + sorted((REPO / "benchmark").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "flgp_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


# the public names the port does not have yet: none since the multiclass
# drivers and the extras landed
KNOWN_GAPS = set()


def test_public_names_are_the_reference_s_but_the_known_gaps():
    """The port exports exactly the reference's public names."""
    import flgp_tpu
    import flgp_tpu_torch

    assert set(flgp_tpu.__all__) - set(flgp_tpu_torch.__all__) == KNOWN_GAPS
    assert set(flgp_tpu_torch.__all__) == set(flgp_tpu.__all__)
    assert all(hasattr(flgp_tpu_torch, name) for name in flgp_tpu_torch.__all__)


def test_default_a2s_is_the_reference_grid():
    import flgp_tpu
    import flgp_tpu_torch

    np.testing.assert_allclose(flgp_tpu_torch.default_a2s(), np.asarray(flgp_tpu.default_a2s()),
                               rtol=1e-6)
