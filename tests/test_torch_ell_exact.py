"""The exact column sums of K3 and K6 and the two layouts of the ELL tail's
plain versions, on the CPU.

``hopper_kernels._colsum_fixed_plain`` is the kernels' arithmetic in
PyTorch: every term rounded to a whole number of 2^-24 units, the units
summed exactly, the total rounded to float32 once.  On the card K3 and K6
equal it bit for bit (tests/test_torch_cuda.py).  Here it is held to the
float64 sum within its rounding (2^-25 a term, then half a float32 ulp), to
the TPU kernel in interpret mode within tests/test_pallas.py's float32
tolerance (2e-5), and to itself, bit for bit, under any order of the
entries.  The point-major (n, r) and chunked (nch, r, c) plain versions are
held to each other in float64 (exact up to summation order, 1e-12).  Inputs
are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.ops import pallas_kernels as pk

from flgp_tpu_torch.ops import hopper_kernels as hk

torch.set_num_threads(1)

UNIT = 2.0 ** -24


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _graph(rng, n, r, s):
    """float32 weights of both signs, a zero, a term beyond the fixed-point
    range (|v| >= 128), a repeated anchor in every third row and two indices
    outside [0, s), which add nothing."""
    vals = rng.uniform(0.1, 1.0, size=(n, r)).astype(np.float32)
    vals[1::7, -1] *= -1.0
    vals[3, 0] = 0.0
    vals[4, 0] = 300.0
    idx = rng.integers(0, s, size=(n, r)).astype(np.int32)
    if r > 1:
        idx[::3, 1] = idx[::3, 0]
    idx[5, 0], idx[6, -1] = s, -1
    return vals, idx


def _in_range(vals, idx, s):
    """float64 weights with the out-of-range entries zeroed, indices clipped."""
    ok = (idx >= 0) & (idx < s)
    return np.where(ok, vals, 0.0).astype(np.float64), np.where(ok, idx, 0).astype(np.int32)


def _chunked(a, c):
    """The (nch, r, c) layout of an (n, r) array, zero pads past n."""
    n, r = a.shape
    nch = -(-n // c)
    out = np.zeros((nch * c, r), dtype=a.dtype)
    out[:n] = a
    return np.ascontiguousarray(out.reshape(nch, c, r).transpose(0, 2, 1))


@pytest.mark.parametrize("n,r,s", [(300, 1, 16), (500, 3, 40), (700, 5, 64), (200, 16, 13000)])
def test_colsum_fixed_plain_within_rounding_of_f64(rng, n, r, s):
    vals, idx = _graph(rng, n, r, s)
    got = hk._colsum_fixed_plain(T(vals, torch.float32), T(idx, torch.int32), s)
    assert got.dtype == torch.float32 and got.shape == (s,)
    v64, i64 = _in_range(vals, idx, s)
    ref = hk.ell_colsum_plain(T(v64), T(i64, torch.int32), s).numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=2.0 ** -24, atol=n * r * UNIT / 2)


def test_colsum_fixed_plain_rounds_ties_to_even():
    """Half-unit terms round to the even unit, as ``__float2int_rn`` does:
    0.5 → 0, 1.5 → 2, 2.5 → 2, −2.5 → −2, 3.5 → 4.  Terms of 200 and −200
    are added as they are, exactly, and cancel."""
    vals = np.array([[0.5], [1.5], [2.5], [-2.5], [3.5], [200.0 / UNIT], [-200.0 / UNIT]]) * UNIT
    got = hk._colsum_fixed_plain(T(vals, torch.float32), torch.zeros((7, 1), dtype=torch.int32), 1)
    assert float(got[0]) == 6 * UNIT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colsum_fixed_plain_is_permutation_invariant(seed):
    """Integer sums: any order of the entries gives the same bits, where the
    float32 scatter-add's order shows in its last bits."""
    rng = np.random.default_rng(seed)
    vals, idx = _graph(rng, 4000, 3, 24)
    vals[:, 1] *= np.float32(1e-3)                        # terms of many magnitudes
    ref = hk._colsum_fixed_plain(T(vals, torch.float32), T(idx, torch.int32), 24)
    perm = rng.permutation(vals.size)
    got = hk._colsum_fixed_plain(T(vals.reshape(-1)[perm], torch.float32),
                                 T(idx.reshape(-1)[perm], torch.int32), 24)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("r", [1, 3])
def test_colsum_fixed_plain_matches_pallas_interpret(rng, r):
    n, s = 450, 48
    vals = rng.uniform(0.1, 1.0, size=(n, r)).astype(np.float32)
    idx = rng.integers(0, s, size=(n, r)).astype(np.int32)
    got = hk._colsum_fixed_plain(T(vals, torch.float32), T(idx, torch.int32), s)
    ref = pk.ell_colsum(jnp.asarray(vals), jnp.asarray(idx), s, block=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c", [64, 100])
@pytest.mark.parametrize("r", [1, 3, 5])
def test_point_major_and_chunked_plain_versions_agree(rng, r, c):
    """K3–K5's plain versions on an (n, r) graph and K6–K8's on its chunked
    layout (n not a multiple of c, zero-weight pads) compute the same
    function; the exact column sums are the same bits on both layouts."""
    n, s = 530, 40
    vals, idx = _in_range(*_graph(rng, n, r, s), s)
    vals = np.abs(vals)                                   # rows far from a zero sum
    vals[4, 0] = 0.7
    cs = rng.uniform(0.5, 2.0, size=(s,))
    W = rng.normal(size=(s, 6))
    v, i = T(vals), T(idx, torch.int32)
    vt, it = T(_chunked(vals, c)), T(_chunked(idx, c), torch.int32)
    np.testing.assert_allclose(hk.ell_colsum_t_plain(vt, it, s).numpy(),
                               hk.ell_colsum_plain(v, i, s).numpy(), rtol=1e-12, atol=1e-12)
    G, D = hk.ell_norm_gram_plain(v, i, T(cs))
    Gt, Dt = hk.ell_norm_gram_t_plain(vt, it, T(cs))
    np.testing.assert_allclose(Gt.numpy(), G.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Dt.numpy(), D.numpy(), rtol=1e-12, atol=1e-12)
    out_t = hk.ell_norm_matmat_t_plain(vt, it, T(cs), T(W))
    assert out_t.shape == (it.shape[0] * c, 6)
    np.testing.assert_allclose(out_t[:n].numpy(), hk.ell_norm_matmat_plain(v, i, T(cs), T(W)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(out_t[n:].numpy(), 0.0)
    assert torch.equal(hk._colsum_fixed_plain(vt.float(), it, s),
                       hk._colsum_fixed_plain(v.float(), i, s))
