"""K9 ``ell_matmat``: the plain version against the TPU kernel in interpret
mode, and ``EllMatrix.matmat``/``rmatmat`` against the JAX methods.

The CUDA kernel itself has no interpret mode; it is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).  Float32
cases use rtol = atol = 1e-5 (the tolerance of the JAX package's own test of
the TPU kernel: two summation orders over r terms); float64 cases 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu.ops import pallas_kernels as pk
from flgp_tpu.types import EllMatrix as JEllMatrix

from flgp_tpu_torch.ops import hopper_kernels as hk
from flgp_tpu_torch.types import EllMatrix

torch.set_num_threads(1)


def _graph(rng, n, s, r, duplicates):
    vals = rng.uniform(-1.0, 1.0, size=(n, r)).astype(np.float32)
    idx = rng.integers(0, s, size=(n, r)).astype(np.int32)
    if duplicates and r > 1:
        idx[::3, 1] = idx[::3, 0]            # a repeated column in every third row
    return vals, idx


@pytest.mark.parametrize("r", [1, 3, 8, 48])
@pytest.mark.parametrize("square", [False, True], ids=["s!=n", "s=n"])
def test_plain_version_matches_tpu_kernel_interpret(rng, r, square):
    """n = 300 is not a multiple of the TPU block (128 here), so the Pallas
    wrapper pads; duplicate indices within a row add."""
    n, K = 300, 40
    s = n if square else 64
    vals, idx = _graph(rng, n, s, r, duplicates=True)
    W = rng.normal(size=(s, K)).astype(np.float32)
    before = dict(hk.LAUNCHES)
    got = hk.ell_matmat(torch.as_tensor(vals), torch.as_tensor(idx), torch.as_tensor(W))
    assert hk.LAUNCHES == before                      # CPU tensors: no kernel launch counted
    ref = pk.ell_matmat(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(W), block=128,
                        interpret=True)
    assert got.shape == (n, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    dense = np.zeros((n, s))
    np.add.at(dense, (np.arange(n)[:, None], idx), vals)
    np.testing.assert_allclose(got.numpy(), dense @ W, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [2, 5])
def test_ellmatrix_matmat_and_rmatmat_match_reference_f64(rng, r):
    n, s, K = 150, 37, 9
    vals, idx = _graph(rng, n, s, r, duplicates=True)
    vals = vals.astype(np.float64)
    W, M = rng.normal(size=(s, K)), rng.normal(size=(n, K))
    Zt = EllMatrix(torch.as_tensor(vals), torch.as_tensor(idx), s)
    Zj = JEllMatrix(jnp.asarray(vals), jnp.asarray(idx), s)
    np.testing.assert_allclose(Zt.matmat(torch.as_tensor(W)).numpy(),
                               np.asarray(Zj.matmat(jnp.asarray(W))), rtol=1e-12, atol=1e-12)
    for block in (4096, 32):                          # one block, and ragged row blocks
        np.testing.assert_allclose(Zt.rmatmat(torch.as_tensor(M), block=block).numpy(),
                                   np.asarray(Zj.rmatmat(jnp.asarray(M))), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(Zt.matmat_plain(torch.as_tensor(W), block=block).numpy(),
                                   np.asarray(Zj.matmat(jnp.asarray(W))), rtol=1e-12,
                                   atol=1e-12)
