"""The port's copies of the R-stream modules (``utils/r_rng.py``,
``utils/r_kmeans.py``) and of the exact README datasets
(``datasets.torus_rings_r``, ``spiral_r``, ``spiral_r_anchors``).

They are NumPy and plain Python, copied so that the port imports nothing of
``flgp_tpu``; here they are held to the JAX package's modules bit for bit
(every array equal), and the stream to R's published outputs as the
reference's tests/test_r_rng.py holds it (5e-8, R's printed precision).
"""

import numpy as np
import pytest

from flgp_tpu import datasets as jdatasets
from flgp_tpu.utils import r_kmeans as jr_kmeans
from flgp_tpu.utils import r_rng as jr_rng

from flgp_tpu_torch import datasets
from flgp_tpu_torch.utils import r_kmeans, r_rng


def test_stream_matches_published_r_outputs():
    np.testing.assert_allclose(r_rng.RRng(42).runif(5),
                               [0.9148060, 0.9370754, 0.2861395, 0.8304476, 0.6417455], atol=5e-8)
    np.testing.assert_allclose(r_rng.RRng(42).rnorm(5),
                               [1.3709584, -0.5646982, 0.3631284, 0.6328626, 0.4042683], atol=5e-8)
    np.testing.assert_array_equal(r_rng.RRng(42).sample_int(10, 10),
                                  [1, 5, 10, 8, 2, 4, 6, 9, 7, 3])
    np.testing.assert_allclose(r_rng._qnorm(0.975), 1.959963984540054, atol=1e-12)


@pytest.mark.parametrize("seed", [1, 1234, 2**31 - 1])
def test_stream_is_the_reference_stream(seed):
    a, b = r_rng.RRng(seed), jr_rng.RRng(seed)
    for draw in (lambda r: r.runif(700, -1.0, 3.0), lambda r: r.rnorm(300, 2.0, 0.5),
                 lambda r: r.sample_int(5000, 40), lambda r: np.array([r.unif_index(7)])):
        np.testing.assert_array_equal(draw(a), draw(b))


def test_hartigan_wong_is_the_reference_s():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(c, 0.4, size=(60, 2)) for c in ((0, 0), (3, 1), (-2, 4))])
    got = r_kmeans.r_kmeans(r_rng.RRng(7), X, 9, iter_max=100)
    ref = jr_kmeans.r_kmeans(jr_rng.RRng(7), X, 9, iter_max=100)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    C, ic1, wss, ifault = r_kmeans.hartigan_wong(X, X[:4], iter_max=10)
    for a, b in zip((C, ic1, wss, ifault), jr_kmeans.hartigan_wong(X, X[:4], iter_max=10)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["torus_rings_r", "spiral_r"])
def test_exact_datasets_are_the_reference_arrays(name):
    for a, b in zip(getattr(datasets, name)(), getattr(jdatasets, name)()):
        np.testing.assert_array_equal(a, b)


def test_spiral_r_anchors_are_the_reference_anchors():
    """The anchors of the README's SE and LAE fits, both packages' replays:
    the same centers and sizes bit for bit."""
    got, ref = datasets.spiral_r_anchors(), jdatasets.spiral_r_anchors()
    assert got.keys() == ref.keys() == {"se", "lae"}
    for k in got:
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a, b)
    centers, sizes = got["lae"]
    assert centers.shape == (500, 2) and sizes.sum() == 4000
