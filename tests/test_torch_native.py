"""flgp_tpu_torch.native (the port's copy of the host runtime) against
flgp_tpu.native and the port's plain kernels.

The same FLGP0001 format in both packages: a file written by one opens in
the other with the same array.  The host kNN and LAE are held to the port's
``ops.knn``/``ops.lae`` plain versions, the PG sampler to its mean.
"""

import numpy as np
import pytest
import torch

from flgp_tpu_torch import native

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(0)
    M = (rng.normal(size=(257, 6)) * 10).astype(dtype)
    path = str(tmp_path / "m.flgp")
    native.write_matrix(path, M)
    with native.MatrixFile(path) as f:
        assert f.shape == (257, 6) and f.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(f.read(0, 257), M)
        np.testing.assert_array_equal(f.read(100, 50), M[100:150])
        np.testing.assert_array_equal(f.read(250, 100), M[250:])      # clamped tail
        buf = torch.zeros((64, 6), dtype={np.float32: torch.float32, np.float64: torch.float64,
                                          np.int32: torch.int32}[dtype])
        assert f.read_into(220, 64, buf.data_ptr()) == 37
        np.testing.assert_array_equal(buf[:37].numpy(), M[220:])


def test_files_cross_between_the_packages(tmp_path):
    from flgp_tpu import native as jnative

    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 3)).astype(np.float32)
    B = rng.normal(size=(17, 5))
    native.write_matrix(str(tmp_path / "a.flgp"), A)
    jnative.write_matrix(str(tmp_path / "b.flgp"), B)
    with jnative.MatrixFile(str(tmp_path / "a.flgp")) as f:
        np.testing.assert_array_equal(f.read(0, 40), A)
    with native.MatrixFile(str(tmp_path / "b.flgp")) as f:
        assert f.dtype == np.float64
        np.testing.assert_array_equal(f.read(0, 17), B)
    assert open(tmp_path / "a.flgp", "rb").read(8) == b"FLGP0001"


def test_stream_loader_covers_every_row_once_in_order(tmp_path):
    M = np.random.default_rng(2).normal(size=(1000, 4)).astype(np.float32)
    path = str(tmp_path / "s.flgp")
    native.write_matrix(path, M)
    with native.MatrixFile(path) as f:
        seen = list(native.StreamLoader(f, chunk_rows=128))
    assert [lo for lo, _ in seen] == list(range(0, 1000, 128))
    assert [len(c) for _, c in seen] == [128] * 7 + [104]
    np.testing.assert_array_equal(np.concatenate([c for _, c in seen]), M)


def test_host_knn_and_lae_match_the_plain_versions():
    from flgp_tpu_torch.ops.knn import knn_plain
    from flgp_tpu_torch.ops.lae import lae_weights_plain

    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    U = rng.normal(size=(50, 3)).astype(np.float32)
    idx, dist = native.knn(X, U, 4, n_threads=2)
    ref = knn_plain(torch.as_tensor(X, dtype=torch.float64), torch.as_tensor(U, dtype=torch.float64), 4)
    np.testing.assert_array_equal(idx, ref.indices.numpy())
    np.testing.assert_allclose(dist, ref.sqdists.numpy(), rtol=1e-4, atol=1e-4)
    i1, d1 = native.knn(X, U, 4, n_threads=1)
    np.testing.assert_array_equal(i1, idx)
    np.testing.assert_array_equal(d1, dist)

    w = native.lae_weights(X, U, idx[:, :3], iters=150)
    w_ref = lae_weights_plain(torch.as_tensor(X, dtype=torch.float64),
                              torch.as_tensor(U, dtype=torch.float64),
                              torch.as_tensor(idx[:, :3]).long(), 150)
    np.testing.assert_allclose(w, w_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-5)
    assert (w >= -1e-7).all()


def test_polya_gamma_mean_within_monte_carlo_error():
    n, b, c = 20000, 2, 1.5
    draws = native.polya_gamma(123, np.full(n, b, np.int32), np.full(n, c), n_threads=2)
    mean = b / (2.0 * c) * np.tanh(c / 2.0)
    assert (draws > 0).all()
    assert abs(draws.mean() - mean) < 5 * draws.std() / np.sqrt(n)
    zero = native.polya_gamma(7, np.ones(n, np.int32), np.zeros(n))
    assert abs(zero.mean() - 0.25) < 5 * zero.std() / np.sqrt(n)
    assert native.hardware_threads() >= 1


def test_knn_stream_equals_knn(tmp_path):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 3)).astype(np.float32)
    U = rng.normal(size=(32, 3)).astype(np.float32)
    path = str(tmp_path / "x.flgp")
    native.write_matrix(path, X)
    with native.MatrixFile(path) as f:
        idx_s, dist_s = f.knn_stream(U, 3, chunk_rows=512)
    idx, dist = native.knn(X, U, 3)
    np.testing.assert_array_equal(idx_s, idx)
    np.testing.assert_array_equal(dist_s, dist)


def test_unbuildable_source_and_missing_compiler_raise(tmp_path, monkeypatch):
    bad = tmp_path / "flgp_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+ failed"):
        native.build()
    assert not any((tmp_path / "build").rglob("*.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeUnavailable, match="not found"):
        native.build(force=True)
