"""The out-of-core front half of flgp_tpu_torch.fit.streaming against
flgp_tpu.fit.streaming, at the reference tests' shapes (n = 1500, chunks of
400 and 701 rows).

Both packages read the same FLGP0001 files.  The reservoir sample is the
reference's bit for bit; the graph, the spectrum and the drivers' trained
hyperparameters and Laplace moments are held to the reference in float64 on
the same anchors (both subsamplers pinned through ``monkeypatch`` for a
test's duration); the PG-Gibbs streams of torch and JAX differ, so the PG
probabilities are held to the reference within Monte Carlo error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flgp_tpu import native as jnative
from flgp_tpu.config import FitConfig as JFit
from flgp_tpu.config import GraphConfig as JGraph
from flgp_tpu.config import KernelType as JKernel
from flgp_tpu.fit import streaming as jstreaming
from flgp_tpu.ops.kmeans import SubsampleResult as JSub

from flgp_tpu_torch import native
from flgp_tpu_torch.config import FitConfig, GraphConfig, KernelType
from flgp_tpu_torch.convert import fit_config_from_jax
from flgp_tpu_torch.fit import streaming
from flgp_tpu_torch.fit.spectral import build_spectrum
from flgp_tpu_torch.ops.kmeans import SubsampleResult, kmeans

torch.set_num_threads(1)
F64 = torch.float64
N = 1500


class Recording(native.MatrixFile):
    """A MatrixFile that records every read as (start, count)."""

    def __init__(self, path):
        super().__init__(path)
        self.reads = []

    def read(self, start, count):
        self.reads.append((start, count))
        return super().read(start, count)

    def read_into(self, start, count, data_ptr):
        self.reads.append((start, count))
        return super().read_into(start, count, data_ptr)


def _write(tmp_path, X, name="x.flgp"):
    path = str(tmp_path / name)
    native.write_matrix(path, X)
    return path


def _cloud(seed=0, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(N, 3)).astype(dtype)


def _anchors(X, s, seed=0):
    """k-means anchors and their cluster sizes, as numpy arrays."""
    sub = kmeans(torch.Generator().manual_seed(seed), torch.as_tensor(X, dtype=F64), s)
    return sub.centers.numpy(), sub.counts.numpy()


def _pin(monkeypatch, centers, counts):
    """Both packages' streamed subsamplers return these anchors."""
    monkeypatch.setattr(jstreaming, "streamed_subsample",
                        lambda *a, **k: JSub(jnp.asarray(centers), jnp.asarray(counts)))
    monkeypatch.setattr(streaming, "streamed_subsample",
                        lambda *a, **k: SubsampleResult(torch.as_tensor(centers, dtype=F64),
                                                        torch.as_tensor(counts, dtype=F64)))


def _assert_vectors(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1.0
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=atol)


@pytest.mark.parametrize("chunk_rows", [400, 701])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reservoir_sample_is_the_reference_s_bit_for_bit(tmp_path, chunk_rows, dtype):
    X = _cloud(dtype=dtype)
    path = _write(tmp_path, X)
    with jnative.MatrixFile(path) as jm, native.MatrixFile(path) as m:
        ref = jstreaming.reservoir_sample(jm, 128, chunk_rows=chunk_rows, seed=1)
        got = streaming.reservoir_sample(m, 128, chunk_rows=chunk_rows, seed=1)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.abs(got[:, None, :] - X[None]).sum(-1).min(1).max() == 0.0


def test_count_pass_is_a_bincount_of_the_nearest_anchor(tmp_path):
    X = _cloud(seed=1)
    path = _write(tmp_path, X)
    g = GraphConfig(s=32, r=3, K=12)
    with native.MatrixFile(path) as m:
        sub = streaming.streamed_subsample(torch.Generator().manual_seed(0), m, g,
                                           chunk_rows=400, device="cpu")
    U = sub.centers.numpy()
    nearest = np.argmin(((X[:, None, :] - U[None]) ** 2).sum(-1), axis=1)
    assert sub.counts.dtype == F64
    np.testing.assert_array_equal(sub.counts.numpy(), np.bincount(nearest, minlength=32))


@pytest.mark.parametrize("chunk_rows", [400, 701])
@pytest.mark.parametrize("kernel", [KernelType.LAE, KernelType.SE])
def test_streamed_graph_is_the_in_memory_graph(tmp_path, chunk_rows, kernel):
    from flgp_tpu_torch.ops.knn import knn
    from flgp_tpu_torch.ops.lae import lae_weights

    X = _cloud(seed=2)
    U, _ = _anchors(X, 32)
    g = GraphConfig(s=32, r=3, K=12, kernel=kernel)
    with native.MatrixFile(_write(tmp_path, X)) as m:
        Z = streaming.streamed_ell_graph(m, torch.as_tensor(U), g, chunk_rows=chunk_rows)
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    res = knn(Xt, Ut, 3)
    w = lae_weights(Xt, Ut, res.indices) if kernel == KernelType.LAE else \
        torch.exp(-res.sqdists / (4.0 * g.epsilon ** 2))
    assert torch.equal(Z.indices, res.indices)
    np.testing.assert_allclose(Z.values.numpy(), w.numpy(), rtol=0, atol=1e-12)
    with jnative.MatrixFile(str(tmp_path / "x.flgp")) as jm:
        jZ = jstreaming.streamed_ell_graph(jm, jnp.asarray(U), JGraph(s=32, r=3, K=12,
                                           kernel=JKernel(kernel.value)), chunk_rows=chunk_rows)
    np.testing.assert_array_equal(Z.indices.numpy(), np.asarray(jZ.indices))
    np.testing.assert_allclose(Z.values.numpy(), np.asarray(jZ.values), rtol=0, atol=1e-12)


def test_streamed_spectrum_matches_reference_and_in_memory(tmp_path):
    X = _cloud(seed=3)
    U, counts = _anchors(X, 32)
    path = _write(tmp_path, X)
    g = GraphConfig(s=32, r=3, K=12)
    sub = SubsampleResult(torch.as_tensor(U), torch.as_tensor(counts))
    with native.MatrixFile(path) as m:
        eig, _ = streaming.streamed_build_spectrum(torch.Generator(), m, g, 400, anchors=sub,
                                                   device="cpu")
    with jnative.MatrixFile(path) as jm:
        jeig, _ = jstreaming.streamed_build_spectrum(
            jax.random.PRNGKey(0), jm, JGraph(s=32, r=3, K=12), 400,
            anchors=JSub(jnp.asarray(U), jnp.asarray(counts)))
    np.testing.assert_allclose(eig.values.numpy(), np.asarray(jeig.values), rtol=1e-10)
    _assert_vectors(eig.vectors.numpy(), np.asarray(jeig.vectors), 1e-8)
    mem, _ = build_spectrum(torch.Generator(), torch.as_tensor(X), g, anchors=sub)
    np.testing.assert_allclose(eig.values.numpy(), mem.values.numpy(), rtol=1e-12)
    _assert_vectors(eig.vectors.numpy(), mem.vectors.numpy(), 1e-10)


def _rings(seed=3):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, size=N)
    radius = np.where(np.arange(N) % 2 == 0, 1.0, 2.0)
    X = np.stack([radius * np.cos(theta), radius * np.sin(theta)], 1)
    X = X + 0.03 * rng.normal(size=X.shape)
    return X, (np.arange(N) % 2 == 0).astype(np.float64), rng.permutation(N)[:150]


def test_streamed_gpc_matches_reference(tmp_path, monkeypatch):
    X, y_all, train_idx = _rings()
    path = _write(tmp_path, X)
    U, counts = _anchors(X, 48)
    _pin(monkeypatch, U, counts)
    jcfg = JFit(graph=JGraph(s=48, r=3, K=24), sigma=1e-3, n_gibbs=40, gibbs_avg_sweeps=20,
                dtype=jnp.float64)
    with jnative.MatrixFile(path) as jm:
        ref = jstreaming.fit_lae_logit_gp_streamed(jax.random.PRNGKey(0), jm, y_all[train_idx],
                                                   train_idx, cfg=jcfg, chunk_rows=700)
    with native.MatrixFile(path) as m:
        got = streaming.fit_lae_logit_gp_streamed(torch.Generator().manual_seed(0), m,
                                                  y_all[train_idx], train_idx,
                                                  cfg=fit_config_from_jax(jcfg), chunk_rows=700,
                                                  device="cpu")
    np.testing.assert_allclose(float(got.pars["t"]), float(ref.pars["t"]), rtol=1e-8)
    np.testing.assert_allclose(got.post_mean.numpy(), np.asarray(ref.post_mean), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.post_var.numpy(), np.asarray(ref.post_var), rtol=1e-8,
                               atol=1e-8)
    _probs_within_mc_error(got.probs.numpy(), np.asarray(ref.probs))
    test = np.setdiff1d(np.arange(N), train_idx)
    assert np.mean(got.labels.numpy()[test] != y_all[test]) < 0.05


def _probs_within_mc_error(got, ref):
    """Two PG-Gibbs runs (20 averaged sweeps each) on the same posterior:
    their probabilities differ by Monte Carlo noise only."""
    diff = np.abs(got - ref)
    assert diff.mean() < 0.02 and diff.max() < 0.25, (diff.mean(), diff.max())


def test_streamed_multiclass_matches_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    centers = np.array([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0]])
    y_all = np.arange(N) % 3
    X = centers[y_all] + 0.5 * rng.normal(size=(N, 2))
    train_idx = rng.permutation(N)[:150]
    path = _write(tmp_path, X)
    U, counts = _anchors(X, 48)
    _pin(monkeypatch, U, counts)
    jcfg = JFit(graph=JGraph(s=48, r=3, K=24), sigma=1e-3, n_gibbs=30, gibbs_avg_sweeps=15,
                dtype=jnp.float64)
    Y = y_all[train_idx].astype(np.float64)
    with jnative.MatrixFile(path) as jm:
        ref = jstreaming.fit_lae_logit_mult_gp_streamed(jax.random.PRNGKey(0), jm, Y, train_idx,
                                                        cfg=jcfg, chunk_rows=400)
    with native.MatrixFile(path) as m:
        got = streaming.fit_lae_logit_mult_gp_streamed(torch.Generator().manual_seed(0), m, Y,
                                                       train_idx, cfg=fit_config_from_jax(jcfg),
                                                       chunk_rows=400, device="cpu")
    assert got.probs.shape == (3, N) and got.post_mean.shape == (N, 3)
    np.testing.assert_allclose(got.pars["t"].numpy(), np.asarray(ref.pars["t"]), rtol=1e-8)
    np.testing.assert_allclose(got.post_mean.numpy(), np.asarray(ref.post_mean), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.post_var.numpy(), np.asarray(ref.post_var), rtol=1e-8,
                               atol=1e-8)
    _probs_within_mc_error(got.probs.numpy(), np.asarray(ref.probs))
    test = np.setdiff1d(np.arange(N), train_idx)
    assert np.mean(got.labels.numpy()[test] != y_all[test]) < 0.05


def test_streamed_regression_matches_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(N, 3))
    f = np.sin(X[:, 0]) + 0.5 * X[:, 1]
    train_idx = rng.permutation(N)[:200]
    Y = f[train_idx] + 0.05 * rng.normal(size=200)
    path = _write(tmp_path, X)
    U, counts = _anchors(X, 48)
    _pin(monkeypatch, U, counts)
    jcfg = JFit(graph=JGraph(s=48, r=3, K=24), sigma=1e-5, dtype=jnp.float64)
    with jnative.MatrixFile(path) as jm:
        ref_pred, ref_pars = jstreaming.fit_lae_regression_gp_streamed(
            jax.random.PRNGKey(0), jm, Y, train_idx, jcfg, chunk_rows=640)
    with native.MatrixFile(path) as m:
        pred, pars = streaming.fit_lae_regression_gp_streamed(
            torch.Generator().manual_seed(0), m, Y, train_idx, fit_config_from_jax(jcfg),
            chunk_rows=640, device="cpu")
    np.testing.assert_allclose(float(pars["t"]), float(ref_pars["t"]), rtol=1e-8)
    np.testing.assert_allclose(float(pars["noise"]), float(ref_pars["noise"]), rtol=1e-8)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), rtol=1e-6, atol=1e-6)
    test = np.setdiff1d(np.arange(N), train_idx)
    assert np.sqrt(np.mean((pred.numpy()[test] - f[test]) ** 2)) < 0.6


def test_solve_dtype_is_honoured_F7(tmp_path, monkeypatch):
    """float32 graph: with solve_dtype=float64 the streamed t is the
    in-memory driver's on the same anchors; with None the tail trains on the
    float32 spectrum as the reference's streamed driver does."""
    from flgp_tpu_torch.fit.drivers import _train_gpc, fit_lae_logit_gp

    X, y_all, _ = _rings(seed=5)
    m = 150
    path = _write(tmp_path, X.astype(np.float32))
    U, counts = _anchors(X.astype(np.float32).astype(np.float64), 48)
    U32, c32 = torch.as_tensor(U, dtype=torch.float32), torch.as_tensor(counts, dtype=torch.float32)
    monkeypatch.setattr(streaming, "streamed_subsample",
                        lambda *a, **k: SubsampleResult(U32, c32))
    base = FitConfig(graph=GraphConfig(s=48, r=3, K=24), sigma=1e-3, n_gibbs=20,
                     gibbs_avg_sweeps=10, dtype=torch.float32)
    f64 = dataclasses.replace(base, solve_dtype=F64)
    with native.MatrixFile(path) as mat:
        st64 = streaming.fit_lae_logit_gp_streamed(torch.Generator().manual_seed(0), mat,
                                                   y_all[:m], np.arange(m), cfg=f64,
                                                   device="cpu")
        st32 = streaming.fit_lae_logit_gp_streamed(torch.Generator().manual_seed(0), mat,
                                                   y_all[:m], np.arange(m), cfg=base,
                                                   device="cpu")
        eig, _ = streaming.streamed_build_spectrum(torch.Generator(), mat, base.graph, 1 << 16,
                                                   anchors=SubsampleResult(U32, c32),
                                                   device="cpu")
    mem = fit_lae_logit_gp(torch.Generator().manual_seed(0), X[:m].astype(np.float32),
                           y_all[:m], X[m:].astype(np.float32), cfg=f64, anchors=(U, counts),
                           device="cpu")
    assert st64.pars["t"].dtype == F64
    assert float(st64.pars["t"]) == float(mem.pars["t"])
    Y32 = torch.as_tensor(y_all[:m], dtype=torch.float32)
    ref32 = _train_gpc(streaming.EigenPair(eig.values, eig.vectors[:m]), Y32, torch.ones_like(Y32),
                       slice(0, m), 24, base)
    assert st32.pars["t"].dtype == torch.float32
    assert float(st32.pars["t"]) == float(ref32.x)


def test_one_pass_a_stage_and_no_read_past_a_chunk(tmp_path):
    X, y_all, train_idx = _rings(seed=6)
    path = _write(tmp_path, X)
    cfg = FitConfig(graph=GraphConfig(s=32, r=3, K=16), sigma=1e-3, n_gibbs=10,
                    gibbs_avg_sweeps=5, dtype=F64)
    mat = Recording(path)
    try:
        streaming.fit_lae_logit_gp_streamed(torch.Generator().manual_seed(0), mat,
                                            y_all[train_idx], train_idx, cfg=cfg, chunk_rows=400,
                                            device="cpu")
    finally:
        mat.close()
    one_pass = [(lo, 400) for lo in range(0, N, 400)]
    # the reservoir pass, the 1-NN count pass, the graph pass
    assert mat.reads == one_pass * 3
    assert max(count for _, count in mat.reads) <= 400


def test_device_none_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y_all, train_idx = _rings()
    with native.MatrixFile(_write(tmp_path, X)) as m:
        with pytest.raises(RuntimeError, match="CUDA"):
            streaming.fit_lae_logit_gp_streamed(torch.Generator(), m, y_all[train_idx], train_idx)
        with pytest.raises(RuntimeError, match="CUDA"):
            streaming.streamed_subsample(torch.Generator(), m, GraphConfig(s=16))


@pytest.mark.parametrize("module", ["fit/streaming.py", "native/__init__.py", "parallel/mesh.py",
                                    "parallel/spectral.py", "parallel/gpc.py", "parallel/mcmc.py",
                                    "parallel/smc.py"])
def test_module_has_every_public_name_of_its_reference(module):
    """Every top-level public def and class of the reference module is in the
    port's module of the same path."""
    import ast
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent

    def names(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}

    assert names(repo / "flgp_tpu" / module) <= names(repo / "flgp_tpu_torch" / module)
