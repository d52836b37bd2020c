"""flgp_tpu_torch.parallel (the multi-device layer on torch.distributed)
against single-process results and against flgp_tpu.

World size 1, in this process: every ``sharded_*_fn`` against its
single-process oracle in the port and, where the reference has one, in the
JAX package (float64, the same arrays).  World size 2, gloo, in two
subprocesses that run this file's ``_worker``: the sharded spectrum, the GPR
NMLL and its gradient, predict, the GPC Laplace tail, the prediction from
dual weights and ``pooled_mean_variance`` against the same functions at
world size 1 on the whole data (float64, 1e-10; float32 draws at mean 17
and sd 0.01 within 1% of their float64 variance, F8), chain-sharded ChEES (the
adapted triple the same on both ranks), and ``sharded_smc_fn`` against
``run_smc`` bit for bit: its draws come from one generator in global
particle order.
"""

import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from flgp_tpu_torch.config import GraphConfig, KernelType, LaplacianType
from flgp_tpu_torch.parallel import mesh as pmesh
from flgp_tpu_torch.parallel.gpc import sharded_gpc_laplace_fn, sharded_predict_weights_fn
from flgp_tpu_torch.parallel.mcmc import (
    pooled_mean_variance,
    sharded_chees_fn,
    sharded_hmc_fn,
    sharded_nuts_fn,
)
from flgp_tpu_torch.parallel.smc import sharded_smc_fn
from flgp_tpu_torch.parallel.spectral import (
    _local_ell,
    sharded_gpr_nmll_fn,
    sharded_predict_fn,
    sharded_spectrum_fn,
    sharded_spectrum_from_ell_fn,
)

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


def _one(axis="data"):
    """A mesh of world size 1 on the CPU (no process group)."""
    return pmesh.Mesh(None, axis, 0, 1, CPU)


def _graph_problem(n=160, d=3, s=24, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    U = X[rng.permutation(n)[:s]] + 0.01 * rng.normal(size=(s, d))
    counts = rng.integers(1, 20, size=(s,)).astype(np.float64)
    return X, U, counts


def _tail_problem(n=160, K=12, m=64, seed=11):
    """An eigenpair, binary labels and a train mask (the reference's own)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, K)) / np.sqrt(K)
    lam = np.linspace(0.999, 0.2, K)
    Y = (rng.uniform(size=n) > 0.5).astype(np.float64)
    mask = np.zeros(n)
    mask[:m] = 1.0
    return lam, V, Y * mask, mask


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _assert_vectors(got, want, atol):
    """Equal up to a sign a column."""
    got, want = np.asarray(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    signs[signs == 0] = 1.0
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=atol)


def _gauss_smc():
    mu = torch.tensor([1.0, -0.5], dtype=F64)

    def log_prior(x):
        return -0.5 * torch.sum(x * x, dim=-1) - math.log(2.0 * math.pi)

    def log_like(x):
        return -0.5 * torch.sum((x - mu) ** 2, dim=-1) / 0.5 - math.log(2.0 * math.pi * 0.5)

    return log_prior, log_like


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_helpers_at_world_size_1(monkeypatch):
    for var in ("FLGP_COORDINATOR", "FLGP_NUM_PROCESSES", "FLGP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.init_distributed() is False
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.axis, mesh.rank, mesh.size, mesh.device) == (None, "data", 0, 1, CPU)
    assert pmesh.global_mesh(("chain",), device="cpu").axis == "chain"
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(pmesh.shard_rows(mesh, x), x)
    assert torch.equal(pmesh.replicate(mesh, x), x)
    assert mesh.psum(x) is x and mesh.all_gather(x) is x
    padded, n = pmesh.pad_to_multiple(torch.ones(5, 3), 4)
    assert n == 5 and padded.shape == (8, 3) and float(padded[5:].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="axis"):
        pmesh.shard_rows(mesh, x, axis="chain")
    with pytest.raises(ValueError):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        sharded_spectrum_fn(pmesh.make_mesh(axis_names=("chain",), device="cpu"), GraphConfig())


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.init_distributed("127.0.0.1:1", 1, 0)


# ---------------------------------------------------------------------------
# world size 1 against the single-process oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [3, 24])
@pytest.mark.parametrize("gl", [LaplacianType.RW, LaplacianType.CLUSTER_NORMALIZED])
def test_sharded_spectrum_matches_reference_and_spectrum_fused(gl, r):
    import jax.numpy as jnp

    from flgp_tpu.config import LaplacianType as JL
    from flgp_tpu.ops.spectrum import cross_similarity_lae, spectrum_from_Z

    from flgp_tpu_torch.ops.spectrum import spectrum_fused

    X, U, counts = _graph_problem()
    g = GraphConfig(s=24, r=r, K=10, gl=gl, kernel=KernelType.LAE)
    Z = cross_similarity_lae(jnp.asarray(X), jnp.asarray(U), g.r, JL(gl.value), jnp.asarray(counts))
    ref = spectrum_from_Z(Z, 10, g.root)

    values, vectors = sharded_spectrum_fn(_one(), g)(_t(X), _t(U), _t(counts))
    np.testing.assert_allclose(values.numpy(), np.asarray(ref.values), rtol=1e-10, atol=1e-12)
    _assert_vectors(vectors.numpy(), np.asarray(ref.vectors), 1e-8)

    Zl = _local_ell(_t(X), _t(U), g)
    fused = spectrum_fused(Zl.values, Zl.indices, g.s, 10, gl, g.root, _t(counts))
    got = sharded_spectrum_from_ell_fn(_one(), g)(Zl.values, Zl.indices, _t(counts))
    np.testing.assert_allclose(got[0].numpy(), fused.values.numpy(), rtol=1e-12, atol=1e-13)
    _assert_vectors(got[1].numpy(), fused.vectors.numpy(), 1e-10)


def _gpr_setup():
    import jax

    from flgp_tpu.config import GraphConfig as JG
    from flgp_tpu.fit.spectral import build_spectrum

    X, _, _ = _graph_problem()
    jeig, _ = build_spectrum(jax.random.PRNGKey(1), jax.numpy.asarray(X), JG(s=24, r=3, K=10))
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=X.shape[0]) < 0.4).astype(float)
    Y = rng.normal(size=X.shape[0]) * mask
    return jeig, Y, mask


def test_sharded_gpr_nmll_gradient_and_predict_match_single_process():
    import jax
    import jax.numpy as jnp

    from flgp_tpu.models import gpr as jgpr
    from flgp_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flgp_tpu.parallel.spectral import sharded_gpr_nmll_fn as jsharded_nmll
    from flgp_tpu.types import EigenPair as JEig

    from flgp_tpu_torch.models import gpr as gpr_mod
    from flgp_tpu_torch.types import EigenPair

    jeig, Y, mask = _gpr_setup()
    K, sigma, n = 10, 1e-5, Y.shape[0]
    idx = np.nonzero(mask)[0]
    values, vectors = _t(jeig.values), _t(jeig.vectors)
    eig = EigenPair(values, vectors)
    t = torch.tensor(2.0, dtype=F64, requires_grad=True)
    noise = torch.tensor(0.5, dtype=F64, requires_grad=True)

    got = sharded_gpr_nmll_fn(_one(), K, sigma)(values, vectors, _t(Y), _t(mask), t, noise)
    # the reference's own sharded objective on a one-device mesh, and its
    # dense-row Woodbury objective at the tolerance its test holds them to
    jmesh = jmake_mesh(1, ("data",))
    jsharded = jsharded_nmll(jmesh, K, sigma)(jeig.values, jeig.vectors, jnp.asarray(Y),
                                              jnp.asarray(mask), jnp.asarray(2.0),
                                              jnp.asarray(0.5))
    np.testing.assert_allclose(float(got.detach()), float(jsharded), rtol=1e-10)
    ref = jgpr.gpr_nmll(jeig, jnp.asarray(Y[idx]), jnp.asarray(idx), K, jnp.asarray(2.0),
                        jnp.asarray(0.5), sigma)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-8)
    g_got = torch.autograd.grad(got, (t, noise))
    g_ref = jax.grad(lambda tn: jsharded_nmll(jmesh, K, sigma)(
        jeig.values, jeig.vectors, jnp.asarray(Y), jnp.asarray(mask), tn[0], tn[1]))(
        jnp.asarray([2.0, 0.5]))
    np.testing.assert_allclose([float(g) for g in g_got], np.asarray(g_ref), rtol=1e-10)
    own = gpr_mod.gpr_nmll(eig, _t(Y[idx]), torch.as_tensor(idx), K, t, noise, sigma)
    g_own = torch.autograd.grad(own, (t, noise))
    np.testing.assert_allclose([float(g) for g in g_got], [float(g) for g in g_own], rtol=1e-8)

    pred = sharded_predict_fn(_one(), K, sigma)(values, vectors, _t(Y), _t(mask), 2.0, 0.5)
    jref = jgpr.gpr_predict(JEig(jeig.values[:K], jeig.vectors), jnp.asarray(Y[idx]),
                            jnp.asarray(idx), jnp.arange(n), K, jnp.asarray(2.0),
                            jnp.asarray(0.5), sigma)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jref), rtol=1e-9, atol=1e-11)


def test_sharded_gpc_tail_matches_dense_laplace():
    import jax.numpy as jnp

    from flgp_tpu.models import gpc as jgpc
    from flgp_tpu.ops import linalg as jlin
    from flgp_tpu.ops.heat_kernel import heat_kernel as jhk
    from flgp_tpu.ops.heat_kernel import heat_kernel_diag as jhkd
    from flgp_tpu.types import EigenPair as JEig

    from flgp_tpu_torch.models import gpc as gpc_mod
    from flgp_tpu_torch.ops import linalg
    from flgp_tpu_torch.ops.heat_kernel import heat_kernel, heat_kernel_diag
    from flgp_tpu_torch.types import EigenPair

    lam, V, Y, mask = _tail_problem()
    n, K, m, sigma, t = V.shape[0], V.shape[1], int(mask.sum()), 1e-3, 8.0
    eig = EigenPair(_t(lam), _t(V))
    i0, i1 = torch.arange(m), torch.arange(m, n)
    C11 = linalg.add_diag(heat_kernel(eig, t, K, i0, i0), sigma)
    C21 = heat_kernel(eig, t, K, i1, i0)
    C22 = heat_kernel_diag(eig, t, K, i1) + sigma
    amll_own = gpc_mod.gpc_marginal_log_likelihood(C11, _t(Y[:m]), torch.ones(m, dtype=F64))
    mean_own, var_own = gpc_mod.gpc_posterior_moments(C11, C21, C22, _t(Y[:m]))

    amll, mean, var, label = sharded_gpc_laplace_fn(_one(), K, sigma)(
        eig.values, eig.vectors, _t(Y), _t(mask), _t(mask), torch.tensor(t, dtype=F64))
    np.testing.assert_allclose(float(amll), float(amll_own), rtol=1e-8)
    np.testing.assert_allclose(mean[m:].numpy(), mean_own.numpy(), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(var[m:].numpy(), var_own.numpy(), rtol=1e-7, atol=1e-9)
    assert torch.equal(label, (torch.sigmoid(mean) > 0.5).to(F64))

    jeig = JEig(jnp.asarray(lam), jnp.asarray(V))
    j0, j1 = jnp.arange(m), jnp.arange(m, n)
    jC11 = jlin.add_diag(jhk(jeig, t, K, j0, j0), jnp.full((m,), sigma))
    jmean, jvar = jgpc.gpc_posterior_moments(jC11, jhk(jeig, t, K, j1, j0),
                                             jhkd(jeig, t, K, j1) + sigma, jnp.asarray(Y[:m]))
    np.testing.assert_allclose(mean[m:].numpy(), np.asarray(jmean), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(var[m:].numpy(), np.asarray(jvar), rtol=1e-7, atol=1e-9)

    w = np.random.default_rng(5).normal(size=n) * mask
    got = sharded_predict_weights_fn(_one(), K)(eig.values, eig.vectors, _t(w), _t(mask), t,
                                                sigma)
    C_all = heat_kernel(eig, t, K, torch.arange(n), i0)
    ref = C_all @ _t(w[:m]) + sigma * _t(w)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mutation", ["hmc", "rwm"])
def test_sharded_smc_is_run_smc_bit_for_bit(mutation):
    from flgp_tpu_torch.inference.smc import run_smc

    log_prior, log_like = _gauss_smc()
    x0 = torch.randn((256, 2), generator=torch.Generator().manual_seed(0), dtype=F64)
    ref = run_smc(torch.Generator().manual_seed(1), log_prior, log_like, x0, mutation=mutation)
    got = sharded_smc_fn(_one("chain"), log_prior, log_like, mutation=mutation)(
        torch.Generator().manual_seed(1), x0)
    assert got.n_stages == ref.n_stages >= 1
    assert torch.equal(got.particles, ref.particles)
    assert torch.equal(got.log_evidence, ref.log_evidence)
    assert torch.equal(got.temperatures, ref.temperatures)


def test_chain_sharded_samplers_at_world_size_1():
    """HMC, NUTS and ChEES through their sharded entries: the target's mean
    and variance within Monte Carlo error (the reference's own gates)."""
    dim = 3
    target = torch.tensor([0.5, -1.0, 2.0], dtype=F64)

    def logprob(x):
        return -0.5 * torch.sum((x - target) ** 2, dim=-1)

    mesh = _one("chain")
    x0 = torch.randn((8, dim), generator=torch.Generator().manual_seed(2), dtype=F64)
    runs = [sharded_hmc_fn(mesh, logprob, 100, 200, n_leapfrog=8),
            sharded_nuts_fn(mesh, logprob, 100, 200),
            sharded_chees_fn(mesh, logprob, 150, 200)]
    for fn in runs:
        run = fn(torch.Generator().manual_seed(3), x0)
        assert run.samples.shape == (200, 8, dim)
        mean, var = pooled_mean_variance(mesh, run.samples)
        np.testing.assert_allclose(mean.numpy(), target.numpy(), atol=0.25)
        np.testing.assert_allclose(var.numpy(), 1.0, atol=0.5)


def _offset_draws(shape=(512, 16, 4), seed=5):
    """float32 draws whose mean (17) is large against their sd (0.01), and
    the float64 variance of exactly those values."""
    d32 = (17.0 + 0.01 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)
    return d32, d32.astype(np.float64).reshape(-1, shape[-1]).var(axis=0)


def test_pooled_variance_of_float32_draws_is_the_float64_one():
    """F8, repaired in the port only: ``pooled_mean_variance`` sums Σx and
    Σx² in float64 and casts back, so float32 draws at mean 17 and sd 0.01
    give their variance within 1%.  The reference
    (``flgp_tpu/parallel/mcmc.py:144-151``) sums in the draws' dtype, where
    Σx²/N − mean² cancels: 6e-5 to 1.5e-4 for these 1e-4.  World size 1."""
    d32, var64 = _offset_draws()
    mean, var = pooled_mean_variance(_one("chain"), torch.from_numpy(d32))
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(var.numpy(), var64, rtol=1e-2)
    np.testing.assert_allclose(mean.numpy(), d32.astype(np.float64).reshape(-1, 4).mean(axis=0),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# world size 2: two processes under gloo
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_under_gloo_match_one():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, FLGP_COORDINATOR=f"127.0.0.1:{port}", FLGP_NUM_PROCESSES="2",
                   FLGP_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))), os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                pytest.fail("a gloo worker hung past 240 s")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        assert "PARALLEL_OK" in out, out


def _worker() -> None:
    """One rank of the two-process check; prints PARALLEL_OK."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert pmesh.init_distributed(device="cpu")
    mesh = pmesh.global_mesh(("data",))
    assert mesh.size == 2 and mesh.device == CPU
    rank, one = mesh.rank, _one()
    n, s, K, m = 512, 24, 10, 64
    X, U, counts = _graph_problem(n=n, s=s)
    lo, hi = rank * n // 2, (rank + 1) * n // 2

    def close(a, b, what, tol=1e-10):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=what)

    # r = 24 first: the tests below take the last pass's spectrum, r = 3's
    for r, gl in ((24, LaplacianType.RW), (24, LaplacianType.CLUSTER_NORMALIZED),
                  (3, LaplacianType.RW), (3, LaplacianType.CLUSTER_NORMALIZED)):
        g = GraphConfig(s=s, r=r, K=K, gl=gl)
        values, vec = sharded_spectrum_fn(mesh, g)(pmesh.shard_rows(mesh, _t(X)),
                                                   pmesh.replicate(mesh, _t(U)),
                                                   pmesh.replicate(mesh, _t(counts)))
        ref_values, ref_vec = sharded_spectrum_fn(one, g)(_t(X), _t(U), _t(counts))
        close(values, ref_values, f"spectrum values {gl} r={r}")
        _assert_vectors(vec.numpy(), ref_vec[lo:hi].numpy(), 1e-10)

    rng = np.random.default_rng(0)
    Yr = rng.normal(size=n)
    mask = (rng.uniform(size=n) < 0.4).astype(float)
    V, lam = ref_vec, ref_values
    Vl, Yl, ml = V[lo:hi], _t(Yr * mask)[lo:hi], _t(mask)[lo:hi]

    def nmll_and_grad(msh, vectors, Y, mk):
        t = torch.tensor(2.0, dtype=F64, requires_grad=True)
        noise = torch.tensor(0.5, dtype=F64, requires_grad=True)
        val = sharded_gpr_nmll_fn(msh, K, 1e-5)(lam, vectors, Y, mk, t, noise)
        return [float(val)] + [float(x) for x in torch.autograd.grad(val, (t, noise))]

    close(nmll_and_grad(mesh, Vl, Yl, ml), nmll_and_grad(one, V, _t(Yr * mask), _t(mask)),
          "GPR NMLL and its gradient")
    close(sharded_predict_fn(mesh, K, 1e-5)(lam, Vl, Yl, ml, 2.0, 0.5),
          sharded_predict_fn(one, K, 1e-5)(lam, V, _t(Yr * mask), _t(mask), 2.0, 0.5)[lo:hi],
          "GPR predict")

    tl, TV, TY, tmask = _tail_problem(n=n, K=K, m=m)
    tv, ty, tm = _t(TV), _t(TY), _t(tmask)
    got = sharded_gpc_laplace_fn(mesh, K, 1e-3)(_t(tl), tv[lo:hi], ty[lo:hi], tm[lo:hi],
                                                tm[lo:hi], torch.tensor(8.0, dtype=F64))
    ref = sharded_gpc_laplace_fn(one, K, 1e-3)(_t(tl), tv, ty, tm, tm,
                                               torch.tensor(8.0, dtype=F64))
    close(got[0], ref[0], "GPC amll")
    for a, b, what in zip(got[1:], ref[1:], ("mean", "var", "label")):
        close(a, b[lo:hi], f"GPC {what}")
    w = _t(rng.normal(size=n)) * tm
    close(sharded_predict_weights_fn(mesh, K)(_t(tl), tv[lo:hi], w[lo:hi], tm[lo:hi], 8.0, 1e-3),
          sharded_predict_weights_fn(one, K)(_t(tl), tv, w, tm, 8.0, 1e-3)[lo:hi],
          "prediction from dual weights")

    chain = pmesh.global_mesh(("chain",))
    draws = _t(np.random.default_rng(4).normal(size=(50, 8, 3)))
    mean, var = pooled_mean_variance(chain, draws[:, rank * 4:(rank + 1) * 4])
    flat = draws.reshape(-1, 3).numpy()
    close(mean, flat.mean(axis=0), "pooled mean")
    close(var, flat.var(axis=0), "pooled variance")
    d32, var64 = _offset_draws()                      # F8: float32 draws far from 0
    mean, var = pooled_mean_variance(chain, torch.from_numpy(d32[:, rank * 8:(rank + 1) * 8]))
    assert var.dtype == torch.float32
    close(var, var64, "pooled float32 variance", tol=1e-2 * float(var64.max()))

    dim = 3
    scales = torch.tensor([1.0, 2.0, 4.0], dtype=F64)

    def logprob(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    x0 = torch.randn((16, dim), generator=torch.Generator().manual_seed(7), dtype=F64)
    run = sharded_chees_fn(chain, logprob, 200, 200)(torch.Generator().manual_seed(8),
                                                    x0[rank * 8:(rank + 1) * 8])
    triple = torch.cat([run.step.reshape(1), run.traj_len.reshape(1), run.inv_mass])
    both = chain.all_gather(triple[None])
    assert torch.equal(both[0], both[1]), "ChEES adapted differently on the two ranks"
    mean, var = pooled_mean_variance(chain, run.samples)
    np.testing.assert_allclose(mean.numpy(), 0.0, atol=0.6)
    np.testing.assert_allclose(var.numpy(), (scales ** 2).numpy(), rtol=0.4)

    from flgp_tpu_torch.inference.smc import run_smc

    log_prior, log_like = _gauss_smc()
    x0 = torch.randn((256, 2), generator=torch.Generator().manual_seed(0), dtype=F64)
    for mutation in ("hmc", "rwm"):
        ref = run_smc(torch.Generator().manual_seed(1), log_prior, log_like, x0,
                      mutation=mutation)
        got = sharded_smc_fn(chain, log_prior, log_like, mutation=mutation)(
            torch.Generator().manual_seed(1), x0[rank * 128:(rank + 1) * 128])
        assert got.n_stages == ref.n_stages
        assert torch.equal(got.particles, ref.particles[rank * 128:(rank + 1) * 128]), mutation
        assert torch.equal(got.log_evidence, ref.log_evidence), mutation
    dist.destroy_process_group()
    print("PARALLEL_OK", flush=True)


if __name__ == "__main__":
    _worker()
