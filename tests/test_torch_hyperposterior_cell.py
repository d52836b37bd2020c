"""The benchmark cell ``mnist7e4.hyperposterior`` at a small shape on the CPU:
the ten-class job's path (``fit.spectral.build_spectrum``, the pair cast to
float64 by ``fit.drivers._solve_cast``, ``inference.hyperparam.mult_t_posterior``)
on six classes of ``mnist_like``, judged by the cell's plain reference
(``benchmark/reference/lae_smc.py``) against the cell's limits.

Deterministic: the port's quadrature (``mult_t_quadrature``) and the
reference's agree to 1e-8 on one float64 pair, in the t-moments the port
reports and in the log evidence.  Stochastic, at the cell's budget of 64
particles and 5 mutations: the SMC θ-means lie within the band the cell's
limits set, and each planted fault reads outside it.  And the port's own: one
generator seed gives the same bits twice, the counters count, and the
reference imports nothing of the port and no JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flgp_tpu_torch as ft
from flgp_tpu_torch.datasets import mnist_like
from flgp_tpu_torch.fit import drivers, spectral
from flgp_tpu_torch.fit.multiclass import one_hot_labels
from flgp_tpu_torch.inference import hyperparam, smc
from flgp_tpu_torch.utils import metrics

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
REF_PATH = BENCH / "reference" / "lae_smc.py"
CELL = "mnist7e4.hyperposterior"
# six classes: with three, one importance-sampling step from the prior (the
# tempering_skipped fault) degenerates too little to be told from a ladder
N, J, D, M, S, K = 3000, 6, 16, 120, 150, 40
CPU = torch.device("cpu")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"test_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(REF_PATH)
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((BENCH / "configs" / "mnist_mult_7e4_smc.json").read_text())
H = CONFIG["hyperposterior"]
# the numbers the limits judge that the sampler alone moves
SAMPLER = ("theta_mean_gap", "theta_mean_gap_avg")


def _small_config() -> dict:
    """The cell's configuration at the small shape, its quadrature at 64
    points a pass: the refined pass spans ± 8 posterior sd, so its points lie
    a quarter of a sd apart (the cell's 256, a sixteenth)."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["data"].update(n=N, n_classes=J, d=D, m_train=M)
    cfg["graph"].update(s=S, K=K)
    cfg["classes"] = J
    cfg["hyperposterior"]["quadrature_grid"] = 64
    return cfg


def _kw(**over) -> dict:
    kw = dict(n_particles=H["n_particles"], n_mutation_steps=H["n_mutation_steps"],
              p=H["prior_p"], q=H["prior_q"], tau=H["prior_tau"], mu0=H["mu0"], s0=H["s0"],
              newton_tol=H["newton_tol"], newton_max_iter=H["newton_max_iter"], device="cpu")
    kw.update(over)
    return kw


class _Spectrum:
    """One float32 spectrum of the small data as the job builds it, what the
    reference reads of its graph stage, and the float64 pair the posterior
    runs on."""

    def __init__(self):
        self.ds = mnist_like(n=N, n_classes=J, d=D, m_train=M, seed=7)
        cfg = ft.FitConfig(graph=ft.GraphConfig(s=S, r=3, K=K), dtype=torch.float32,
                           solve_dtype=torch.float64)
        got, saved = {}, {a: getattr(spectral, a) for a in ("subsample", "knn", "lae_weights")}

        def keep(name, fn):
            def wrapper(*args, **kwargs):
                got[name] = fn(*args, **kwargs)
                return got[name]
            return wrapper

        try:
            for name, fn in saved.items():
                setattr(spectral, name, keep(name, fn))
            X = torch.cat([torch.as_tensor(self.ds.x_train, dtype=torch.float32),
                           torch.as_tensor(self.ds.x_test, dtype=torch.float32)])
            self.eig, _ = spectral.build_spectrum(torch.Generator().manual_seed(3), X, cfg.graph)
        finally:
            for name, fn in saved.items():
                setattr(spectral, name, fn)
        Y = torch.as_tensor(self.ds.y_train, dtype=torch.float32)
        _, self.pair, (self.aug,) = drivers._solve_cast(cfg, self.eig, one_hot_labels(Y, J))
        self.rows = torch.as_tensor(np.concatenate([np.arange(M), M + np.arange(0, N - M, 7)]))
        self.graph = dict(centers=got["subsample"].centers, counts=got["subsample"].counts,
                          idx=got["knn"].indices, w=got["lae_weights"],
                          values=self.eig.values, vectors=self.eig.vectors[self.rows])

    def posterior(self, seed: int, **over):
        return hyperparam.mult_t_posterior(torch.Generator().manual_seed(seed), self.pair,
                                           self.aug, torch.arange(M), K, CONFIG["fit"]["sigma"],
                                           **_kw(**over))

    def readings(self, post) -> dict:
        out = dict(self.graph, theta=post.smc.particles, log_evidence=float(post.log_evidence))
        return ref.check(self.ds, out, _small_config(), self.rows, CPU)

    def sampler_readings(self, post) -> dict:
        """What the limits read of the particles alone, against the
        quadrature on this pair (computed once)."""
        if not hasattr(self, "quad"):
            Yc = ref.base.class_columns(self.ds.y_train, J, CPU, torch.float64)
            self.quad = ref.posterior_of(self.pair.values, self.pair.vectors[:M], Yc,
                                         _small_config())
        return ref.sampler_readings(post.smc.particles, float(post.log_evidence), self.quad)


@pytest.fixture(scope="module")
def spectrum():
    return _Spectrum()


def _outside(readings: dict, names) -> list:
    return [k for k in names if not readings[k] <= LIMITS[k]]


def test_the_quadratures_agree_on_one_pair(spectrum):
    """The port's quadrature and the reference's, on the fit's float64 pair,
    with both Newton solves converged far below the grid's resolution: the
    same grid rule, so the same moments and evidence but for rounding.  (The
    port reports t's moments; θ's enter both through the refined grid.)"""
    cfg = _small_config()
    prior = ref.prior_of(cfg)
    port = hyperparam.mult_t_quadrature(
        spectrum.pair, spectrum.aug, torch.arange(M), K, CONFIG["fit"]["sigma"],
        n_grid=cfg["hyperposterior"]["quadrature_grid"],
        half_width_sds=H["quadrature_half_width_sds"],
        p=prior["p"], q=prior["q"], tau=prior["tau"], mu0=prior["mu0"], s0=prior["s0"],
        newton_tol=1e-13, newton_max_iter=200, device="cpu")
    Yc = ref.base.class_columns(spectrum.ds.y_train, J, CPU, torch.float64)
    own = ref.posterior_of(spectrum.pair.values[:K], spectrum.pair.vectors[:M, :K], Yc, cfg)
    np.testing.assert_allclose(port.t_mean.numpy(), own.t_mean.numpy(), rtol=1e-8)
    np.testing.assert_allclose(port.t_sd.numpy(), own.t_sd.numpy(), rtol=1e-8)
    np.testing.assert_allclose(float(port.log_evidence), float(own.log_z.sum()), rtol=1e-8)
    np.testing.assert_allclose(float(port.coarse_max_weight), own.coarse_max_weight, rtol=1e-8)
    assert own.coarse_max_weight < 0.5 and float(own.theta_sd.min()) > 0.0


def test_the_smc_theta_means_lie_within_the_cell_s_band(spectrum):
    post = spectrum.posterior(11)
    readings = spectrum.readings(post)
    assert set(LIMITS) <= set(readings)
    assert _outside(readings, SAMPLER) == [], {k: readings[k] for k in SAMPLER}
    sampler = spectrum.sampler_readings(post)         # the same numbers, from the cached quadrature
    assert sampler == {k: readings[k] for k in sampler}


def _beta_one(ll, beta, min_ess):
    return torch.ones_like(beta)


def _unmutated(generator, target, x, lp, step, n_steps):
    return x, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


def _tenfold(orig):
    return lambda V, lam, t: orig(V, lam, 10.0 * t)


def _class_dropped(orig):
    def marginal(*args, **kwargs):
        mll = orig(*args, **kwargs).clone()
        mll[..., 0] = 0.0
        return mll
    return marginal


@pytest.mark.parametrize("fault", ["tempering_skipped", "unmutated", "t_scaled",
                                   "class_dropped"])
def test_a_broken_ladder_reads_outside_the_band(spectrum, fault, monkeypatch):
    """β set to 1 at the first stage; no mutation; the likelihood at 10·t;
    class 0 left out of the summed likelihood: each as the job plants it."""
    if fault == "tempering_skipped":
        monkeypatch.setattr(smc, "_next_beta", _beta_one)
    elif fault == "unmutated":
        monkeypatch.setattr(smc, "_mutate_rwm", _unmutated)
    elif fault == "t_scaled":
        monkeypatch.setattr(hyperparam, "_phi", _tenfold(hyperparam._phi))
    else:
        monkeypatch.setattr(hyperparam, "gpc_marginal_log_likelihood_lowrank",
                            _class_dropped(hyperparam.gpc_marginal_log_likelihood_lowrank))
    readings = spectrum.sampler_readings(spectrum.posterior(11))
    assert _outside(readings, SAMPLER), {k: readings[k] for k in SAMPLER}


def test_one_generator_seed_gives_the_same_bits(spectrum):
    a = spectrum.posterior(5, n_particles=16)
    b = spectrum.posterior(5, n_particles=16)
    assert a.smc.n_stages == b.smc.n_stages
    assert torch.equal(a.smc.particles, b.smc.particles)
    assert torch.equal(a.log_evidence, b.log_evidence)
    assert torch.equal(a.smc.temperatures, b.smc.temperatures)


def test_the_counters_count_stages_evaluations_and_lanes(spectrum):
    """A stage evaluates the likelihood over all particles once to reweight
    and once a mutation step, each over particles × classes lanes; every
    stage reads β once."""
    before = metrics.COUNTS.copy()
    post = spectrum.posterior(5, n_particles=16, n_mutation_steps=3)
    got = metrics.COUNTS - before
    stages = post.smc.n_stages
    assert stages > 1 and got["smc_stages"] == stages
    assert got["smc_likelihood_evals"] == (1 + 3) * stages
    assert got["smc_lanes"] / got["smc_likelihood_evals"] == 16 * J
    assert got["newton_rounds"] > 0
    assert got["host_syncs"] == stages + got["newton_rounds"] + got["smc_likelihood_evals"]


def test_the_settings_are_the_posterior_s_defaults():
    """The cell states the prior and budget ``mult_t_posterior`` defaults to,
    and the quadrature's grid."""
    import inspect

    post = inspect.signature(hyperparam.mult_t_posterior).parameters
    quad = inspect.signature(hyperparam.mult_t_quadrature).parameters
    for key, name in (("n_particles", "n_particles"), ("n_mutation_steps", "n_mutation_steps"),
                      ("prior_p", "p"), ("prior_q", "q"), ("prior_tau", "tau"), ("mu0", "mu0"),
                      ("s0", "s0"), ("newton_tol", "newton_tol"),
                      ("newton_max_iter", "newton_max_iter"),
                      ("stages_per_dispatch", "stages_per_dispatch")):
        assert post[name].default == H[key], key
    assert quad["n_grid"].default == H["quadrature_grid"]
    assert quad["half_width_sds"].default == H["quadrature_half_width_sds"]


def test_the_reference_imports_neither_jax_nor_either_package_and_runs_in_float64():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('lae_smc', {str(REF_PATH)!r})\n"
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}"
            " & {'jax', 'jaxlib', 'flgp_tpu', 'flgp_tpu_torch'}))\n"
            "print(mod.F64.graph, mod.F64.tail, mod.F64.tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.split("\n")
    assert out[0] == "[]"
    assert out[1] == "torch.float64 torch.float64 False"
    source = REF_PATH.read_text()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in source
