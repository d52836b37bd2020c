"""flgp_tpu_torch's stage metrics (``utils/metrics.py``) and the
instrumented ``report=`` path of the two LAE drivers.

The metrics of ``fit_lae_{logit,regression}_gp(report=...)`` are held to the
JAX package's ``_instrumented_lae_fit`` on the same anchors in float64:
``newton_iters`` and ``opt_window_expansions`` equal, the rest to 1e-6
(relative, or absolute for the residuals that sit near 0).  The reference
draws its anchors inside a jitted stage that takes none, so the test hands
them to its ``build_spectrum`` for the duration of the test (a graph shape
no other test uses keeps the traced stage to itself).  The port's own: a
report changes no output bit, and the stage walls and metric keys are the
reference's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flgp_tpu
from flgp_tpu.fit import spectral as jspectral
from flgp_tpu.ops.kmeans import SubsampleResult as JSubsample
from flgp_tpu.utils.metrics import MetricsReport as JMetricsReport

import flgp_tpu_torch as ft
from flgp_tpu_torch.convert import anchors_from_numpy, fit_config_from_jax
from flgp_tpu_torch.datasets import spiral, torus_rings
from flgp_tpu_torch.utils.metrics import MetricsReport, profiler_trace

torch.set_num_threads(1)

LOGIT_KEYS = {"spectrum_s", "spectrum_orth_residual", "train_s", "opt_bracket_logwidth",
              "opt_window_expansions", "newton_iters", "newton_final_delta", "predict_s"}
REGRESSION_KEYS = {"spectrum_s", "spectrum_orth_residual", "train_s", "adam_grad_norm",
                   "train_obj", "predict_s"}


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _data(task, n=700, m=60):
    if task == "logit":
        ds = torus_rings(n=n, m_train=m, seed=1234)
    else:
        ds = spiral(n=n, m_train=m, noise_sd=0.3, seed=5)
    return ds, np.concatenate([ds.x_train, ds.x_test])


def _anchors(X_all, s, seed=0):
    rng = np.random.default_rng(seed)
    centers = X_all[rng.choice(len(X_all), s, replace=False)]
    d2 = ((X_all[:, None, :] - centers[None]) ** 2).sum(-1)
    return centers, np.bincount(d2.argmin(1), minlength=s).astype(np.float64)


def test_stage_times_collects_and_serializes():
    report = MetricsReport()
    with report.stage("a", size=3) as slot:
        slot["resid"] = 0.5
        slot["_sync"] = torch.ones(2)
    with report.stage("b"):
        pass
    assert [s.name for s in report.stages] == ["a", "b"]
    assert report.stages[0].extra == {"size": 3, "resid": 0.5}
    assert report.total() == pytest.approx(sum(s.wall_s for s in report.stages))
    rows = json.loads(report.to_json())
    assert rows[0]["stage"] == "a" and rows[0]["size"] == 3 and "wall_s" in rows[1]
    ref = JMetricsReport()
    with ref.stage("a", size=3) as slot:
        slot["resid"] = 0.5
    assert set(json.loads(ref.to_json())[0]) == set(rows[0])


def test_profiler_trace_writes_a_trace_and_is_a_no_op_for_none(tmp_path):
    with profiler_trace(None):
        torch.ones(3).sum()
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]


@pytest.mark.parametrize("task", ["logit", "regression"])
def test_report_metrics_match_reference(task, monkeypatch):
    ds, X_all = _data(task)
    # graph shapes no other test traces: the jitted stage keeps its trace,
    # and with it the anchors, for its shapes
    s = {"logit": 37, "regression": 41}[task]
    centers, counts = _anchors(X_all, s)
    janchors = JSubsample(jnp.asarray(centers), jnp.asarray(counts))
    build = jspectral.build_spectrum
    monkeypatch.setattr(jspectral, "build_spectrum",
                        lambda key, X, g, anchors=None: build(key, X, g, janchors))
    sigma = 1e-3 if task == "logit" else 1e-5
    jcfg = flgp_tpu.FitConfig(graph=flgp_tpu.GraphConfig(s=s, r=3, K=12), sigma=sigma,
                              dtype=jnp.float64, n_gibbs=20, gibbs_avg_sweeps=10,
                              train=flgp_tpu.TrainConfig(adam_steps=60, grid_size=12))
    name = f"fit_lae_{task}_gp"
    ref = getattr(flgp_tpu, name)(jax.random.PRNGKey(0), ds.x_train, ds.y_train, ds.x_test,
                                  cfg=jcfg, report=JMetricsReport())
    report = MetricsReport()
    got = getattr(ft, name)(gen(), ds.x_train, ds.y_train, ds.x_test,
                            cfg=fit_config_from_jax(jcfg), report=report,
                            anchors=anchors_from_numpy(centers, counts), device="cpu")
    keys = LOGIT_KEYS if task == "logit" else REGRESSION_KEYS
    assert set(got.metrics) == set(ref.metrics) == keys
    assert [st.name for st in report.stages] == ["spectrum", "train", "predict"]
    for k in keys - {"spectrum_s", "train_s", "predict_s"}:
        a, b = got.metrics[k], ref.metrics[k]
        if k in ("newton_iters", "opt_window_expansions"):
            assert a == b, k
        elif k in ("spectrum_orth_residual", "newton_final_delta"):
            assert abs(a - b) <= 1e-6, (k, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("spectrum_s", "train_s", "predict_s"):
        assert got.metrics[k] > 0
    np.testing.assert_allclose(got.posterior_mean, ref.posterior_mean, rtol=0, atol=1e-6)


@pytest.mark.parametrize("task", ["logit", "regression"])
def test_report_changes_no_output_bit(task):
    """The instrumented path consumes the generator as the plain path does:
    the subsampler's anchors, the labels and every output are the same bits."""
    ds, _ = _data(task)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=40, r=3, K=12), dtype=torch.float64,
                       n_gibbs=20, gibbs_avg_sweeps=10,
                       sigma=1e-3 if task == "logit" else 1e-5,
                       train=ft.TrainConfig(adam_steps=40, grid_size=12))
    fit = getattr(ft, f"fit_lae_{task}_gp")
    plain = fit(gen(3), ds.x_train, ds.y_train, ds.x_test, cfg=cfg, device="cpu")
    inst = fit(gen(3), ds.x_train, ds.y_train, ds.x_test, cfg=cfg, report=MetricsReport(),
               device="cpu")
    assert plain.metrics is None and inst.metrics is not None
    for name in ("y_train", "y_test", "posterior_mean", "posterior_cov"):
        assert np.array_equal(getattr(plain, name), getattr(inst, name)), name
    assert plain.pars.keys() == inst.pars.keys()
    for k in plain.pars:
        assert np.array_equal(plain.pars[k], inst.pars[k]), k
    assert plain.obj == inst.obj
    assert torch.equal(plain.eigenpair.vectors, inst.eigenpair.vectors)
