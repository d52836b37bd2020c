"""The SE-kernel regression with its bandwidth grid (``fit_se_regression_gp``)
against the benchmark's plain reference (``benchmark/reference/se_gpr.py``),
float64 on the CPU.

The fit runs through its public entry point on seeded spiral data, with a
four-point a² grid; the reference takes the fit's anchors and works out the
rest itself (its own kNN graph, every bandwidth's spectrum, every lane's
optimum of the posterior objective, the conditional mean and variance).
Both run in float64, so the tolerances below are rounding, each with its
reason.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import flgp_tpu_torch as ft
from flgp_tpu_torch.datasets import spiral
from flgp_tpu_torch.fit import drivers, spectral

torch.set_num_threads(1)

REF_PATH = Path(__file__).resolve().parent.parent / "benchmark" / "reference" / "se_gpr.py"
A2S = (0.1, 0.5, 2.0, 10.0)
TRAIN = dict(t_lb=1e-3, noise_lb=1e-4, prior_p=1.0, prior_q=10.0, prior_tau=2.0,
             prior_alpha=0.1, prior_beta=1e-3)
CFG = {"graph": {"s": 128, "r": 3, "K": 32}, "train": TRAIN,
       "fit": {"sigma": 1e-5, "a2s": list(A2S), "dtype": "float64"}}


def _reference():
    spec = importlib.util.spec_from_file_location("se_gpr_reference", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fit_and_read(train=None):
    """One fit, with what the reference reads of it (the anchors, the kNN
    lists, every bandwidth's eigenvalues and every lane's training, caught as
    the driver calls those stages), and the reference's readings; ``train``
    wraps the driver's training call."""
    ds = spiral(n=2000, m_train=100, seed=11)
    got = {"values": []}
    subsample, knn, spectrum_at = spectral.subsample, spectral.knn, spectral.se_spectrum_at
    train_gpr = drivers._train_gpr if train is None else train(drivers._train_gpr)

    def keep(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "values":
                got["values"].append(out.values)
            else:
                got[name] = out
            return out
        return wrapper

    cfg = ft.FitConfig(graph=ft.GraphConfig(s=128, r=3, K=32, kernel="se"), a2s=A2S,
                       sigma=1e-5, dtype=torch.float64)
    mp = pytest.MonkeyPatch()
    mp.setattr(spectral, "subsample", keep("sub", subsample))
    mp.setattr(spectral, "knn", keep("knn", knn))
    mp.setattr(spectral, "se_spectrum_at", keep("values", spectrum_at))
    mp.setattr(drivers, "_train_gpr", keep("lanes", train_gpr))
    try:
        res = ft.fit_se_regression_gp(torch.Generator().manual_seed(5), ds.x_train, ds.y_train,
                                      ds.x_test, cfg=cfg, device="cpu")
    finally:
        mp.undo()
    out = dict(centers=got["sub"].centers, counts=got["sub"].counts,
               idx=got["knn"].indices, values=torch.stack(got["values"]),
               lane_t=got["lanes"].t, lane_noise=got["lanes"].noise, lane_obj=got["lanes"].obj,
               a2=float(res.pars["a2"]), t=float(res.pars["t"]),
               noise=float(res.pars["noise"]), mean=res.posterior_mean, var=res.posterior_cov)
    readings = _reference().check(ds, out, CFG, torch.arange(100), torch.device("cpu"))
    return ds, res, out, readings


@pytest.fixture(scope="module")
def fitted():
    return _fit_and_read()


def test_the_anchors_and_the_knn_lists_are_the_reference_s(fitted):
    """Lloyd stops at a fixed point (each anchor the mean of its points, to the
    rounding of a float64 mean) and both kNN passes are exact in float64."""
    _, _, _, got = fitted
    assert got["count_gap"] == 0.0
    assert got["anchor_gap"] < 1e-10
    assert got["knn_rows_differ"] == 0.0


def test_every_bandwidth_s_eigenvalues_are_the_reference_s(fitted):
    """The port's dense gram against the reference's scatter-added one, each
    with its own float64 ``eigh``: differences of a few ulps of σ ≤ 1 (the
    128-anchor gram's sums carry about 1e-15 relative each)."""
    _, _, out, got = fitted
    assert out["values"].shape == (len(A2S), 32)
    assert got["eigenvalue_gap"] < 1e-11


def test_the_selected_bandwidth_and_its_objective_are_the_reference_s(fitted):
    """Every lane's objective as the fit computed it at the lane's (t, noise) is
    the reference's there but for the port's 1e-9 guards (½·m·1e-9/z in log z
    and 1e-9/t in log t: under 1e-7 nats here), the selected a² is the lane of
    the least, and the float64 reference's own minima pick the same.  The
    fit's point lies within 1e-5 nats of the reference's minimum in its lane,
    as does every lane's here: 200 Adam steps from the coarse grid's best
    cell converge much closer than that on this smooth two-parameter
    objective at this size."""
    _, res, _, got = fitted
    assert got["choice_disagree"] == 0.0
    assert got["a2_disagree"] == 0.0 and got["a2_fit"] == got["a2_ref_f64"]
    assert got["selection_gap"] == 0.0
    assert float(res.pars["a2"]) in A2S and got["a2_margin"] > 1e-3
    assert got["lane_objective_gap"] < 1e-6
    assert abs(got["objective_gap"]) < 1e-5
    assert got["lane_training_gap"] < 1e-5 and got["lanes_above_minimum"] == 0.0


def test_the_predictive_mean_and_variance_are_the_reference_s(fitted):
    """Woodbury (the port) against a dense Cholesky of C (the reference) in
    float64, both at the fit's (a², t, noise): C's condition number at z ≈ 1
    and t in the hundreds is under 1e4, so 1e-9 of the largest value holds
    with room.  The test error is the reference's own at its optimum, which
    lies about 1e-6 (relative) from the fit's in t: it moves the error by as
    much, so 1e-5."""
    ds, res, _, got = fitted
    assert res.posterior_mean.shape == res.posterior_cov.shape == (ds.x_test.shape[0],)
    assert got["mean_gap"] < 1e-9
    assert got["var_gap"] < 1e-9
    assert got["rmse_gap"] < 1e-5
    assert np.all(res.posterior_cov > 0)


def test_lanes_left_at_their_coarse_seeds_are_seen():
    """Every other bandwidth trained with no Adam step (its coarse grid's best
    cell, the fault of lanes left out of the training): the fit still picks a
    trained lane here, but the reference reads each untrained lane far above
    its own minimum (the worst 7.97 nats), where every lane of the sound fit
    lies within 1e-5 nats of it (2.4e-9 here)."""
    def half_untrained(train):
        def wrapper(eigenpair, Y, idx, K, cfg):
            full = train(eigenpair, Y, idx, K, cfg)
            cfg0 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, adam_steps=0))
            seeds = train(eigenpair, Y, idx, K, cfg0)
            odd = torch.arange(full.t.shape[0]) % 2 == 1
            return type(full)(*(torch.where(odd, b, a) for a, b in zip(full, seeds)))
        return wrapper

    _, _, _, got = _fit_and_read(half_untrained)
    assert got["lanes_above_minimum"] == len(A2S) // 2
    assert got["lane_training_gap"] > 1.0
    assert got["lane_objective_gap"] < 1e-6
