"""The benchmark cell ``torus1e7.streamed`` at a small shape on the CPU: the
out-of-core binary fit (``fit.streaming.fit_lae_logit_gp_streamed``) on a
two-ring torus written to an FLGP0001 file, judged by the cell's plain reference
(``benchmark/reference/lae_gpc_streamed.py``) against the cell's limits.

Every reading of a sound fit lies within the limits; a fit whose posterior
mean, t or variance was altered reads outside them; and the reference's own
reservoir draw from the file is the port's, row for row.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flgp_tpu_torch as ft
from flgp_tpu_torch import native
from flgp_tpu_torch.datasets import torus_rings
from flgp_tpu_torch.fit import streaming

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
N, M, S, R, K, CHUNK = 6000, 200, 64, 3, 32, 1000
CELL = "torus1e7.streamed"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"test_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(BENCH / "reference" / "lae_gpc_streamed.py")
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((BENCH / "configs" / "torus_lae_1e7_streamed.json").read_text())


def _small_config() -> dict:
    cfg = json.loads(json.dumps(CONFIG))
    cfg["data"].update(n=N, m_train=M)
    cfg["graph"].update(s=S, K=K)
    cfg["stream"].update(chunk_rows=CHUNK)
    return cfg


class _Data:
    def __init__(self, path, ds):
        self.path, self.y_train, self.y_test = path, ds.y_train, ds.y_test


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # two rings, which 64 anchors keep apart: six rings at this n and s merge
    # into a near-chance fit, where the sign of a mean near 0 is a coin toss
    ds = torus_rings(n=N, n_rings=2, m_train=M, seed=11)
    path = str(tmp_path_factory.mktemp("cell") / "x.flgp")
    native.write_matrix(path, np.concatenate([ds.x_train, ds.x_test]).astype(np.float32))
    return _Data(path, ds)


def _fit(data):
    """One fit at the cell's settings, and what the reference reads of it."""
    cfg = _small_config()
    g, f, t = cfg["graph"], cfg["fit"], cfg["train"]
    fit_cfg = ft.FitConfig(
        graph=ft.GraphConfig(s=g["s"], r=g["r"], K=g["K"], kernel=g["kernel"], gl=g["gl"],
                             root=g["root"], nstart=g["nstart"], kmeans_iters=g["kmeans_iters"]),
        train=ft.TrainConfig(approach=t["approach"], t_lb=t["t_lb"], t_ub=t["t_ub"],
                             grid_size=t["grid_size"], newton_tol=t["newton_tol"],
                             newton_max_iter=t["newton_max_iter"], prior_p_gpc=t["prior_p"],
                             prior_q=t["prior_q"], prior_tau=t["prior_tau"]),
        sigma=f["sigma"], n_gibbs=f["n_gibbs"], gibbs_avg_sweeps=f["gibbs_avg_sweeps"],
        dtype=torch.float32, solve_dtype=torch.float64)
    got = {}
    wrapped = {}
    for key, attr in (("sample", "reservoir_sample"), ("sub", "streamed_subsample"),
                      ("graph", "streamed_ell_graph"), ("eig", "spectrum_fused")):
        orig = getattr(streaming, attr)

        def wrapper(*a, _orig=orig, _key=key, **k):
            got[_key] = _orig(*a, **k)
            return got[_key]
        wrapped[attr] = wrapper
    rows = torch.as_tensor(np.concatenate([np.arange(M), M + np.arange(0, N - M, 7)]))
    mp = pytest.MonkeyPatch()
    try:
        for attr, w in wrapped.items():
            mp.setattr(streaming, attr, w)
        with native.MatrixFile(data.path) as mat:
            res = streaming.fit_lae_logit_gp_streamed(
                torch.Generator().manual_seed(3), mat, data.y_train, np.arange(M), cfg=fit_cfg,
                chunk_rows=CHUNK, device="cpu")
    finally:
        mp.undo()
    out = dict(sample=got["sample"], centers=got["sub"].centers, counts=got["sub"].counts,
               idx=got["graph"].indices, w=got["graph"].values, values=got["eig"].values,
               vectors=got["eig"].vectors[rows], t=np.atleast_1d(res.pars["t"].numpy()),
               mean=res.post_mean[M:].numpy(), var=res.post_var[rows[M:]],
               y_test=res.labels[M:].numpy())
    return out, rows, cfg


@pytest.fixture(scope="module")
def fitted(data):
    return _fit(data)


def _outside(readings: dict) -> list:
    return [k for k, limit in LIMITS.items() if not readings[k] <= limit]


def test_a_sound_fit_reads_within_every_limit(data, fitted):
    out, rows, cfg = fitted
    readings = ref.check(data, out, cfg, rows, torch.device("cpu"))
    assert set(LIMITS) <= set(readings)
    assert _outside(readings) == [], {k: readings[k] for k in LIMITS}
    assert readings["sample_differs"] == 0.0 and readings["label_disagree"] == 0.0


@pytest.mark.parametrize("fault,seen", [("mean", "mean_gap"), ("t", "objective_gap"),
                                        ("var", "var_gap")])
def test_an_altered_output_reads_outside_the_limits(data, fitted, fault, seen):
    out, rows, cfg = fitted
    out = dict(out)
    if fault == "mean":                         # the first test row's mean, negated
        out["mean"] = out["mean"].copy()
        out["mean"][0] = -out["mean"][0]
    elif fault == "t":                          # t at the bottom of its window
        out["t"] = np.full_like(out["t"], cfg["train"]["t_lb"])
    else:                                       # every variance halved
        out["var"] = 0.5 * out["var"]
    readings = ref.check(data, out, cfg, rows, torch.device("cpu"))
    assert seen in _outside(readings), {k: readings[k] for k in LIMITS}


@pytest.mark.parametrize("chunk,seed", [(CHUNK, 0), (777, 0), (CHUNK, 5)])
def test_the_reference_s_reservoir_is_the_port_s(data, chunk, seed):
    with native.MatrixFile(data.path) as mat:
        port = streaming.reservoir_sample(mat, 50 * S // 2, chunk, seed)
    own = ref.reservoir(ref.read_rows(data.path), 50 * S // 2, chunk, seed)
    assert own.dtype == port.dtype == np.float32
    assert np.array_equal(own, port)


def test_the_reference_reads_the_file_the_port_wrote(data):
    rows = ref.read_rows(data.path)
    with native.MatrixFile(data.path) as mat:
        assert rows.shape == mat.shape and rows.dtype == mat.dtype
        assert np.array_equal(np.asarray(rows[123:4567]), mat.read(123, 4444))
