"""Plain reference of the SE-kernel GP regression fit with its bandwidth grid.

Written from the method's definition in plain PyTorch, independent of
flgp_tpu_torch: it imports nothing of the port and takes from a fit only its
anchors and the points it judges.  The stages it shares with the LAE fits (nearest
anchors, cluster counts and means, the cluster-normalized spectrum and its
√n-scaled left vectors) are those of ``lae_gpc.py`` beside it, loaded by path.
Stages, each as the configuration states it:

- subsample (k-means): as in ``lae_gpc.py``;
- graph: the r nearest anchors of every point and their squared distances
  d², and d̄, the mean of d² over the n·r edges;
- spectrum, for each a² of the grid (``fit.a2s``): Z = exp(−d²/(a²·d̄)) on
  the edges, then ``lae_gpc.spectrum``: the cluster-normalized graph,
  A = Z·diag(colsum)^−½, the top K eigenpairs of AᵀA, σ = √eigenvalue, and the
  √n-scaled left singular vectors A·V/σ;
- train: for each a², the minimum of the GPR posterior objective on the m
  training rows, y ~ N(0, C) with C = V_m·diag(exp(−t(1−σ)))·V_mᵀ + z·I,
  z = noise + sigma:
  ½ yᵀC⁻¹y + ½ log det C + p·log t + (t/τ)^−q + (α+1)·log z + β/z
  (the Gaussian's ½ m log 2π left out, as the port leaves it out), over a
  dense grid of (log t, log noise) and then zoomed grids around the best
  cell; the selected a² is the lane of the least minimum.  Each lane's
  objective at its (t, noise) as the fit trained it is held to the fit's own
  value there and to the lane's minimum; the fit's choice is held to the least
  of its own values, and read against the a² of the least minimum, with the
  reference's own minimum in the fit's lane against the least of all lanes;
- predict: the Gaussian conditional mean C₂₁C⁻¹y and variance
  k(x, x) + z − C₂₁C⁻¹C₁₂ at every test row.

The objective is exact linear algebra in the rank-K structure of C: with
V_m = Q·R (thin QR) and R·diag(w)·Rᵀ = E·diag(μ)·Eᵀ, C has the eigenvalues
μ + z on span(Q) and z off it, so one small ``eigh`` a t serves every noise.
The reference runs in float64 (``F64``), with TF32 off.  ``CONTROL`` is the
control, the nearest precision below what the configuration states: the graph
stage's float32 products with their operands rounded to TF32 and a float32
tail.  ``control_fit`` puts it in the program's place.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location("bench_lae_gpc_stages",
                                               Path(__file__).with_name("lae_gpc.py"))
L = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(L)

F64, CONTROL = L.F64, L.CONTROL
GRID_T, GRID_NOISE = 281, 241        # the dense grid's points in log t and in log noise
T_TOP, NOISE_TOP = 1e5, 1e2          # its upper ends; the lower are t_lb and noise_lb
ZOOMS, ZOOM_POINTS = 8, 21           # zoomed grids, each over ± two cells of the last


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _points(data, cfg: dict, dev, dtype) -> torch.Tensor:
    """The points as the fit holds them (in the graph stage's dtype), in ``dtype``."""
    return torch.as_tensor(np.concatenate([data.x_train, data.x_test]), device=dev,
                           dtype=getattr(torch, cfg["fit"]["dtype"])).to(dtype)


def lane_spectra(idx: torch.Tensor, d2: torch.Tensor, counts: torch.Tensor, cfg: dict,
                 p) -> list:
    """One ``lae_gpc.Spectrum`` for each a² of the grid."""
    g = cfg["graph"]
    dbar = d2.mean()
    return [L.spectrum(torch.exp(-d2 / (a2 * dbar)), idx, counts, g["s"], g["K"], p)
            for a2 in cfg["fit"]["a2s"]]


class Lane:
    """The training objective of one bandwidth on the m training rows, for a
    batch of t and a batch of noise at once."""

    def __init__(self, values: torch.Tensor, Vm: torch.Tensor, y: torch.Tensor, cfg: dict):
        self.values, self.Vm, self.y, self.m = values, Vm, y, Vm.shape[0]
        self.Q, self.R = torch.linalg.qr(Vm, mode="reduced")
        self.Qy = self.Q.T @ y
        self.off = torch.clamp((y * y).sum() - (self.Qy * self.Qy).sum(), min=0.0)
        self.sigma, self.tr = cfg["fit"]["sigma"], cfg["train"]

    def _spectrum(self, t: torch.Tensor):
        """(μ (T, k), c² (T, k)): C's eigenvalues less z on span(Q), and the
        squared coordinates of y along their vectors."""
        w = torch.exp(-t[:, None] * (1.0 - self.values))                    # (T, K)
        # weights under √(smallest normal) are 0, so that M holds no subnormal
        # product (float32's eigh does not converge on those)
        w = torch.where(w < math.sqrt(torch.finfo(w.dtype).tiny), 0.0, w)
        M = (self.R * w[:, None, :]) @ self.R.T                            # (T, k, k)
        mu, E = torch.linalg.eigh(M)
        c = E.mT @ self.Qy
        return torch.clamp(mu, min=0.0), c * c

    def objective(self, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The objective at every (t, noise) pair of the two batches: (T, N)."""
        mu, c2 = self._spectrum(t)
        z = noise + self.sigma                                             # (N,)
        lam = mu[:, :, None] + z                                           # (T, k, N)
        quad = (c2[:, :, None] / lam).sum(1) + self.off / z
        logdet = torch.log(lam).sum(1) + (self.m - mu.shape[1]) * torch.log(z)
        tr = self.tr
        prior_t = tr["prior_p"] * torch.log(t) + (t / tr["prior_tau"]) ** (-tr["prior_q"])
        prior_z = (tr["prior_alpha"] + 1.0) * torch.log(z) + tr["prior_beta"] / z
        return 0.5 * quad + 0.5 * logdet + prior_t[:, None] + prior_z[None, :]

    def minimize(self):
        """(t, noise, value) of the least objective: a dense grid of (log t,
        log noise), then zoomed grids, each over ± two cells of the last."""
        tr, dt = self.tr, self.values.dtype
        lo = torch.tensor([math.log(tr["t_lb"]), math.log(tr["noise_lb"])], dtype=dt,
                          device=self.values.device)
        hi = torch.tensor([math.log(T_TOP), math.log(NOISE_TOP)], dtype=dt, device=lo.device)
        u = torch.linspace(0.0, 1.0, GRID_T, dtype=dt, device=lo.device) * (hi[0] - lo[0]) + lo[0]
        v = torch.linspace(0.0, 1.0, GRID_NOISE, dtype=dt, device=lo.device) * (hi[1] - lo[1]) \
            + lo[1]
        for _ in range(ZOOMS + 1):
            F = self.objective(torch.exp(u), torch.exp(v))
            F = torch.where(torch.isfinite(F), F, torch.full_like(F, float("inf")))
            k = int(torch.argmin(F))
            i, j = divmod(k, F.shape[1])
            best = (u[i], v[j], F[i, j])
            hu, hv = 2.0 * (u[1] - u[0]), 2.0 * (v[1] - v[0])
            u = torch.clamp(torch.linspace(-1.0, 1.0, ZOOM_POINTS, dtype=dt, device=lo.device)
                            * hu + best[0], lo[0], hi[0])
            v = torch.clamp(torch.linspace(-1.0, 1.0, ZOOM_POINTS, dtype=dt, device=lo.device)
                            * hv + best[1], lo[1], hi[1])
        return torch.exp(best[0]), torch.exp(best[1]), best[2]


def predict(values: torch.Tensor, Vm: torch.Tensor, Vt: torch.Tensor, y: torch.Tensor, t, noise,
            sigma: float):
    """Predictive mean and variance at the rows of Vt, from the dense m × m
    C = V_m·diag(w)·V_mᵀ + z·I by Cholesky: C₂₁C⁻¹y, and
    k(x, x) + z − C₂₁C⁻¹C₁₂ with C₂₁ = V_t·diag(w)·V_mᵀ."""
    w = torch.exp(-t * (1.0 - values))
    z = noise + sigma
    C = (Vm * w) @ Vm.T + z * torch.eye(Vm.shape[0], dtype=Vm.dtype, device=Vm.device)
    Lc = torch.linalg.cholesky(C)
    alpha = torch.cholesky_solve(y[:, None], Lc)[:, 0]
    mean = Vt @ (w * (Vm.T @ alpha))
    P = (w[:, None] * (Vm.T @ torch.cholesky_solve(Vm, Lc))) * w[None, :]     # (K, K)
    var = ((Vt * Vt) * w).sum(1) + z - ((Vt @ P) * Vt).sum(1)
    return mean, var


def _lanes(sps: list, y: torch.Tensor, m: int, cfg: dict, dtype) -> list:
    """Each bandwidth's training objective on the values the fit hands to its
    solve tail (rounded to the graph stage's dtype)."""
    idx = torch.arange(m, device=y.device)
    return [Lane(L.handed_over(sp, cfg).values.to(dtype), L.vectors(sp, idx).to(dtype), y, cfg)
            for sp in sps]


# ---------------------------------------------------------------------------
# the check: the reference's readings of one fit's outputs
# ---------------------------------------------------------------------------


def check(data, out: dict, cfg: dict, rows: torch.Tensor, dev) -> dict:
    """Every number compared, for the outputs ``out`` of one fit on ``data``.

    ``out`` holds what the fit produced, moved to the host: ``centers`` (s,
    d), ``counts`` (s,), the kNN lists ``idx`` (n, r), every bandwidth's
    ``values`` (A, K), every lane's trained ``lane_t``, ``lane_noise`` and
    objective ``lane_obj`` (A,), the selected ``a2``, ``t`` and ``noise``, and
    the predictive ``mean`` and ``var`` at the test rows.  The reference takes
    the fit's anchors, as it cannot replay the fit's random draw, and judges
    them by themselves; it judges each lane's objective value at the lane's
    (t, noise) and how far above the lane's minimum that lies, the fit's
    choice of a² against the least of those values and against its own, the
    selected (t, noise) by its own objective
    there against its own minimum in the fit's lane, and the
    fit's mean and variance against its own at the fit's (a², t, noise), at
    every test row (``rows`` is not needed)."""
    _no_tf32()
    g, fit = cfg["graph"], cfg["fit"]
    s, r = g["s"], g["r"]
    X = _points(data, cfg, dev, torch.float64)
    n, m = X.shape[0], data.x_train.shape[0]
    U = torch.as_tensor(out["centers"], device=dev).to(torch.float64)
    got = {}

    # subsample: the fit's anchors against the points' own nearest anchors,
    # and Lloyd's fixed point (as in lae_gpc.check)
    assign = L.nearest(X, U, 1, F64)[0][:, 0]
    counts = L.counts_of(assign, s, torch.float64)
    got["count_gap"] = float(torch.abs(counts - torch.as_tensor(out["counts"], device=dev)
                                       .to(torch.float64)).sum()) / (2 * n)
    means = L.cluster_means(X, assign, s)
    rms = torch.sqrt(((X - U[assign]) ** 2).sum(1).mean())
    got["anchor_gap"] = float(torch.sqrt(((U - means) ** 2).sum(1)[counts > 0].mean()) / rms)
    del means

    # graph: the fit's lists against the nearest anchors
    idx, d2 = L.nearest(X, U, r, F64)
    idx_fit = torch.as_tensor(out["idx"], device=dev).long()
    same = (torch.sort(idx, 1).values == torch.sort(idx_fit, 1).values).all(1)
    got["knn_rows_differ"] = float((~same).sum()) / n
    del idx_fit, same

    # spectrum, from the reference's own graph, every bandwidth
    sps = lane_spectra(idx, d2, counts, cfg, F64)
    vf = torch.as_tensor(out["values"], device=dev).to(torch.float64)
    got["eigenvalue_gap"] = max(float(torch.abs(vf[a] - sp.values).max())
                                for a, sp in enumerate(sps))

    # train: the reference's own optimum in every lane
    y = torch.as_tensor(data.y_train, device=dev, dtype=torch.float64)
    lanes = _lanes(sps, y, m, cfg, torch.float64)
    opt = [lane.minimize() for lane in lanes]
    best = torch.stack([o[2] for o in opt])
    a2s = fit["a2s"]
    a_fit = min(range(len(a2s)), key=lambda a: abs(a2s[a] - out["a2"]))
    t_fit = torch.tensor(out["t"], dtype=torch.float64, device=dev)
    noise_fit = torch.tensor(out["noise"], dtype=torch.float64, device=dev)
    at_fit = lanes[a_fit].objective(t_fit[None], noise_fit[None])[0, 0]
    got["objective_gap"] = float(at_fit - best[a_fit])
    got["t_fit"], got["noise_fit"] = float(t_fit), float(noise_fit)
    got["t_ref"], got["noise_ref"] = float(opt[a_fit][0]), float(opt[a_fit][1])

    # every lane's training: the fit's objective value at the lane's (t, noise)
    # against the reference's there, and how far above the lane's minimum that
    # point lies (a lane left untrained reads nats here)
    lt, ln, lo = (torch.as_tensor(out[k], device=dev).to(torch.float64)
                  for k in ("lane_t", "lane_noise", "lane_obj"))
    at_lanes = torch.stack([lane.objective(lt[a:a + 1], ln[a:a + 1])[0, 0]
                            for a, lane in enumerate(lanes)])
    got["lane_objective_gap"] = float(torch.abs(lo - at_lanes).max())
    got["lanes_above_minimum"] = float(((at_lanes - best) > 0.01).sum())
    got["lane_training_gap"] = float((at_lanes - best).max())
    # the choice: the fit's a² against the least of its own lanes' values (the
    # first on ties; each value held to the reference's by lane_objective_gap,
    # each lane's training by lane_training_gap), and against the lane of the
    # least float64 minimum, with the nats between the minimum in the fit's
    # lane and that least one (200 Adam steps can leave a wide lane nats above
    # its minimum, and the fit then chooses among the lanes it trained)
    a_ref = int(torch.argmin(best))
    got["choice_disagree"] = float(a_fit != int(torch.argmin(lo)))
    got["a2_disagree"] = float(a_fit != a_ref)
    got["selection_gap"] = float(best[a_fit] - best[a_ref])
    got["a2_fit"], got["a2_ref_f64"] = a2s[a_fit], a2s[a_ref]
    got["a2_margin"] = float(torch.sort(best).values[1] - best.min())

    # predict: the conditional mean and variance at the fit's (a², t, noise)
    test = torch.arange(m, n, device=dev)
    lane, Vt = lanes[a_fit], L.vectors(sps[a_fit], test)
    mean, var = predict(lane.values, lane.Vm, Vt, y, t_fit, noise_fit, fit["sigma"])
    mean_fit = torch.as_tensor(out["mean"], device=dev).to(torch.float64)
    var_fit = torch.as_tensor(out["var"], device=dev).to(torch.float64)
    got["mean_gap"] = float(torch.abs(mean_fit - mean).max() / torch.abs(mean).max())
    got["var_gap"] = float(torch.abs(var_fit - var).max() / torch.abs(var).max())

    # the test error against the reference's at its own optimum in the fit's lane
    y_test = torch.as_tensor(data.y_test, device=dev, dtype=torch.float64)
    mean_ref, _ = predict(lane.values, lane.Vm, Vt, y, opt[a_fit][0], opt[a_fit][1],
                          fit["sigma"])
    rmse_fit = float(torch.sqrt(((mean_fit - y_test) ** 2).mean()))
    rmse_ref = float(torch.sqrt(((mean_ref - y_test) ** 2).mean()))
    got["rmse_gap"] = abs(rmse_fit - rmse_ref) / rmse_ref
    got["rmse_fit"], got["rmse_ref"] = rmse_fit, rmse_ref
    return got


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, one precision down
# ---------------------------------------------------------------------------


def control_fit(data, cfg: dict, rows: torch.Tensor, seed: int, dev, p=CONTROL) -> dict:
    """A whole fit by the reference's arithmetic at precision p, in the layout
    ``check`` reads: anchors (Lloyd from uniform rows), graph, every
    bandwidth's spectrum, each lane's optimum, the selected lane's mean and
    variance."""
    _no_tf32()
    g, fit = cfg["graph"], cfg["fit"]
    s, r = g["s"], g["r"]
    X = _points(data, cfg, dev, p.graph)
    n, m = X.shape[0], data.x_train.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = X[torch.randperm(n, generator=gen, device=dev)[:s]]
    if p.tf32:
        U = L.tf32(U)
    assign = L.nearest(X, U, 1, p)[0][:, 0]
    for _ in range(g["kmeans_iters"]):
        cnt = L.counts_of(assign, s, p.graph)
        U = torch.where(cnt[:, None] > 0, L.cluster_means(X, assign, s), U)
        new = L.nearest(X, U, 1, p)[0][:, 0]
        moved = bool((new != assign).any())
        assign = new
        if not moved:
            break
    counts = L.counts_of(assign, s, p.graph)
    idx, d2 = L.nearest(X, U, r, p)
    sps = lane_spectra(idx, d2, counts, cfg, p)
    y = torch.as_tensor(data.y_train, device=dev, dtype=p.tail)
    lanes = _lanes(sps, y, m, cfg, p.tail)
    opt = [torch.stack(lane.minimize()) for lane in lanes]
    lane_t, lane_noise, lane_obj = torch.stack(opt).T
    a = int(torch.argmin(lane_obj))
    t, noise, _ = opt[a]
    lane = lanes[a]
    Vt = L.vectors(sps[a], torch.arange(m, n, device=dev)).to(p.tail)
    mean, var = predict(lane.values, lane.Vm, Vt, y, t, noise, fit["sigma"])
    return dict(centers=U.cpu(), counts=counts.cpu(), idx=idx.cpu(),
                values=torch.stack([sp.values for sp in sps]).cpu(), lane_t=lane_t.cpu(),
                lane_noise=lane_noise.cpu(), lane_obj=lane_obj.cpu(), a2=fit["a2s"][a],
                t=float(t), noise=float(noise), mean=mean.cpu(), var=var.cpu())
