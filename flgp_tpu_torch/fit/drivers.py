"""Fit drivers: binary GP classification and GP regression with the LAE, SE,
Nyström and GLGP bases.

Each driver is a host-side orchestrator over the stages: spectral basis,
empirical-Bayes training (the diffusion time t for classification, (t, noise)
for regression), then prediction and posterior moments.  The SE, Nyström and
GLGP drivers train once per point of a bandwidth grid and keep the point of
the largest objective (the first on ties), holding only the best basis so
far.  PyTorch runs eagerly, so each stage launches its own work on the chosen
device: the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (
    Approach,
    FitConfig,
    KernelType,
    NoiseModel,
    default_a2s,
    pin_full_precision,
    resolve_device,
)
from ..convert import anchors_from_numpy
from ..inference.optimize import (
    GprOptResult,
    Scalar1DResult,
    minimize_1d_log,
    minimize_t_noise,
    minimize_t_noisevec,
)
from ..inference.pg_gibbs import test_pgbinary
from ..models import gpc as gpc_mod
from ..models import gpr as gpr_mod
from ..ops import linalg
from ..ops.heat_kernel import heat_kernel, heat_kernel_diag
from ..ops.kmeans import SubsampleResult
from ..types import EigenPair
from . import spectral


@dataclasses.dataclass
class FitResult:
    """Labels, posterior moments and learned parameters of a fit."""

    y_train: np.ndarray
    y_test: np.ndarray
    posterior_mean: np.ndarray
    posterior_cov: np.ndarray
    pars: Dict[str, np.ndarray]
    obj: float
    C: Optional[np.ndarray] = None
    eigenpair: Optional[EigenPair] = None
    metrics: Optional[Dict[str, float]] = None


def _start(generator: torch.Generator, device) -> torch.device:
    """Pin float32 products to full precision and settle the device: the CUDA
    device unless the caller names one, and the generator must live there."""
    pin_full_precision()
    device = resolve_device(device, "the fit drivers")
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, fit on {device}")
    return device


def _concat_all(X, X_new, dtype, device):
    X = torch.as_tensor(X, dtype=dtype, device=device)
    X_new = torch.as_tensor(X_new, dtype=dtype, device=device)
    return torch.cat([X, X_new], dim=0), X.shape[0], X.shape[0] + X_new.shape[0]


def _solve_cast(cfg: FitConfig, eigenpair: EigenPair, *arrays):
    """Cast the spectral pair + data to ``cfg.solve_dtype`` for the solve
    tail.  No-op when unset."""
    dt = cfg.solve_dtype
    if dt is None or dt == cfg.dtype:
        return cfg, eigenpair, arrays
    cfg = dataclasses.replace(cfg, dtype=dt)
    eigenpair = EigenPair(eigenpair.values.to(dt), eigenpair.vectors.to(dt))
    return cfg, eigenpair, tuple(a.to(dt) for a in arrays)


def _as_anchors(anchors, dtype, device) -> Optional[SubsampleResult]:
    """Normalize a user-provided (centers, sizes) anchor override."""
    if anchors is None:
        return None
    centers, counts = anchors
    return anchors_from_numpy(centers, counts, device=device, dtype=dtype)


def _train_gpr(eigenpair: EigenPair, Y, idx, K: int, cfg: FitConfig) -> GprOptResult:
    """Empirical-Bayes (t, noise).  A pair with a leading batch axis
    (``values`` (A, K), ``vectors`` (A, rows, K)) holds the A lanes of a
    bandwidth grid: one coarse grid and one Adam run serve all lanes, and
    every field of the result has shape (A,) (noise (A, m) under the
    per-point model)."""
    tc = cfg.train
    batched = eigenpair.values.dim() == 2
    # the optimizers hand t as (lanes, points): give the pair a points axis
    pair = EigenPair(eigenpair.values[:, None], eigenpair.vectors[:, None]) if batched else eigenpair

    def fn(t, noise):
        if tc.approach == Approach.POSTERIOR:
            return gpr_mod.gpr_nmll_posterior(
                pair, Y, idx, K, t, noise, cfg.sigma,
                p=tc.prior_p_gpr, q=tc.prior_q, tau=tc.prior_tau,
                alpha=tc.prior_alpha, beta=tc.prior_beta,
            )
        return gpr_mod.gpr_nmll(pair, Y, idx, K, t, noise, cfg.sigma)

    common = dict(t_lb=tc.t_lb, noise_lb=tc.noise_lb, adam_lr=tc.adam_lr, dtype=cfg.dtype,
                  device=eigenpair.values.device,
                  lanes=eigenpair.values.shape[0] if batched else 1)
    if tc.noise == NoiseModel.SAME:
        res = minimize_t_noise(fn, adam_steps=tc.adam_steps, **common)
    else:
        res = minimize_t_noisevec(fn, Y.shape[0], t0=tc.t0, noise0=tc.noise0,
                                  adam_steps=max(tc.adam_steps, 400), **common)
    return res if batched else GprOptResult(*(v[0] for v in res))


def _train_gpc(eigenpair: EigenPair, Y, N, idx, K: int, cfg: FitConfig) -> Scalar1DResult:
    tc = cfg.train

    def obj_at(t, max_iter):
        if tc.approach == Approach.POSTERIOR:
            return gpc_mod.gpc_nlp_objective(
                eigenpair, Y, N, idx, K, t, cfg.sigma,
                p=tc.prior_p_gpc, q=tc.prior_q, tau=tc.prior_tau,
                tol=tc.newton_tol, max_iter=max_iter,
            )
        return gpc_mod.gpc_nmll_objective(
            eigenpair, Y, N, idx, K, t, cfg.sigma, tol=tc.newton_tol, max_iter=max_iter,
        )

    # The coarse scan ranks cells that differ by orders of magnitude, so a
    # 30-iteration Newton budget ranks them as well as the full one while
    # extreme-t lanes stop early; refinement uses the full budget.
    coarse_cap = min(30, tc.newton_max_iter)
    return minimize_1d_log(
        lambda t: obj_at(t, tc.newton_max_iter),
        lo=tc.t_lb, hi=tc.t_ub, n_grid=tc.grid_size, dtype=cfg.dtype,
        coarse_fn=lambda t: obj_at(t, coarse_cap), device=eigenpair.values.device,
    )


def _gpr_tail(eigenpair: EigenPair, Y, m: int, n: int, K: int, cfg: FitConfig, t, noise):
    """Prediction + posterior for regression."""
    idx0, idx1 = slice(0, m), slice(m, n)
    train_pred = gpr_mod.gpr_predict(eigenpair, Y, idx0, idx0, K, t, noise, cfg.sigma)
    test_pred = gpr_mod.gpr_predict(eigenpair, Y, idx0, idx1, K, t, noise, cfg.sigma)
    # the posterior covariance takes the scalar noise[0] even under the
    # per-point model, as the reference does
    noise0 = noise if noise.dim() == 0 else noise[0]
    cov = gpr_mod.gpr_posterior_cov(eigenpair, idx0, idx1, K, t, noise0, cfg.sigma)
    out = dict(train=train_pred, test=test_pred, cov=cov)
    if cfg.output_cov:
        out["C"] = heat_kernel(eigenpair, t, K, slice(0, n), idx0)
    return out


def _gpc_tail(generator, eigenpair: EigenPair, Y, N, m: int, n: int, K: int, cfg: FitConfig,
              t, max_count: int):
    """PG-Gibbs labels + Laplace posterior for binary GPC."""
    # C = [Cvv + σI; Cnv] as one (n, m) block; Cvv and Cnv are views of it
    C = heat_kernel(eigenpair, t, K, slice(0, n), slice(0, m))
    Cvv, Cnv = C[:m], C[m:]
    Cvv.diagonal().add_(cfg.sigma)

    Cnn = heat_kernel_diag(eigenpair, t, K, slice(m, n)) + cfg.sigma
    post_mean, post_cov = gpc_mod.gpc_posterior_moments(Cvv, Cnv, Cnn, Y)

    label_pred, _ = test_pgbinary(
        generator, Cvv, Y, C, cfg.n_gibbs, N, max_count, avg_sweeps=cfg.gibbs_avg_sweeps
    )
    out = dict(train=label_pred[:m], test=label_pred[m:], mean=post_mean, cov=post_cov)
    if cfg.output_cov:
        out["C"] = C
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_result(out, pars, obj, eigenpair=None, metrics=None) -> FitResult:
    return FitResult(
        y_train=_np(out["train"]),
        y_test=_np(out["test"]),
        posterior_mean=_np(out.get("mean", out["test"])),
        posterior_cov=_np(out["cov"]),
        pars={k: _np(v) for k, v in pars.items()},
        obj=float(obj),
        C=_np(out["C"]) if "C" in out else None,
        eigenpair=eigenpair,
        metrics=metrics,
    )


def _resolve(cfg: FitConfig, task: str) -> FitConfig:
    """Apply the task's default σ (1e-5 regression, 1e-3 logit) when the
    caller left the generic default in place."""
    if task == "regression" and cfg.sigma == 1e-3:
        cfg = dataclasses.replace(cfg, sigma=1e-5)
    return cfg


def _a2_grid(cfg: FitConfig) -> torch.Tensor:
    """The bandwidth grid as a float64 tensor on the host; each point enters
    the device arithmetic as a scalar."""
    return torch.as_tensor(default_a2s() if cfg.a2s is None else np.asarray(cfg.a2s, np.float64))


def _counts(N, m: int, dtype, device) -> Tuple[torch.Tensor, int]:
    """Binomial trial counts (default: ones) and their maximum."""
    if N is None:
        return torch.ones((m,), dtype=dtype, device=device), 1
    return torch.as_tensor(N, dtype=dtype, device=device), int(np.max(_np(N)))


def _first_min(objs) -> int:
    """Index of the smallest objective, the first on ties (NaN counts as the
    smallest, as it does for the reference's argmax of the negated values)."""
    return int(torch.argmin(torch.stack([o.detach().reshape(()) for o in objs])))


# ---------------------------------------------------------------------------
# LAE drivers (no bandwidth grid)
# ---------------------------------------------------------------------------
# With a ``utils.metrics.MetricsReport`` as ``report`` the stages (spectrum,
# train, predict) are timed with a device sync at each stage's end, and
# ``FitResult.metrics`` carries their walls and the solvers' status.  The
# stages are the plain path's calls in the plain path's order and the status
# draws nothing, so ``report`` changes no output bit.


def _stage(report, name: str):
    return contextlib.nullcontext({}) if report is None else report.stage(name)


def _orth_residual(eig: EigenPair) -> float:
    """‖VᵀV/n − I‖_F / K for the √n-scaled eigenvectors (full float32)."""
    V = eig.vectors
    VtV = linalg.pdot(V.T, V) / V.shape[0]
    eye = torch.eye(VtV.shape[0], dtype=VtV.dtype, device=VtV.device)
    return float(torch.linalg.norm(VtV - eye) / VtV.shape[0])


def _lae_fit(generator, X_all, Y, N_arr, max_count: int, m: int, n: int, cfg: FitConfig,
             anchors, task: str, report) -> FitResult:
    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    K = min(g.resolved_K(), g.s, n)
    metrics: Dict[str, float] = {}
    with _stage(report, "spectrum") as slot:
        eig, _ = spectral.build_spectrum(generator, X_all, g, anchors)
        slot["_sync"] = eig.vectors
    if report is not None:
        metrics["spectrum_s"] = report.stages[-1].wall_s
        metrics["spectrum_orth_residual"] = _orth_residual(eig)
    if task == "regression":
        scfg, seig, (Ys,) = _solve_cast(cfg, eig, Y)
        with _stage(report, "train") as slot:
            res = _train_gpr(seig, Ys, slice(0, m), K, scfg)
            slot["_sync"] = res.t
        if report is not None:
            metrics.update(train_s=report.stages[-1].wall_s,
                           adam_grad_norm=float(res.grad_norm), train_obj=float(res.obj))
        with _stage(report, "predict") as slot:
            out = _gpr_tail(seig, Ys, m, n, K, scfg, res.t, res.noise)
            slot["_sync"] = out["test"]
        pars, obj = dict(t=res.t, noise=res.noise), -res.obj
    else:
        scfg, seig, (Ys, Ns) = _solve_cast(cfg, eig, Y, N_arr)
        with _stage(report, "train") as slot:
            res = _train_gpc(seig, Ys, Ns, slice(0, m), K, scfg)
            slot["_sync"] = res.x
        if report is not None:
            # the refiner's bracket and the Newton status at the selected t
            # (iterations == max_iter with delta >= tol: not converged)
            _, n_it, n_delta = gpc_mod.gpc_nmll_objective_status(
                seig, Ys, Ns, slice(0, m), K, res.x, scfg.sigma,
                tol=scfg.train.newton_tol, max_iter=scfg.train.newton_max_iter)
            metrics.update(train_s=report.stages[-1].wall_s,
                           opt_bracket_logwidth=float(res.bracket_logwidth),
                           opt_window_expansions=float(res.n_expansions),
                           newton_iters=float(n_it), newton_final_delta=float(n_delta))
        with _stage(report, "predict") as slot:
            out = _gpc_tail(generator, seig, Ys, Ns, m, n, K, scfg, res.x, max_count)
            slot["_sync"] = out["test"]
        pars, obj = dict(t=res.x), -res.obj
    if report is not None:
        metrics["predict_s"] = report.stages[-1].wall_s
    return _to_result(out, pars, obj, eig, metrics if report is not None else None)


def fit_lae_regression_gp(generator: torch.Generator, X, Y, X_new,
                          cfg: FitConfig = FitConfig(sigma=1e-5), report=None, anchors=None,
                          device=None) -> FitResult:
    """GPR with the LAE kernel.

    ``generator`` drives every random draw and must live on ``device``: the
    CUDA device by default, the CPU only with ``device="cpu"``.  ``report``:
    an optional ``utils.metrics.MetricsReport`` that times the stages and
    fills ``FitResult.metrics`` (``spectrum_s``, ``spectrum_orth_residual``,
    ``train_s``, ``adam_grad_norm``, ``train_obj``, ``predict_s``).
    ``anchors``: optional (centers, sizes) subsampler override.  Inputs may
    be numpy arrays or tensors; outputs are numpy arrays, the eigenpair
    stays on the device."""
    device = _start(generator, device)
    cfg = _resolve(cfg, "regression")
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    return _lae_fit(generator, X_all, Y, None, 1, m, n, cfg,
                    _as_anchors(anchors, cfg.dtype, device), "regression", report)


def fit_lae_logit_gp(generator: torch.Generator, X, Y, X_new, N=None,
                     cfg: FitConfig = FitConfig(), report=None, anchors=None,
                     device=None) -> FitResult:
    """Binary GPC with the LAE kernel.  Arguments as in
    :func:`fit_lae_regression_gp`; ``N``: optional binomial trial counts.
    With ``report`` the metrics are ``spectrum_s``,
    ``spectrum_orth_residual``, ``train_s``, ``opt_bracket_logwidth``,
    ``opt_window_expansions``, ``newton_iters``, ``newton_final_delta`` and
    ``predict_s``."""
    device = _start(generator, device)
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    N_arr, max_count = _counts(N, m, cfg.dtype, device)
    return _lae_fit(generator, X_all, Y, N_arr, max_count, m, n, cfg,
                    _as_anchors(anchors, cfg.dtype, device), "logit", report)


# ---------------------------------------------------------------------------
# Bandwidth-grid drivers: SE, Nyström, GLGP
# ---------------------------------------------------------------------------
# One body per task; a family is its ``spectrum_at(a2) -> (pair, extra)``, the
# pair to train on and a small extra, and ``extend(pair, extra, a2) -> (full
# pair, metrics or None)`` (the Nyström drivers train on the m training rows'
# extension and extend to all n rows for the winner only).
#
# Classification trains one bandwidth after the other (each training is
# already one batched Newton solve over its t grid) and keeps the best pair so
# far.  Regression trains every bandwidth as one lane of a single Adam run on
# the lanes' m training rows, and keeps every grid point's pair until the
# winner is known (A pairs of (n, K), as the reference's stacked grid does).
# Either way only one (n, n) GLGP graph is alive at a time.


def _grid_regression(Y, m: int, n: int, K: int, cfg: FitConfig, spectrum_at, extend):
    a2s = _a2_grid(cfg).tolist()
    grid = [spectrum_at(a2) for a2 in a2s]
    lanes = EigenPair(torch.stack([pair.values for pair, _ in grid]),
                      torch.stack([pair.vectors[:m] for pair, _ in grid]))
    scfg, slanes, (Ys,) = _solve_cast(cfg, lanes, Y)
    res = _train_gpr(slanes, Ys, slice(0, m), K, scfg)
    best = _first_min(res.obj)
    t, noise, obj, a2 = res.t[best], res.noise[best], res.obj[best], a2s[best]
    eig, metrics = extend(*grid[best], a2)
    scfg, seig, (Ys,) = _solve_cast(cfg, eig, Y)
    out = _gpr_tail(seig, Ys, m, n, K, scfg, t, noise)
    return _to_result(out, dict(t=t, noise=noise, a2=a2), -obj, eig, metrics)


def _grid_logit(generator, Y, N_arr, max_count: int, m: int, n: int, K: int,
                cfg: FitConfig, spectrum_at, extend):
    objs, best = [], None
    for a2 in _a2_grid(cfg).tolist():
        pair, extra = spectrum_at(a2)
        scfg, seig, (Ys, Ns) = _solve_cast(cfg, pair, Y, N_arr)
        res = _train_gpc(seig, Ys, Ns, slice(0, m), K, scfg)
        objs.append(res.obj)
        if _first_min(objs) == len(objs) - 1:
            best = (pair, extra, a2, res)
    pair, extra, a2, res = best
    eig, metrics = extend(pair, extra, a2)
    scfg, seig, (Ys, Ns) = _solve_cast(cfg, eig, Y, N_arr)
    out = _gpc_tail(generator, seig, Ys, Ns, m, n, K, scfg, res.x, max_count)
    return _to_result(out, dict(t=res.x, a2=a2), -res.obj, eig, metrics)


def _se_family(generator, X_all, cfg: FitConfig, anchors, device):
    g = cfg.graph
    basis = spectral.se_grid_setup(generator, X_all, g, _as_anchors(anchors, cfg.dtype, device))

    def spectrum_at(a2):
        return spectral.se_spectrum_at(basis, a2, g), None

    return (min(g.resolved_K(), g.s, X_all.shape[0]), spectrum_at,
            lambda pair, extra, a2: (pair, None))


def fit_se_regression_gp(generator: torch.Generator, X, Y, X_new,
                         cfg: FitConfig = FitConfig(sigma=1e-5), anchors=None,
                         device=None) -> FitResult:
    """GPR with the SE kernel and a bandwidth grid search.  Arguments as in
    :func:`fit_lae_regression_gp`; ``pars["a2"]`` is the selected bandwidth."""
    device = _start(generator, device)
    cfg = _resolve(cfg, "regression")
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    K, spectrum_at, extend = _se_family(generator, X_all, cfg, anchors, device)
    return _grid_regression(Y, m, n, K, cfg, spectrum_at, extend)


def fit_se_logit_gp(generator: torch.Generator, X, Y, X_new, N=None,
                    cfg: FitConfig = FitConfig(), anchors=None, device=None) -> FitResult:
    """Binary GPC with the SE kernel and a bandwidth grid."""
    device = _start(generator, device)
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    N_arr, max_count = _counts(N, m, cfg.dtype, device)
    K, spectrum_at, extend = _se_family(generator, X_all, cfg, anchors, device)
    return _grid_logit(generator, Y, N_arr, max_count, m, n, K, cfg, spectrum_at, extend)


def _nystrom_family(generator, X_all, m: int, cfg: FitConfig, basis=None):
    """``basis``: a precomputed ``NystromBasis`` in place of the random
    subsample (parity runs)."""
    g = cfg.graph
    K = min(g.resolved_K(), g.s)
    if basis is None:
        basis = spectral.nystrom_setup(generator, X_all, g)

    def spectrum_at(a2):
        anchor, Z_UU = spectral.nystrom_anchor_eigs(basis, a2, K)
        eig_train = spectral.nystrom_extend(anchor, Z_UU, basis.dist_allU[:m], a2,
                                            basis.dist_mean, False, rcond=g.nystrom_rcond)
        return eig_train, (anchor, Z_UU)

    def extend(pair, extra, a2):
        anchor, Z_UU = extra
        return spectral.nystrom_extend(anchor, Z_UU, basis.dist_allU, a2, basis.dist_mean, True,
                                       rcond=g.nystrom_rcond), None

    return K, spectrum_at, extend


def fit_nystrom_regression_gp(generator: torch.Generator, X, Y, X_new,
                              cfg: FitConfig = FitConfig(sigma=1e-5), device=None) -> FitResult:
    """GPR via the Nyström extension of the anchor diffusion operator."""
    device = _start(generator, device)
    cfg = _resolve(cfg, "regression")
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    K, spectrum_at, extend = _nystrom_family(generator, X_all, m, cfg)
    return _grid_regression(Y, m, n, K, cfg, spectrum_at, extend)


def fit_nystrom_logit_gp(generator: torch.Generator, X, Y, X_new, N=None,
                         cfg: FitConfig = FitConfig(), device=None) -> FitResult:
    """Binary GPC via the Nyström extension."""
    device = _start(generator, device)
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    N_arr, max_count = _counts(N, m, cfg.dtype, device)
    K, spectrum_at, extend = _nystrom_family(generator, X_all, m, cfg)
    return _grid_logit(generator, Y, N_arr, max_count, m, n, K, cfg, spectrum_at, extend)


def _gl_family(generator, X_all, cfg: FitConfig):
    """The exact graph Laplacian over all n points: dense ``eigh`` or, with
    ``gl_solver="lobpcg"``, LOBPCG on the sparse operator.  The winner's
    metrics carry the eigensolver's largest residual norm (0 for ``eigh``).
    Every grid point starts LOBPCG from the same random block."""
    n = X_all.shape[0]
    K = min(cfg.graph.K, n) if cfg.graph.K > 0 else min(cfg.graph.s, n)
    basis = spectral.gl_setup(X_all, cfg.gl_sparse, cfg.gl_threshold)
    lobpcg = cfg.gl_solver == "lobpcg"
    if lobpcg:
        X0 = torch.randn((n, K), generator=generator, dtype=X_all.dtype, device=X_all.device)

    def spectrum_at(a2):
        if lobpcg:
            eig, resid = spectral.gl_spectrum_lobpcg_status(
                generator, basis, a2, K, cfg.gl_lobpcg_iters, X0=X0)
            return eig, torch.max(resid)
        return spectral.gl_spectrum_at(basis, a2, K), 0.0

    def extend(pair, resid, a2):
        return pair, {"gl_eigensolve_max_residual": float(resid)}

    return K, spectrum_at, extend


def fit_gl_regression_gp(generator: torch.Generator, X, Y, X_new,
                         cfg: FitConfig = FitConfig(sigma=1e-5), device=None) -> FitResult:
    """GPR on the exact graph Laplacian over all n points.

    ``FitResult.metrics["gl_eigensolve_max_residual"]`` carries the winning
    grid point's eigensolver residual (0 for the exact eigh path)."""
    device = _start(generator, device)
    cfg = _resolve(cfg, "regression")
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    K, spectrum_at, extend = _gl_family(generator, X_all, cfg)
    return _grid_regression(Y, m, n, K, cfg, spectrum_at, extend)


def fit_gl_logit_gp(generator: torch.Generator, X, Y, X_new, N=None,
                    cfg: FitConfig = FitConfig(), device=None) -> FitResult:
    """Binary GPC on the exact graph Laplacian; metrics as in
    :func:`fit_gl_regression_gp`."""
    device = _start(generator, device)
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    N_arr, max_count = _counts(N, m, cfg.dtype, device)
    K, spectrum_at, extend = _gl_family(generator, X_all, cfg)
    return _grid_logit(generator, Y, N_arr, max_count, m, n, K, cfg, spectrum_at, extend)
