"""Fit drivers: binary GP classification with the LAE kernel.

A host-side orchestrator over the stages: spectral basis (subsample, kNN,
LAE weights, spectrum), empirical-Bayes training of the diffusion time t,
then PG-Gibbs labels and Laplace posterior moments.  PyTorch runs eagerly,
so each stage launches its own work on the chosen device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Approach, FitConfig, KernelType, pin_full_precision
from ..convert import anchors_from_numpy
from ..inference.optimize import Scalar1DResult, minimize_1d_log
from ..inference.pg_gibbs import test_pgbinary
from ..models import gpc as gpc_mod
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


def _to_result(out, pars, obj, eigenpair=None) -> FitResult:
    return FitResult(
        y_train=_np(out["train"]),
        y_test=_np(out["test"]),
        posterior_mean=_np(out["mean"]),
        posterior_cov=_np(out["cov"]),
        pars={k: _np(v) for k, v in pars.items()},
        obj=float(obj),
        C=_np(out["C"]) if "C" in out else None,
        eigenpair=eigenpair,
    )


def fit_lae_logit_gp(generator: torch.Generator, X, Y, X_new, N=None,
                     cfg: FitConfig = FitConfig(), anchors=None, device=None) -> FitResult:
    """Binary GPC with the LAE kernel.

    ``generator`` drives every random draw (subsampling, PG Gibbs) and must
    live on ``device`` (default: the generator's own device).  ``anchors``:
    optional (centers, sizes) subsampler override.  Inputs may be numpy
    arrays or tensors; outputs are numpy arrays, the eigenpair stays on the
    device."""
    pin_full_precision()
    device = torch.device(device) if device is not None else generator.device
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, fit on {device}")
    X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
    Y = torch.as_tensor(Y, dtype=cfg.dtype, device=device)
    if N is None:
        N_arr = torch.ones((m,), dtype=cfg.dtype, device=device)
        max_count = 1
    else:
        N_arr = torch.as_tensor(N, dtype=cfg.dtype, device=device)
        max_count = int(np.max(_np(N)))

    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    K = min(g.resolved_K(), g.s, n)
    eig, _ = spectral.build_spectrum(generator, X_all, g, _as_anchors(anchors, cfg.dtype, device))
    scfg, seig, (Ys, Ns) = _solve_cast(cfg, eig, Y, N_arr)
    res = _train_gpc(seig, Ys, Ns, slice(0, m), K, scfg)
    out = _gpc_tail(generator, seig, Ys, Ns, m, n, K, scfg, res.x, max_count)
    return _to_result(out, dict(t=res.x), -res.obj, eig)
