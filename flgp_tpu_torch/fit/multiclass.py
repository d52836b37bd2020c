"""Multinomial (one-vs-rest) GP classification: the four multiclass drivers.

The port of ``flgp_tpu.fit.multiclass``.  J binary logit GPs share one
spectral basis: each class's diffusion time t is trained on its own 0/1
column of the one-hot labels, then J PG-Gibbs chains give J probability
columns and the label is their argmax (the first class on ties).  Training
runs the J classes as the problems of one t-search (``drivers._train_gpc``):
each stage is one batched Newton solve over the classes' t grids whose lanes
freeze exactly as a lone run would (``models/gpc.py``), and each class keeps
its own window and bracket, so the result equals the reference's vmap over
classes.  The chains run as the J
lanes of one chain (``inference/pg_gibbs.py``) and the Laplace moments as J
lanes of one Newton solve.  The SE, Nyström and GLGP drivers train every
class at each bandwidth of the grid and keep the bandwidth of the smallest
sum over classes of the per-class objective (the first on ties), holding only
the best basis so far.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import FitConfig, KernelType
from ..inference.optimize import Scalar1DResult
from ..inference.pg_gibbs import test_pgbinary
from ..models import gpc as gpc_mod
from ..ops.heat_kernel import heat_kernel
from ..types import EigenPair
from ..utils.metrics import fit_entry, span, spanned, to_device, to_host
from . import spectral
from .drivers import (
    FitResult,
    _a2_grid,
    _concat_all,
    _first_min,
    _gl_family,
    _grid_point,
    _nystrom_family,
    _se_family,
    _solve_cast,
    _start,
    _to_result,
    _train_gpc,
)


def one_hot_labels(Y: torch.Tensor, J: int) -> torch.Tensor:
    """One-hot encode the integer labels 0..J−1 of Y as (m, J) in Y's dtype;
    ``flgp_tpu.fit.multiclass.one_hot_labels``."""
    return torch.nn.functional.one_hot(Y.to(torch.int64), J).to(Y.dtype)


def _train_mult(eigenpair: EigenPair, aug_y, m: int, K: int, cfg: FitConfig) -> Scalar1DResult:
    """The J binary t-optimizations over the shared spectrum as the J
    problems of one ``_train_gpc``, in one span ``train``; every field of the
    result has a leading (J,) axis."""
    with span("train"):
        N = torch.ones((m,), dtype=aug_y.dtype, device=aug_y.device)
        return _train_gpc(eigenpair, aug_y.T, N, slice(0, m), K, cfg)


def _predict_mult(generator, eigenpair: EigenPair, aug_y, ts, m: int, n: int, K: int,
                  cfg: FitConfig):
    """J PG-Gibbs chains as the lanes of one → per-class probabilities (J, n)
    at every point → labels (n,), the argmax over classes, in aug_y's dtype.

    C = [Cvv + σI; Cnv] is one (J, n, m) block; Cvv is a view of it."""
    C = heat_kernel(eigenpair, ts, K, slice(0, n), slice(0, m))
    Cvv = C[:, :m]
    Cvv.diagonal(dim1=-2, dim2=-1).add_(cfg.sigma)
    _, probs = test_pgbinary(generator, Cvv, aug_y.T, C, cfg.n_gibbs,
                             avg_sweeps=cfg.gibbs_avg_sweeps)
    return torch.argmax(probs, dim=0).to(aug_y.dtype), probs


def _posterior_mult(eigenpair: EigenPair, aug_y, ts, m: int, n: int, K: int, sigma: float):
    """Per-class Laplace moments at the test rows m..n−1, each (n − m, J)."""
    mean, cov = gpc_mod.gpc_posterior_from_spectrum(eigenpair, aug_y.T, slice(0, m),
                                                    slice(m, n), K, ts, sigma)
    return mean.T, cov.T


@spanned("predict")
def _mult_tail(generator, eig: EigenPair, cfg: FitConfig, aug_y, res: Scalar1DResult, m: int,
               n: int, K: int, pars: dict, metrics=None) -> FitResult:
    """Labels and moments from the trained times ``res.x`` (J,) on the pair
    ``eig``, cast to the solve dtype."""
    scfg, seig, (aug_s,) = _solve_cast(cfg, eig, aug_y)
    labels, _ = _predict_mult(generator, seig, aug_s, res.x, m, n, K, scfg)
    mean, cov = _posterior_mult(seig, aug_s, res.x, m, n, K, scfg.sigma)
    out = dict(train=labels[:m], test=labels[m:], mean=mean, cov=cov)
    return _to_result(out, dict(t=res.x, **pars), torch.sum(-res.obj), eig, metrics)


def _setup(generator, X, Y, X_new, cfg: FitConfig, device):
    device = _start(generator, device)
    with span("upload"):
        X_all, m, n = _concat_all(X, X_new, cfg.dtype, device)
        Y = to_device(Y, cfg.dtype, device)
        J = int(to_host(torch.max(Y))) + 1
        return device, X_all, m, n, one_hot_labels(Y, J)


@fit_entry
def fit_lae_logit_mult_gp(generator: torch.Generator, X, Y, X_new, cfg: FitConfig = FitConfig(),
                          device=None) -> FitResult:
    """Multinomial GPC with the LAE kernel.

    Y holds the integer labels 0..J−1 of the rows of X.  ``generator`` drives
    every random draw and must live on ``device``: the CUDA device by
    default, the CPU only with ``device="cpu"``.  ``y_train``/``y_test`` are
    the predicted labels, ``posterior_mean``/``posterior_cov`` (n_new, J),
    ``pars["t"]`` (J,), ``obj`` the sum over classes."""
    _, X_all, m, n, aug_y = _setup(generator, X, Y, X_new, cfg, device)
    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    K = min(g.resolved_K(), g.s, n)
    eig, _ = spectral.build_spectrum(generator, X_all, g)
    scfg, seig, (aug_s,) = _solve_cast(cfg, eig, aug_y)
    res = _train_mult(seig, aug_s, m, K, scfg)
    return _mult_tail(generator, eig, cfg, aug_y, res, m, n, K, {})


def _grid_mult(generator, aug_y, m: int, n: int, K: int, cfg: FitConfig, spectrum_at,
               extend) -> FitResult:
    """Train every class at each bandwidth (``spectrum_at``/``extend`` as in
    ``drivers._grid_logit``); the grid objective is the sum over classes."""
    objs, best = [], None
    for a2 in _a2_grid(cfg):
        pair, extra = _grid_point(spectrum_at, a2)
        scfg, seig, (aug_s,) = _solve_cast(cfg, pair, aug_y)
        res = _train_mult(seig, aug_s, m, K, scfg)
        objs.append(torch.sum(res.obj))
        if _first_min(objs) == len(objs) - 1:
            best = (pair, extra, a2, res)
    pair, extra, a2, res = best
    eig, metrics = extend(pair, extra, a2)
    return _mult_tail(generator, eig, cfg, aug_y, res, m, n, K, dict(a2=a2), metrics)


@fit_entry
def fit_se_logit_mult_gp(generator: torch.Generator, X, Y, X_new, cfg: FitConfig = FitConfig(),
                         device=None) -> FitResult:
    """Multinomial GPC with the SE kernel and a bandwidth grid; arguments and
    results as :func:`fit_lae_logit_mult_gp`, ``pars["a2"]`` the bandwidth."""
    device, X_all, m, n, aug_y = _setup(generator, X, Y, X_new, cfg, device)
    K, spectrum_at, extend = _se_family(generator, X_all, cfg, None, device)
    return _grid_mult(generator, aug_y, m, n, K, cfg, spectrum_at, extend)


@fit_entry
def fit_nystrom_logit_mult_gp(generator: torch.Generator, X, Y, X_new,
                              cfg: FitConfig = FitConfig(), device=None) -> FitResult:
    """Multinomial GPC via the Nyström extension; as :func:`fit_se_logit_mult_gp`."""
    _, X_all, m, n, aug_y = _setup(generator, X, Y, X_new, cfg, device)
    K, spectrum_at, extend = _nystrom_family(generator, X_all, m, cfg)
    return _grid_mult(generator, aug_y, m, n, K, cfg, spectrum_at, extend)


@fit_entry
def fit_gl_logit_mult_gp(generator: torch.Generator, X, Y, X_new, cfg: FitConfig = FitConfig(),
                         device=None) -> FitResult:
    """Multinomial GPC on the exact graph Laplacian (dense ``eigh`` or sparse
    LOBPCG); as :func:`fit_se_logit_mult_gp`, with
    ``metrics["gl_eigensolve_max_residual"]`` as the binary GLGP drivers."""
    _, X_all, m, n, aug_y = _setup(generator, X, Y, X_new, cfg, device)
    K, spectrum_at, extend = _gl_family(generator, X_all, cfg)
    return _grid_mult(generator, aug_y, m, n, K, cfg, spectrum_at, extend)
