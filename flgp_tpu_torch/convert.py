"""Carry the JAX package's state across: config, anchors, spectral pair,
bandwidth-grid bases, the sparse GLGP operator, optimizer results, the
whitened posterior densities of the samplers.

The system has no trained weights; its state is the configuration, the
anchor set (centers and cluster counts), the spectral pair and the
per-family bases the bandwidth grid reuses.  These helpers read them from
``flgp_tpu`` objects or numpy arrays without importing JAX: a ``flgp_tpu``
config is read field by field, its dtypes through ``np.dtype``; a basis (a
named tuple of arrays) is read field by field through ``np.asarray``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import FitConfig, GraphConfig, TrainConfig
from .fit.spectral import GlBasis, NystromBasis, SeGridBasis
from .inference.optimize import GprOptResult
from .models.latent import GpcLogPost, GprLogPost, WhitenedGP
from .ops.kmeans import SubsampleResult
from .ops.knn import KnnResult
from .ops.sparse_graph import SymCoo
from .types import EigenPair

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _torch_dtype(dt):
    if dt is None:
        return None
    return _TORCH_DTYPES[np.dtype(dt)]


def _fields(obj, cls) -> dict:
    """The values of ``cls``'s fields read from ``obj``; enums by value."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        out[f.name] = v.value if hasattr(v, "value") else v
    return out


def fit_config_from_jax(cfg) -> FitConfig:
    """A ``flgp_tpu.FitConfig`` (or anything with its fields) as a port config."""
    top = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(FitConfig)
           if f.name not in ("graph", "train", "dtype", "solve_dtype")}
    if top["a2s"] is not None:
        top["a2s"] = tuple(float(a) for a in np.asarray(top["a2s"]))
    return FitConfig(
        graph=GraphConfig(**_fields(cfg.graph, GraphConfig)),
        train=TrainConfig(**_fields(cfg.train, TrainConfig)),
        dtype=_torch_dtype(cfg.dtype),
        solve_dtype=_torch_dtype(cfg.solve_dtype),
        **top,
    )


def anchors_from_numpy(centers, counts, device=None, dtype=torch.float64) -> SubsampleResult:
    """(centers (s, d), counts (s,)) arrays or tensors as the port's
    subsample result."""
    return SubsampleResult(torch.as_tensor(centers, dtype=dtype, device=device),
                           torch.as_tensor(counts, dtype=dtype, device=device))


def eigenpair_from_numpy(values, vectors, device=None, dtype=torch.float64) -> EigenPair:
    return EigenPair(torch.as_tensor(values, dtype=dtype, device=device),
                     torch.as_tensor(vectors, dtype=dtype, device=device))


def eigenpair_to_numpy(eigenpair: EigenPair) -> Tuple[np.ndarray, np.ndarray]:
    return (eigenpair.values.detach().cpu().numpy(),
            eigenpair.vectors.detach().cpu().numpy())


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def se_grid_basis_from_jax(basis, device=None, dtype=torch.float64) -> SeGridBasis:
    """A ``flgp_tpu`` ``SeGridBasis`` (kNN result, mean d², anchors)."""
    return SeGridBasis(
        KnnResult(_tensor(basis.knn_res.indices, device, torch.int32),
                  _tensor(basis.knn_res.sqdists, device, dtype)),
        _tensor(basis.dist_mean, device, dtype),
        anchors_from_numpy(np.array(basis.sub.centers), np.array(basis.sub.counts),
                           device=device, dtype=dtype),
    )


def nystrom_basis_from_jax(basis, device=None, dtype=torch.float64) -> NystromBasis:
    return NystromBasis(*(_tensor(a, device, dtype) for a in basis))


def gl_basis_from_jax(basis, device=None, dtype=torch.float64) -> GlBasis:
    """A ``flgp_tpu`` ``GlBasis``: dense (knn_idx None) or kNN-sparse."""
    idx = None if basis.knn_idx is None else _tensor(basis.knn_idx, device, torch.int32)
    return GlBasis(_tensor(basis.sq_dists, device, dtype), idx,
                   _tensor(basis.dist_mean, device, dtype))


def symcoo_from_numpy(rows, cols, vals, n: int, device=None, dtype=torch.float64) -> SymCoo:
    """The 2·n·r-edge COO list of a symmetrized kNN graph (its first n·r
    edges the graph row by row, the rest its transpose with the same values
    up to rounding) as the port's ELL-backed operator."""
    rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
    half = rows.shape[0] // 2
    r = half // n
    if half * 2 != rows.shape[0] or r * n != half or not (
            np.array_equal(rows[:half], np.repeat(np.arange(n), r))
            and np.array_equal(rows[half:], cols[:half]) and np.array_equal(cols[half:], rows[:half])
            and np.allclose(vals[:half], vals[half:], rtol=1e-5, atol=0.0)):
        raise ValueError("not the edge list of a symmetrized (n, r) kNN graph")
    return SymCoo(_tensor(cols[:half].reshape(n, r), device, torch.int32),
                  _tensor(vals[:half].reshape(n, r), device, dtype), n)


def gpr_opt_result_to_numpy(res: GprOptResult) -> GprOptResult:
    return GprOptResult(*(v.detach().cpu().numpy() for v in res))


def whitened_from_numpy(V, lam, sigma, device=None, dtype=torch.float64) -> WhitenedGP:
    """(V (m, K), lam (K,), sigma) arrays or tensors as the port's whitened GP."""
    return WhitenedGP(_tensor(V, device, dtype), _tensor(lam, device, dtype), float(sigma))


def gpc_logpost_from_jax(post, device=None, dtype=torch.float64) -> GpcLogPost:
    """A ``flgp_tpu`` ``GpcLogPost`` (or anything with its fields), field by
    field: the same density in the port."""
    gp = whitened_from_numpy(post.gp.V, post.gp.lam, post.gp.sigma, device, dtype)
    return GpcLogPost(gp, _tensor(post.Y, device, dtype), _tensor(post.N, device, dtype),
                      *(float(getattr(post, f)) for f in ("p", "q", "tau", "mu0", "s0")))


def gpr_logpost_from_jax(post, device=None, dtype=torch.float64) -> GprLogPost:
    """A ``flgp_tpu`` ``GprLogPost`` (or anything with its fields), field by field."""
    gp = whitened_from_numpy(post.gp.V, post.gp.lam, post.gp.sigma, device, dtype)
    return GprLogPost(gp, _tensor(post.Y, device, dtype),
                      *(float(getattr(post, f))
                        for f in ("p", "q", "tau", "alpha", "beta", "mu0", "s0")))
