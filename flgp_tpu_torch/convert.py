"""Carry the JAX package's state across: config, anchors, spectral pair.

The system has no trained weights; its state is the configuration, the
anchor set (centers and cluster counts) and the spectral pair.  These
helpers read them from ``flgp_tpu`` objects or numpy arrays without
importing JAX: a ``flgp_tpu`` config is read field by field, its dtypes
through ``np.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import FitConfig, GraphConfig, TrainConfig
from .ops.kmeans import SubsampleResult
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
