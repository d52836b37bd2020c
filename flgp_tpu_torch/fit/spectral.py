"""Spectral-basis construction for the fit drivers."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import GraphConfig, KernelType
from ..ops.kmeans import SubsampleResult, subsample
from ..ops.knn import knn
from ..ops.lae import lae_weights
from ..ops.spectrum import spectrum_fused
from ..types import EigenPair


def build_spectrum(
    generator: torch.Generator,
    X_all: torch.Tensor,
    g: GraphConfig,
    anchors: Optional[SubsampleResult] = None,
) -> Tuple[EigenPair, SubsampleResult]:
    """Subsample → cross-similarity → spectrum.

    ``anchors`` overrides the subsampler with a precomputed (centers, counts)
    pair.  The raw ELL graph goes to the fused normalize+spectrum tail
    (kernels K3–K5 in float32)."""
    sub = anchors if anchors is not None else subsample(
        generator, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters
    )
    centers = sub.centers.contiguous()
    if g.kernel == KernelType.LAE:
        idx = knn(X_all, centers, g.r).indices
        w = lae_weights(X_all, centers, idx)
    elif g.kernel == KernelType.SE:
        res = knn(X_all, centers, g.r)
        idx = res.indices
        w = torch.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
    else:
        raise ValueError(f"unsupported kernel: {g.kernel}")
    return spectrum_fused(w, idx, g.s, g.resolved_K(), g.gl, g.root, sub.counts), sub
