"""Spectral decomposition of the two-step similarity W = Z·D⁻¹·Zᵀ.

With A = Z·diag(colsum)^(-1/2), eig(W) = σ²(A) = eig(AᵀA): one exact (s, s)
Gram, one ``eigh``, and the left singular vectors follow as U = A·V·Σ⁻¹.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import EPS, LaplacianType
from ..types import EigenPair, EllMatrix
from ..utils.metrics import count
from . import hopper_kernels as hk
from .knn import knn
from .lae import lae_weights
from .laplacian import normalize_graph_laplacian


def cross_similarity_lae(X: torch.Tensor, anchors: torch.Tensor, r: int, gl: LaplacianType,
                         cluster_sizes: Optional[torch.Tensor] = None,
                         lae_iters: int = 150) -> EllMatrix:
    """The LAE-weighted, normalized sparse graph Z (n, s) between the points
    and the anchors; ``flgp_tpu.ops.spectrum.cross_similarity_lae``."""
    anchors = anchors.contiguous()
    idx = knn(X, anchors, r).indices
    w = lae_weights(X, anchors, idx, iters=lae_iters)
    return normalize_graph_laplacian(EllMatrix(w, idx, anchors.shape[0]), gl, cluster_sizes)


def cross_similarity_se(X: torch.Tensor, anchors: torch.Tensor, r: int, gl: LaplacianType,
                        epsilon: float, cluster_sizes: Optional[torch.Tensor] = None
                        ) -> EllMatrix:
    """Z with weights exp(−d²/(4ε²)) on the kNN squared distances;
    ``flgp_tpu.ops.spectrum.cross_similarity_se``."""
    anchors = anchors.contiguous()
    res = knn(X, anchors, r)
    vals = torch.exp(-res.sqdists / (4.0 * epsilon * epsilon))
    return normalize_graph_laplacian(EllMatrix(vals, res.indices, anchors.shape[0]), gl,
                                     cluster_sizes)


def _top_k_eigh(G: torch.Tensor, K: int):
    """Eigenpairs of the symmetric G, largest K first."""
    w, V = torch.linalg.eigh(G)                    # ascending
    if G.is_cuda:
        count("host_syncs")                        # eigh reads its status on the host
    return torch.flip(w, dims=[0])[:K], torch.flip(V, dims=[1])[:, :K]


def spectrum_fused(
    values: torch.Tensor,
    indices: torch.Tensor,
    s: int,
    K: int,
    gl: LaplacianType,
    root: bool,
    cluster_sizes: Optional[torch.Tensor] = None,
) -> EigenPair:
    """normalize_graph_laplacian + spectrum_from_Z from the RAW ELL graph.

    float32 runs the fused tail through kernels K3–K5 at every r: the same
    math, reassociated as  AᵀA = diag(dinv)·(ZₙᵀZₙ)·diag(dinv)  with
    D = colsum(Zₙ), so one graph pass yields Ĝ and D, and a second the
    eigenvector extension with every diagonal scale folded into the (s, K)
    operand.  float64 takes the exact op composition on any device, as the
    reference's x64 gate does.
    """
    gl = LaplacianType(gl)
    if gl == LaplacianType.CLUSTER_NORMALIZED and cluster_sizes is None:
        raise ValueError("cluster-normalized Laplacian requires cluster sizes")
    if values.dtype != torch.float32:
        Z = normalize_graph_laplacian(EllMatrix(values, indices, s), gl, cluster_sizes)
        return spectrum_from_Z(Z, K, root)

    n = values.shape[0]
    values = values.contiguous()
    indices = indices.to(torch.int32).contiguous()
    if gl == LaplacianType.RW:
        cscale = torch.ones((s,), dtype=values.dtype, device=values.device)
    else:
        C = hk.ell_colsum(values, indices, s)
        cscale = 1.0 / (C + EPS)
        if gl == LaplacianType.CLUSTER_NORMALIZED:
            cscale = cscale * cluster_sizes.to(values.dtype)
    Ghat, D = hk.ell_norm_gram(values, indices, cscale, eps=EPS)
    dinv = 1.0 / torch.sqrt(torch.abs(D) + EPS)
    w, V = _top_k_eigh(Ghat * dinv[:, None] * dinv[None, :], K)
    sigma2 = torch.clamp(w, min=0.0)
    sigma = torch.sqrt(sigma2)
    # vectors = A·V·σ⁻¹·√n = Zₙ @ (dinv ⊙ V ⊙ √n/(σ+EPS))
    W_eff = dinv[:, None] * V * (math.sqrt(n) / (sigma + EPS))[None, :]
    vectors = hk.ell_norm_matmat(values, indices, cscale, W_eff.contiguous(), eps=EPS)
    return EigenPair(sigma if root else sigma2, vectors)


def spectrum_from_Z(Z: EllMatrix, K: int, root: bool) -> EigenPair:
    """Top-K spectrum of W from the ELL matrix Z.

    values: eigenvalues of W = σ²(A), or σ(A) when ``root``.  vectors:
    √n-scaled left singular vectors of A restricted to the top K.  The
    column sums add in a fixed order, so one graph gives one spectrum, bit
    for bit, on the card too.
    """
    n, s = Z.shape
    A = Z.scale_cols(1.0 / torch.sqrt(torch.abs(Z.colsum_ordered()) + EPS))
    w, V = _top_k_eigh(A.gram(), K)
    sigma2 = torch.clamp(w, min=0.0)
    sigma = torch.sqrt(sigma2)
    U = A.matmat(V.contiguous()) / (sigma[None, :] + EPS)   # left singular vectors (n, K)
    return EigenPair(sigma if root else sigma2, U * math.sqrt(n))
