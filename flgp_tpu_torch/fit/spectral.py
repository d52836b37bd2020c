"""Spectral-basis construction for the fit drivers: the LAE/SE spectrum and
the per-bandwidth bases of the SE, Nyström and GLGP fits."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import EPS, GraphConfig, KernelType
from ..ops.distance import sqdist
from ..ops.kmeans import SubsampleResult, subsample
from ..ops.knn import KnnResult, knn
from ..ops.lae import lae_weights
from ..ops.laplacian import normalize_graph_laplacian
from ..ops.lobpcg import lobpcg_standard
from ..ops.sparse_graph import SymStructure, glgp_operator, sym_structure, symmetrize_knn
from ..ops.spectrum import _top_k_eigh, spectrum_from_Z, spectrum_fused
from ..types import EigenPair, EllMatrix
from ..utils.metrics import span


def build_spectrum(
    generator: torch.Generator,
    X_all: torch.Tensor,
    g: GraphConfig,
    anchors: Optional[SubsampleResult] = None,
) -> Tuple[EigenPair, SubsampleResult]:
    """Subsample → cross-similarity → spectrum.

    ``anchors`` overrides the subsampler with a precomputed (centers, counts)
    pair.  The raw ELL graph goes to the fused normalize+spectrum tail
    (kernels K3–K5 in float32).  The stages are the spans ``subsample``,
    ``graph`` (``knn``, ``lae_weights``) and ``spectrum``."""
    with span("subsample"):
        sub = anchors if anchors is not None else subsample(
            generator, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters
        )
    centers = sub.centers.contiguous()
    with span("graph"):
        if g.kernel == KernelType.LAE:
            with span("knn"):
                idx = knn(X_all, centers, g.r).indices
            with span("lae_weights"):
                w = lae_weights(X_all, centers, idx)
        elif g.kernel == KernelType.SE:
            with span("knn"):
                res = knn(X_all, centers, g.r)
            idx = res.indices
            w = torch.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
        else:
            raise ValueError(f"unsupported kernel: {g.kernel}")
    with span("spectrum"):
        return spectrum_fused(w, idx, g.s, g.resolved_K(), g.gl, g.root, sub.counts), sub


class SeGridBasis(NamedTuple):
    knn_res: KnnResult
    dist_mean: torch.Tensor
    sub: SubsampleResult


def se_grid_setup(
    generator: torch.Generator,
    X_all: torch.Tensor,
    g: GraphConfig,
    anchors: Optional[SubsampleResult] = None,
) -> SeGridBasis:
    """One-time kNN for the SE bandwidth grid.  ``anchors`` as in
    build_spectrum; the spans ``subsample`` and ``graph`` (``knn``) as there."""
    with span("subsample"):
        sub = anchors if anchors is not None else subsample(
            generator, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters
        )
    with span("graph"):
        with span("knn"):
            res = knn(X_all, sub.centers.contiguous(), g.r)
        n, r = res.indices.shape
        return SeGridBasis(res, torch.sum(res.sqdists) / (n * r), sub)


def se_spectrum_at(basis: SeGridBasis, a2, g: GraphConfig) -> EigenPair:
    """Spectrum for one bandwidth grid point: Z = exp(−d²/(a2·d̄))."""
    vals = torch.exp(-basis.knn_res.sqdists / (a2 * basis.dist_mean))
    Z = EllMatrix(vals, basis.knn_res.indices, g.s)
    Z = normalize_graph_laplacian(Z, g.gl, basis.sub.counts)
    return spectrum_from_Z(Z, g.resolved_K(), g.root)


# ---------------------------------------------------------------------------
# Nyström basis
# ---------------------------------------------------------------------------


class NystromBasis(NamedTuple):
    dist_UU: torch.Tensor     # (s, s)
    dist_allU: torch.Tensor   # (n, s)
    dist_mean: torch.Tensor
    centers: torch.Tensor


def nystrom_setup(generator: torch.Generator, X_all: torch.Tensor, g: GraphConfig) -> NystromBasis:
    sub = subsample(generator, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters)
    U = sub.centers
    dist_UU = sqdist(U, U)
    return NystromBasis(dist_UU, sqdist(X_all, U), torch.mean(dist_UU), U)


def _diffusion_eigs(Z: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K eigenpairs of the doubly-normalized symmetric similarity
    W = D_A^{-1/2}·A·D_A^{-1/2}, A = D⁻¹·Z·D⁻¹, with the eigenvectors
    rescaled by D_A^{-1/2} and to column norm √(rows of Z).  Z is consumed
    (overwritten in place)."""
    n = Z.shape[0]
    rowsum = torch.sum(Z, dim=1) + EPS
    A = Z.div_(rowsum[:, None]).div_(rowsum[None, :])
    sqrt_D_inv = 1.0 / torch.sqrt(torch.sum(A, dim=1) + EPS)
    W = A.mul_(sqrt_D_inv[:, None]).mul_(sqrt_D_inv[None, :])
    w, V = _top_k_eigh(W, K)
    V = sqrt_D_inv[:, None] * V
    colnorms = torch.linalg.norm(V, dim=0)
    return w, math.sqrt(n) * V / (colnorms[None, :] + EPS)


def nystrom_anchor_eigs(basis: NystromBasis, a2, K: int) -> Tuple[EigenPair, torch.Tensor]:
    """Diffusion-map-normalized anchor eigensystem.

    Returns the anchor eigenpair (column-norm-√s vectors) and Z_UU (needed
    for the extension's column scaling)."""
    Z_UU = torch.exp(-basis.dist_UU / (a2 * basis.dist_mean))
    w, V = _diffusion_eigs(Z_UU.clone(), K)
    return EigenPair(w, V), Z_UU


def nystrom_extend(
    anchor: EigenPair,
    Z_UU: torch.Tensor,
    dist_rows: torch.Tensor,
    a2,
    dist_mean: torch.Tensor,
    col_scale_from_Z_UU_colsums: bool,
    rcond: float = 0.0,
) -> EigenPair:
    """Nyström extension V_ext = W_XU·V·Λ⁻¹.

    The training extension scales columns by Z_UU row sums, the test-time
    extension by its column sums (identical for symmetric Z_UU; both kept for
    parity).  ``rcond`` is a pinv-style relative cutoff on the inverse
    eigenvalues: columns with |λ_k| < rcond·max|λ| divide by the cutoff
    instead of λ_k.  The default 0.0 keeps the exact |λ| + 1e-9 denominator."""
    Z_XU = torch.exp(-dist_rows / (a2 * dist_mean))
    rowsums = torch.sum(Z_XU, dim=1) + EPS
    cols = torch.sum(Z_UU, dim=0 if col_scale_from_Z_UU_colsums else 1) + EPS
    A_XU = Z_XU / rowsums[:, None] / cols[None, :]
    W_XU = A_XU / (torch.sum(A_XU, dim=1) + EPS)[:, None]
    absvals = torch.abs(anchor.values)
    denom = torch.clamp(absvals, min=rcond * torch.max(absvals))
    return EigenPair(anchor.values, (W_XU @ anchor.vectors) / (denom[None, :] + EPS))


# ---------------------------------------------------------------------------
# GLGP basis: the exact graph Laplacian on all n points
# ---------------------------------------------------------------------------


class GlBasis(NamedTuple):
    sq_dists: torch.Tensor               # dense (n, n) squared distances, or kNN (n, r)
    knn_idx: Optional[torch.Tensor]
    dist_mean: torch.Tensor
    # structure of Z + Zᵀ for the kNN graph (sparse basis): the indices are the
    # same for every bandwidth, so the LOBPCG operator sorts them once
    structure: Optional[SymStructure] = None


def gl_setup(X_all: torch.Tensor, sparse: bool, threshold: float) -> GlBasis:
    n = X_all.shape[0]
    if sparse:
        r = max(int(round(threshold * n)), 3)
        res = knn(X_all, X_all, r)
        return GlBasis(res.sqdists, res.indices, torch.mean(res.sqdists),
                       sym_structure(res.indices, n))
    d = sqdist(X_all, X_all)
    return GlBasis(d, None, torch.mean(d))


def gl_spectrum_at(basis: GlBasis, a2, K: int) -> EigenPair:
    """Symmetrized, doubly-normalized GLGP spectrum for one bandwidth, by a
    dense (n, n) ``eigh``.  The kNN-sparse basis is densified; the sparse
    large-n path is :func:`gl_spectrum_lobpcg`."""
    if basis.knn_idx is not None:
        n = basis.knn_idx.shape[0]
        vals = torch.exp(-basis.sq_dists / (a2 * basis.dist_mean))
        Zd = EllMatrix(vals, basis.knn_idx, n).to_dense()
        Z = (Zd + Zd.T) / 2.0
    else:
        Z = torch.exp(-basis.sq_dists / (a2 * basis.dist_mean))
    return EigenPair(*_diffusion_eigs(Z, K))


def gl_spectrum_lobpcg(generator, basis: GlBasis, a2, K: int, iters: int = 80,
                       X0: Optional[torch.Tensor] = None) -> EigenPair:
    """Large-n GLGP spectrum without densifying: LOBPCG on the implicit
    symmetrized, doubly-normalized operator

        W = D_A^{-1/2} · A · D_A^{-1/2},   A = D^{-1} · (Z+Zᵀ)/2 · D⁻¹

    applied as two gathers in one kernel launch (``ell_sym_matmat``),
    O(n·r·K) per iteration.  Same eigensystem as ``gl_spectrum_at``."""
    return gl_spectrum_lobpcg_status(generator, basis, a2, K, iters, X0)[0]


def gl_spectrum_lobpcg_status(generator, basis: GlBasis, a2, K: int, iters: int = 80,
                              X0: Optional[torch.Tensor] = None):
    """As gl_spectrum_lobpcg, additionally returning the per-eigenpair
    residual norms ‖A·x − θx‖ of the final iteration: the convergence status
    the GL drivers put into ``FitResult.metrics``.  The start block is drawn
    from ``generator`` unless ``X0`` (n, K) is given."""
    if basis.knn_idx is None:
        raise ValueError("gl_spectrum_lobpcg requires the sparse kNN basis")
    n = basis.knn_idx.shape[0]
    vals = torch.exp(-basis.sq_dists / (a2 * basis.dist_mean))
    W, sqrt_da_inv = glgp_operator(symmetrize_knn(basis.knn_idx, vals, n, basis.structure))
    if X0 is None:
        X0 = torch.randn((n, K), generator=generator, dtype=vals.dtype, device=vals.device)
    res = lobpcg_standard(W.matvec, X0, iters=iters)
    V = sqrt_da_inv[:, None] * res.eigenvectors
    colnorms = torch.linalg.norm(V, dim=0)
    V = math.sqrt(n) * V / (colnorms[None, :] + EPS)
    return EigenPair(res.eigenvalues, V), res.residual_norms
