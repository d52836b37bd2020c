"""The spectral stage with the n-point axis sharded over processes.

The rows of X, of the ELL graph and of the (n, K) eigenvector store are
split over the ranks of a ``data`` mesh; the anchors, the column statistics
and the (s, s) Gram are replicated.  Two all-reduces build the spectrum:

    the column sums C of the local graph (K3)   → the Laplacian's column scale
    the local Ĝ = ZₙᵀZₙ and D = colsum(Zₙ) (K4) → one replicated ``eigh``

kNN (K1), the LAE weights (K2), the row normalization and the eigenvector
extension (K5) are per row, on each rank's rows.  This is
``ops.spectrum.spectrum_fused``'s algebra: Ĝ and D are reduced in float64
from the kernels' exact partial sums and rounded to float32 once, so on the
card the sharded spectrum is the single-device spectrum bit for bit, at any
world size.  float64 graphs take the plain versions of the same three
steps; float32 takes the kernels at every r.

The GPR objective and prediction reduce the K-dim row statistics of the
eigenvector store with one all-reduce; the (n, K) vectors never gather.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import EPS, GraphConfig, KernelType, LaplacianType
from ..ops import hopper_kernels as hk
from ..ops import linalg
from ..ops.knn import knn
from ..ops.lae import lae_weights
from ..ops.spectrum import _top_k_eigh
from ..types import EllMatrix
from .mesh import Mesh


def _local_ell(X_local: torch.Tensor, anchors: torch.Tensor, g: GraphConfig) -> EllMatrix:
    """This rank's rows of Z: kNN (K1) and the kernel weights (K2 for LAE)."""
    anchors = anchors.contiguous()
    res = knn(X_local, anchors, g.r)
    if g.kernel == KernelType.LAE:
        vals = lae_weights(X_local, anchors, res.indices)
    else:
        vals = torch.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
    return EllMatrix(vals, res.indices, g.s)


def _spectrum_from_local_ell(mesh: Mesh, Z: EllMatrix, counts, g: GraphConfig,
                             K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize a row-sharded ELL graph and extract its spectrum: two
    all-reduces (C; Ĝ, D and the row count), one replicated ``eigh``.
    Returns (values, this rank's rows of the vectors)."""
    gl = LaplacianType(g.gl)
    if gl == LaplacianType.CLUSTER_NORMALIZED and counts is None:
        raise ValueError("cluster-normalized Laplacian requires cluster sizes")
    values = Z.values.contiguous()
    s, dtype = Z.num_cols, values.dtype
    kernels = dtype == torch.float32
    indices = Z.indices.to(torch.int32).contiguous() if kernels else Z.indices
    if gl == LaplacianType.RW:
        cscale = torch.ones((s,), dtype=dtype, device=values.device)
    else:
        C = hk.ell_colsum_partial(values, indices, s) if kernels else \
            hk.ell_colsum_plain(values, indices, s).double()
        cscale = 1.0 / (mesh.psum(C).to(dtype) + EPS)
        if gl == LaplacianType.CLUSTER_NORMALIZED:
            cscale = cscale * counts.to(dtype)
    G, D = hk.ell_norm_gram_partial(values, indices, cscale, eps=EPS) if kernels else \
        hk.ell_norm_gram_plain(values, indices, cscale, eps=EPS)
    rows = torch.tensor([values.shape[0]], dtype=torch.float64, device=values.device)
    sums = mesh.psum(torch.cat([G.double().reshape(-1), D.double(), rows]))
    GD = sums[:s * s + s].to(dtype)
    Ghat, D, n = GD[:s * s].view(s, s), GD[s * s:], int(sums[-1])

    dinv = 1.0 / torch.sqrt(torch.abs(D) + EPS)
    w, V = _top_k_eigh(Ghat * dinv[:, None] * dinv[None, :], K)
    sigma2 = torch.clamp(w, min=0.0)
    sigma = torch.sqrt(sigma2)
    W_eff = (dinv[:, None] * V * (math.sqrt(n) / (sigma + EPS))[None, :]).contiguous()
    matmat = hk.ell_norm_matmat if kernels else hk.ell_norm_matmat_plain
    return (sigma if g.root else sigma2), matmat(values, indices, cscale, W_eff, eps=EPS)


def sharded_spectrum_fn(mesh: Mesh, g: GraphConfig, axis: str = "data"):
    """fn(X_local, anchors, counts) → (values, this rank's rows of the
    vectors): the spectrum of the rows of X split over ``axis``, with the
    anchors and cluster sizes replicated."""
    mesh.check_axis(axis)
    K = g.resolved_K()

    def fn(X_local, anchors, counts):
        return _spectrum_from_local_ell(mesh, _local_ell(X_local, anchors, g), counts, g, K)

    return fn


def sharded_spectrum_from_ell_fn(mesh: Mesh, g: GraphConfig, axis: str = "data"):
    """fn(vals_local, idx_local, counts) → (values, vectors_local): the
    spectrum of a row-sharded graph already built, the entry of the
    out-of-core path, where ``fit.streaming`` builds each rank's rows from
    disk and X never exists in memory."""
    mesh.check_axis(axis)
    K = g.resolved_K()

    def fn(vals_local, idx_local, counts):
        return _spectrum_from_local_ell(mesh, EllMatrix(vals_local, idx_local, g.s), counts, g, K)

    return fn


def _row_stats(mesh: Mesh, vectors_local, Y_local, mask_local, K: int):
    """(VᵀV, VᵀY, YᵀY, m) over the observed rows of all ranks, one
    all-reduce; none depends on (t, noise)."""
    Vm = vectors_local[:, :K] * mask_local[:, None]
    Ym = Y_local * mask_local
    part = torch.cat([linalg.pdot(Vm.T, Vm).reshape(-1), linalg.pdot(Vm.T, Ym[:, None])[:, 0],
                      torch.sum(Ym * Ym).reshape(1), torch.sum(mask_local).reshape(1)])
    tot = mesh.psum(part)
    return tot[:K * K].view(K, K), tot[K * K:K * K + K], tot[-2], tot[-1]


def _woodbury(values, VtV, VtY, K: int, sigma: float, t, noise):
    """The K-dim Woodbury pieces: (√Λ, z, L_Q, Q⁻¹·√Λ·VᵀY/z)."""
    lam_sqrt = torch.exp(-0.5 * t * (1.0 - values[:K]))
    z = noise + sigma
    Q = lam_sqrt[:, None] * VtV * lam_sqrt[None, :] / z
    L_Q = linalg.cholesky(linalg.add_diag(Q, 1.0))
    sol = linalg.chol_solve(L_Q, (lam_sqrt * (VtY / z))[:, None])[:, 0]
    return lam_sqrt, z, L_Q, sol


def sharded_gpr_nmll_fn(mesh: Mesh, K: int, sigma: float, axis: str = "data"):
    """fn(values, vectors_local, Y_local, mask_local, t, noise) → the
    Woodbury GPR NMLL (the m > K branch of ``models.gpr.gpr_nmll``) with the
    (n, K) store left sharded; the observed rows are those where the {0, 1}
    mask is 1.  The quadratic term is (YᵀY − (VᵀY)·√Λ·Q⁻¹√Λ·VᵀY/z)/z, so
    every all-reduced row sum is independent of (t, noise): autograd's
    gradient in them on each rank is the single-process gradient, with no
    collective on the tape."""
    mesh.check_axis(axis)

    def fn(values, vectors_local, Y_local, mask_local, t, noise):
        VtV, VtY, YtY, m = _row_stats(mesh, vectors_local, Y_local, mask_local, K)
        lam_sqrt, z, L_Q, sol = _woodbury(values, VtV, VtY, K, sigma, t, noise)
        quad = (YtY - torch.sum(VtY * lam_sqrt * sol)) / z
        return (0.5 * quad + torch.sum(torch.log(torch.diagonal(L_Q) + EPS))
                + 0.5 * m * torch.log(z))

    return fn


def sharded_predict_fn(mesh: Mesh, K: int, sigma: float, axis: str = "data"):
    """fn(values, vectors_local, Y_local, mask_local, t, noise) → the
    posterior mean at this rank's rows (the Woodbury branch of
    ``models.gpr.gpr_predict``), with no gather."""
    mesh.check_axis(axis)

    def fn(values, vectors_local, Y_local, mask_local, t, noise):
        VtV, VtY, _, _ = _row_stats(mesh, vectors_local, Y_local, mask_local, K)
        lam_sqrt, z, _, sol = _woodbury(values, VtV, VtY, K, sigma, t, noise)
        Vt_alpha = (VtY - linalg.pdot(VtV, (lam_sqrt * sol)[:, None])[:, 0]) / z
        w_full = torch.exp(-t * (1.0 - values[:K]))
        return linalg.pdot(vectors_local[:, :K], (w_full * Vt_alpha)[:, None])[:, 0]

    return fn
