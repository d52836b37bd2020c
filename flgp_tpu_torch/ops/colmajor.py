"""Chunked feature-major spectral stage for huge point clouds (n ≳ 1e6).

The input cloud is feature-major, Xt of shape (d, n), and the ELL graph is
kept in chunks with the point axis minor:

    idx, w : (nch, r, c)   entry (i, k, j) is the k-th neighbour of point i·c + j

Points past the real n (the tail of the last chunk) are pads with zero
weight, so every sum ignores them.  With the point axis minor, a GPU thread
per point reads ``w[i, k, j]`` for each k at stride c and a warp's loads are
contiguous; the (n, r) layout of ``ops.spectrum`` strides them by r.  The
float32 LAE weights are one launch of K2 over the whole cloud on this layout
(``ops.lae.lae_weights_t``), the float32 tail runs through kernels K6–K8
(``hopper_kernels.ell_*_t``); float64 takes the plain version and the exact
op composition, which is also the oracle of that tail.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import EPS, KernelType, LaplacianType
from ..types import EigenPair, EllMatrix
from . import hopper_kernels as hk
from .kmeans import kmeans
from .knn import knn
from .lae import lae_weights_t
from .spectrum import _top_k_eigh, spectrum_from_Z


def _chunk_size(n: int, chunk: int) -> int:
    """The chunk width: ``chunk``, or n rounded up to 128 when n is smaller."""
    return min(chunk, -(-n // 128) * 128)


def _column_chunks(Xt: torch.Tensor, chunk: int):
    """(i, row-major (c_i, d) copy of chunk i's columns); the last c_i may
    be short.  Only one chunk's copy is alive at a time."""
    n = Xt.shape[1]
    for i, lo in enumerate(range(0, n, chunk)):
        yield i, Xt[:, lo:lo + chunk].T.contiguous()


def point_major(arr: torch.Tensor, n: int) -> torch.Tensor:
    """(nch, r, c) chunked layout → point-major (n, r), pads dropped."""
    nch, r, c = arr.shape
    return arr.transpose(1, 2).reshape(nch * c, r)[:n]


def kmeans_anchors_colmajor(
    generator: torch.Generator,
    Xt: torch.Tensor,
    s: int,
    n_sample: int = 1 << 17,
    nstart: int = 1,
    iters: int = 100,
) -> torch.Tensor:
    """k-means anchors for a feature-major (d, n) cloud: k-means‖-seeded
    Lloyd on a uniform column sample of ``n_sample`` points, drawn with
    replacement (immaterial at n ≫ n_sample).  Returns (s, d) centers; the
    full-n cluster sizes come from :func:`cluster_sizes_colmajor`."""
    n = Xt.shape[1]
    cols = torch.randint(0, n, (min(n_sample, n),), generator=generator, device=Xt.device)
    Xs = Xt[:, cols].T.contiguous()
    return kmeans(generator, Xs, s, nstart=nstart, iters=iters).centers.contiguous()


def cluster_sizes_colmajor(Xt: torch.Tensor, centers: torch.Tensor,
                           chunk: int = 1 << 16) -> torch.Tensor:
    """Full-n 1-NN counts of the (d, n) cloud against (s, d) centers — the
    column scale of the cluster-normalized Laplacian — one K1 pass (r = 1)
    per column chunk.  Only real points are counted."""
    s = centers.shape[0]
    counts = torch.zeros((s,), dtype=Xt.dtype, device=Xt.device)
    for _, xc in _column_chunks(Xt, _chunk_size(Xt.shape[1], chunk)):
        lab = knn(xc, centers, 1).indices[:, 0].long()
        counts.index_add_(0, lab, torch.ones(lab.shape, dtype=Xt.dtype, device=Xt.device))
    return counts


def build_graph_colmajor(
    Xt: torch.Tensor,
    U: torch.Tensor,
    r: int,
    kernel: KernelType = KernelType.LAE,
    epsilon_sq4: Optional[float] = None,
    lae_iters: int = 150,
    chunk: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN (K1) and kernel weights (K2 for LAE) of Xt (d, n) against the
    anchors U (s, d): K1 one column chunk at a time, the SE weights with it,
    the LAE weights afterwards over the whole chunked index array at once.

    Returns (idx (nch, r, c) int32, w (nch, r, c)): the raw, un-normalized
    ELL graph.  Pad points get index 0 and weight exactly 0.
    ``epsilon_sq4`` is the SE denominator (4ε² or a2·d̄)."""
    n = Xt.shape[1]
    kernel = KernelType(kernel)
    if kernel == KernelType.SE and epsilon_sq4 is None:
        raise ValueError("the SE kernel needs epsilon_sq4")
    c = _chunk_size(n, chunk)
    nch = -(-n // c)
    idx = torch.zeros((nch, r, c), dtype=torch.int32, device=Xt.device)
    se = kernel == KernelType.SE
    w = torch.zeros((nch, r, c), dtype=Xt.dtype, device=Xt.device) if se else None
    for i, xc in _column_chunks(Xt, c):
        res = knn(xc, U, r)
        idx[i, :, :xc.shape[0]] = res.indices.T
        if se:
            w[i, :, :xc.shape[0]] = (torch.exp(torch.clamp(-res.sqdists, max=0.0)
                                               / epsilon_sq4)).T
    if not se:
        w = lae_weights_t(Xt, U, idx, lae_iters)
    return idx, w


def normalize_colmajor(
    idx: torch.Tensor,
    w: torch.Tensor,
    s: int,
    gl: LaplacianType,
    cluster_sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Graph-Laplacian normalization of the weights, the semantics of
    ``ops.laplacian.normalize_graph_laplacian``, on any layout with r on
    axis −2 and points on axis −1 (chunked (nch, r, c) or flat (r, n))."""
    gl = LaplacianType(gl)
    if gl != LaplacianType.RW:
        flat_idx = idx.reshape(-1).long()
        colsum = w.new_zeros((s,)).index_add_(0, flat_idx, w.reshape(-1))
        scale = 1.0 / (colsum + EPS)
        if gl == LaplacianType.CLUSTER_NORMALIZED:
            if cluster_sizes is None:
                raise ValueError("cluster-normalized Laplacian requires cluster sizes")
            scale = scale * cluster_sizes.to(w.dtype)
        w = (w.reshape(-1) * scale[flat_idx]).reshape(w.shape)
    return w / (torch.sum(w, dim=-2, keepdim=True) + EPS)


def spectrum_colmajor(idx: torch.Tensor, w: torch.Tensor, s: int, K: int, root: bool,
                      n: int) -> EigenPair:
    """Top-K spectrum of W = Z·D⁻¹·Zᵀ from the normalized chunked graph: the
    exact composition (``ops.spectrum.spectrum_from_Z``) on the same graph
    laid out point-major.  ``n`` is the real point count."""
    Z = EllMatrix(point_major(w, n), point_major(idx, n), s)
    return spectrum_from_Z(Z, K, root)


def spectrum_fused_colmajor(
    idx: torch.Tensor,
    w: torch.Tensor,
    s: int,
    K: int,
    gl: LaplacianType,
    root: bool,
    n: int,
    cluster_sizes: Optional[torch.Tensor] = None,
) -> EigenPair:
    """normalize_colmajor + spectrum_colmajor from the RAW float32 chunked
    graph through K6 → K7 → ``eigh`` → K8, the reassociated algebra of
    ``ops.spectrum.spectrum_fused``:  AᵀA = diag(dinv)·(ZₙᵀZₙ)·diag(dinv)
    with D = colsum(Zₙ), and every diagonal scale of the extension folded
    into the (s, K) operand."""
    gl = LaplacianType(gl)
    if gl == LaplacianType.CLUSTER_NORMALIZED and cluster_sizes is None:
        raise ValueError("cluster-normalized Laplacian requires cluster sizes")
    if gl == LaplacianType.RW:
        cscale = torch.ones((s,), dtype=w.dtype, device=w.device)
    else:
        cscale = 1.0 / (hk.ell_colsum_t(w, idx, s) + EPS)
        if gl == LaplacianType.CLUSTER_NORMALIZED:
            cscale = cscale * cluster_sizes.to(w.dtype)
    Ghat, D = hk.ell_norm_gram_t(w, idx, cscale, eps=EPS)
    dinv = 1.0 / torch.sqrt(torch.abs(D) + EPS)
    lam, V = _top_k_eigh(Ghat * dinv[:, None] * dinv[None, :], K)
    sigma2 = torch.clamp(lam, min=0.0)
    sigma = torch.sqrt(sigma2)
    W_eff = dinv[:, None] * V * (math.sqrt(n) / (sigma + EPS))[None, :]
    vectors = hk.ell_norm_matmat_t(w, idx, cscale, W_eff.contiguous(), eps=EPS)[:n]
    return EigenPair(sigma if root else sigma2, vectors)


def heat_kernel_spectrum_colmajor(
    Xt: torch.Tensor,
    U: torch.Tensor,
    r: int,
    K: int,
    gl: LaplacianType = LaplacianType.NORMALIZED,
    root: bool = True,
    kernel: KernelType = KernelType.LAE,
    epsilon_sq4: Optional[float] = None,
    cluster_sizes: Optional[torch.Tensor] = None,
    lae_iters: int = 150,
    chunk: int = 1 << 16,
) -> EigenPair:
    """Graph → normalize → spectrum on (d, n) input: the huge-n counterpart
    of ``fit.spectral.build_spectrum`` given anchors, with device memory
    O(n·r) for the graph plus the (n, K) vectors.

    float32 takes the fused tail (K6–K8) at every r; float64 the exact
    composition.  Unlike the reference, a cluster-normalized Laplacian
    without cluster sizes raises on both branches."""
    n = Xt.shape[1]
    s = U.shape[0]
    idx, w = build_graph_colmajor(Xt, U, r, kernel, epsilon_sq4, lae_iters, chunk)
    if w.dtype == torch.float32:
        return spectrum_fused_colmajor(idx, w, s, K, gl, root, n, cluster_sizes)
    wn = normalize_colmajor(idx, w, s, gl, cluster_sizes)
    return spectrum_colmajor(idx, wn, s, K, root, n)
