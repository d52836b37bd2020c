"""Local Anchor Embedding: batched simplex-constrained least squares.

Per data point solve  min_z ‖x − zᵀU_i‖²  s.t. z ∈ Δ^{r-1}  over its r
nearest anchors U_i.  The objective is quadratic, so fixed-iteration FISTA
with step 1/L, L a per-point Gershgorin bound on λmax(U_iU_iᵀ), reaches the
same unique minimizer as a backtracking line search with no data-dependent
control flow.
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import KERNEL_MAX_R


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row of v onto the probability simplex
    (sort, cumulative sum, threshold).

    The cumulative sum runs left to right, one rounding per step, as the
    CUDA kernel forms it (``torch.cumsum`` may scan in another order)."""
    r = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = [u[..., 0]]
    for k in range(1, r):
        css.append(css[-1] + u[..., k])
    cssv = torch.stack(css, dim=-1)
    k = torch.arange(1, r + 1, dtype=v.dtype, device=v.device)
    cond = u - (cssv - 1.0) / k > 0
    # rho = largest k with cond true (cond is monotone in the sorted order)
    rho = torch.clamp(torch.sum(cond, dim=-1), min=1)
    theta = (torch.gather(cssv, -1, (rho - 1)[..., None])[..., 0] - 1.0) / rho.to(v.dtype)
    return torch.clamp(v - theta[..., None], min=0.0)


def lae_weights(
    X: torch.Tensor,
    anchors: torch.Tensor,
    knn_idx: torch.Tensor,
    iters: int = 150,
) -> torch.Tensor:
    """Anchor-embedding weights, shape (n, r): row i solves the simplex LSQ
    over anchors[knn_idx[i]].

    float32 with r ≤ 16 goes through the hand-written kernel's wrapper;
    float64 and wider r take the plain version on any device."""
    if (X.dtype == torch.float32 and anchors.dtype == torch.float32
            and knn_idx.shape[1] <= KERNEL_MAX_R):
        from . import hopper_kernels

        return hopper_kernels.lae_weights(X, anchors, knn_idx.to(torch.int32), iters)
    return lae_weights_plain(X, anchors, knn_idx, iters)


def fista_momentum(iters: int) -> np.ndarray:
    """The momentum factors α_it = (d_{it−1} − 1)/d_it, it < iters, of
    ``lae_weights_plain``'s recurrence d' = (1 + √(1 + 4d²))/2 from d = 1,
    computed on the host in float32 exactly as that loop computes them for
    float32 data.  They do not depend on the data: the CUDA kernel reads
    them as a table."""
    one = np.float32(1.0)
    d_prev, d_curr = one * 0, one
    alpha = np.empty((iters,), dtype=np.float32)
    for it in range(iters):
        alpha[it] = (d_prev - 1) / d_curr
        d_prev, d_curr = d_curr, (1 + np.sqrt(1 + 4 * d_curr * d_curr)) / 2
    return alpha


def lae_weights_t(
    Xt: torch.Tensor,
    anchors: torch.Tensor,
    knn_idx_t: torch.Tensor,
    iters: int = 150,
) -> torch.Tensor:
    """``lae_weights`` on the chunked feature-major layout of
    ``ops.colmajor``: Xt (d, n), knn_idx_t (nch, r, c) with nch·c ≥ n →
    weights (nch, r, c), exactly 0 on the pad points past n.

    float32 with r ≤ 16 is one launch of the hand-written kernel over the
    whole cloud; float64 and wider r take the plain version chunk by chunk."""
    from . import hopper_kernels

    if (Xt.dtype == torch.float32 and anchors.dtype == torch.float32
            and knn_idx_t.shape[1] <= KERNEL_MAX_R):
        return hopper_kernels.lae_weights_t(Xt, anchors, knn_idx_t.to(torch.int32), iters)
    return hopper_kernels.lae_weights_t_plain(Xt, anchors, knn_idx_t, iters)


def lae_weights_plain(
    X: torch.Tensor,
    anchors: torch.Tensor,
    knn_idx: torch.Tensor,
    iters: int = 150,
) -> torch.Tensor:
    """FISTA over all points at once: momentum d' = (1 + √(1 + 4d²))/2,
    step 1/L with L = max row-abs-sum of G + 1e-12, start z = 1/r.

    Every sum runs in a fixed order with each product rounded on its own (no
    fused multiply-add), the order the CUDA kernel repeats.  With nearly
    collinear anchors (points on a curve) the problem is ill-conditioned and
    150 steps do not converge, so the iterate keeps the imprint of rounding;
    the same order keeps kernel and plain version together there."""
    Ui = anchors[knn_idx.long()]                         # (n, r, d)
    r, d = Ui.shape[1], Ui.shape[2]
    G = Ui[:, :, None, 0] * Ui[:, None, :, 0]            # (n, r, r) Gram
    b = X[:, None, 0] * Ui[:, :, 0]                      # (n, r)
    for k in range(1, d):
        G = G + Ui[:, :, None, k] * Ui[:, None, :, k]
        b = b + X[:, None, k] * Ui[:, :, k]

    # Gershgorin bound: λmax ≤ max_i Σ_j |G_ij|;  jitter guards degenerate rows.
    absG = torch.abs(G)
    rowsum = absG[:, :, 0]
    for c in range(1, r):
        rowsum = rowsum + absG[:, :, c]
    inv_L = (1.0 / (torch.amax(rowsum, dim=1) + 1e-12))[:, None]

    z_prev = z = torch.full_like(b, 1.0 / r)
    # the momentum scalars follow the data's precision, as in the kernel
    one = np.float32(1.0) if X.dtype == torch.float32 else np.float64(1.0)
    d_prev, d_curr = one * 0, one
    for _ in range(iters):
        alpha = (d_prev - 1) / d_curr
        v = z + float(alpha) * (z - z_prev)
        grad = v[:, 0:1] * G[:, 0, :]
        for a in range(1, r):
            grad = grad + v[:, a:a + 1] * G[:, a, :]
        z_prev, z = z, project_simplex(v - inv_L * (grad - b))
        d_prev, d_curr = d_curr, (1 + np.sqrt(1 + 4 * d_curr * d_curr)) / 2
    return z
