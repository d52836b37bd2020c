"""The O(n·K) binary-GPC predict tail for fits too large for an (n, m)
cross-covariance (n = 1e7 and m = 1000 would need 80 GB in float64).

Prediction anywhere is C[·, train]·adj with C = ΦΦᵀ + σI and Φ the K-dim
heat-kernel factor of the eigenvectors, so the tail streams row blocks of
the (n, K) eigenvector store and never forms an (n, m) block.  The vectors
may stay float32 on the device: each row block is cast to the solve dtype
(``cfg.dtype``) on its own, so the store is never copied whole.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..config import FitConfig
from ..inference.pg_gibbs import collapsed_adjoints, pg_gibbs_chain_trace
from ..models.gpc import _newton_mode
from ..ops import linalg
from ..ops.heat_kernel import heat_kernel, heat_kernel_weights
from ..types import EigenPair


def _phi_train(eig: EigenPair, t, K: int, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened train-row features Φ_m = V_m·diag(exp(−t·λ/2)), the K-dim
    factor of the heat kernel, and the weights exp(−t·λ/2)."""
    w = torch.sqrt(heat_kernel_weights(eig, t, K))
    return eig.vectors[idx, :K] * w[None, :], w


def _pg_adjoints(generator: torch.Generator, Cvv, Y, N, n_gibbs: int, max_count: int,
                 avg_sweeps: int) -> torch.Tensor:
    """PG-Gibbs dual weights (S, m): the chain runs on the (m, m) train
    kernel as in ``test_pgbinary``, and each of the last S ω states gives
    adj = κ − √ω B⁻¹√ω (C κ), batched over the states."""
    _, _, om_trace = pg_gibbs_chain_trace(generator, Cvv, Y, n_gibbs, N, max_count)
    omegas = om_trace[-1:] if avg_sweeps <= 0 else om_trace[-min(avg_sweeps, n_gibbs):]
    return collapsed_adjoints(Cvv, Y, omegas, N)


def _chunked_rows(fn: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]], V: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, ...]:
    """``fn`` over row slices of V (views: V is neither padded nor copied),
    each result written into its slice of a preallocated (n, ...) output.
    Extra memory is what ``fn`` makes for one block."""
    n = V.shape[0]
    outs = None
    for lo in range(0, n, chunk):
        res = fn(V[lo:lo + chunk])
        if outs is None:
            outs = tuple(x.new_empty((n,) + tuple(x.shape[1:])) for x in res)
        for o, x in zip(outs, res):
            o[lo:lo + x.shape[0]] = x
    return outs


def _gpc_lowrank_tail(
    generator: torch.Generator,
    eig: EigenPair,
    Y: torch.Tensor,
    N: torch.Tensor,
    train_idx: torch.Tensor,
    K: int,
    cfg: FitConfig,
    t,
    max_count: int,
    chunk: int = 1 << 16,
):
    """Binary-GPC predict tail in O(n·K) memory: PG-Gibbs labels,
    Rao-Blackwellized probabilities and Laplace posterior moments at every
    row of the eigenpair.

    The (m, m) train kernel is the dense tail's (same Gibbs chain for the
    same generator state); everything n-sized streams through row blocks of
    ``eig.vectors``.  Returns (labels, probs, mean, var), each (n,) in
    ``cfg.dtype``."""
    dtype = cfg.dtype
    train_idx = torch.as_tensor(train_idx, device=eig.vectors.device).long()
    m = train_idx.shape[0]
    # the eigenvalues and the m train rows in the solve dtype
    eig_m = EigenPair(eig.values.to(dtype), eig.vectors[train_idx, :K].to(dtype))
    rows = torch.arange(m, device=train_idx.device)
    Cvv = linalg.add_diag(heat_kernel(eig_m, t, K, rows, rows), cfg.sigma)
    Phi_m, w_half = _phi_train(eig_m, t, K, rows)

    # PG-Gibbs prediction: projected duals (S, K)
    adjs = _pg_adjoints(generator, Cvv, Y, N, cfg.n_gibbs, max_count, cfg.gibbs_avg_sweeps)
    P = linalg.pdot(adjs, Phi_m)

    # Laplace posterior moments (GPML Alg 3.2) in K dimensions
    st = _newton_mode(Cvv, Y, torch.ones_like(Y), cfg.train.newton_tol,
                      cfg.train.newton_max_iter)
    pi_m = torch.sigmoid(st.f)
    sqrt_W = torch.sqrt(pi_m * (1.0 - pi_m))
    B = linalg.add_diag(sqrt_W[:, None] * Cvv * sqrt_W[None, :], 1.0)
    Binv = linalg.chol_solve(linalg.cholesky(B), torch.eye(m, dtype=dtype, device=Cvv.device))
    beta = sqrt_W[:, None] * Binv * sqrt_W[None, :]
    M = linalg.pdot(Phi_m.T, linalg.pdot(beta, Phi_m))          # (K, K)
    resid = linalg.pdot(Phi_m.T, (Y - pi_m)[:, None])[:, 0]      # (K,)

    def per_block(Vc):
        Phi_c = Vc[:, :K].to(dtype) * w_half[None, :]
        pi = torch.mean(torch.sigmoid(linalg.pdot(Phi_c, P.T)), dim=1)
        mean = linalg.pdot(Phi_c, resid[:, None])[:, 0]
        var = (torch.sum(Phi_c * Phi_c, dim=1) + cfg.sigma
               - torch.sum(linalg.pdot(Phi_c, M) * Phi_c, dim=1))
        return pi, mean, var

    pi_all, mean_all, var_all = _chunked_rows(per_block, eig.vectors, chunk)
    # train rows carry the σ-ridge cross term: their prediction row is Cvv,
    # which includes σ
    mu_train = linalg.pdot(Phi_m, P.T) + cfg.sigma * adjs.T      # (m, S)
    pi_all[train_idx] = torch.mean(torch.sigmoid(mu_train), dim=1)
    labels = (pi_all > 0.5).to(dtype)
    return labels, pi_all, mean_all, var_all
