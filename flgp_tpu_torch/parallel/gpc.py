"""The binary-GPC tail with the row axis sharded over processes: Laplace
Newton, the approximate marginal, posterior moments and prediction.

Rows (train and test alike) live sharded; everything goes through the
whitened K-dim feature map

    Φ = V · diag(exp(−t·λ/2)),   C = ΦΦᵀ + σI

so a Newton step is Woodbury in K dimensions:

    B = I + √W·C·√W = D + ΨΨᵀ,   D = diag(1 + σW),  Ψ = √W·Φ
    B⁻¹ = D⁻¹ − D⁻¹Ψ·S⁻¹·ΨᵀD⁻¹,  S = I_K + ΨᵀD⁻¹Ψ

Every contraction over rows (ΨᵀD⁻¹Ψ, Φᵀb, …) is an all-reduce; the only
replicated work is one K×K Cholesky a step, and the loop's condition is one
host read of an all-reduced scalar, so every rank runs the same number of
steps.  Predictive moments use M_K = A₁ − A₁S⁻¹A₁ with A₁ = Φᵀ(W/d)Φ, so a
row's variance is a local quadratic form; no (n, m) block exists.
"""

from __future__ import annotations

import torch

from ..config import EPS
from ..ops import linalg
from .mesh import Mesh


def _phi(values, vectors_local, K: int, t) -> torch.Tensor:
    lam = 1.0 - values[:K]
    return vectors_local[:, :K] * torch.exp(-0.5 * t * lam)[None, :]


def _sum_rows(mesh: Mesh, *parts) -> list:
    """All-reduce several partial sums as one buffer; returns them reduced,
    in their shapes."""
    flat = mesh.psum(torch.cat([p.reshape(-1) for p in parts]))
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return out


def sharded_gpc_laplace_fn(mesh: Mesh, K: int, sigma: float, tol: float = 1e-5,
                           max_iter: int = 100, axis: str = "data"):
    """fn(values, vectors_local, Y_local, N_local, mask_local, t) →
    (amll, mean_local, var_local, label_local).

    ``mask_local`` ∈ {0, 1} marks the training rows, whose labels and
    counts sit in Y_local and N_local (zeros elsewhere).  ``amll`` is the
    replicated Laplace-approximate marginal log likelihood, the number the
    dense tail's training maximizes; mean and var are the Laplace posterior
    moments at every local row (GPML Alg 3.2), label the sign of the mean."""
    mesh.check_axis(axis)

    def fn(values, vectors_local, Y_local, N_local, mask_local, t):
        phi = _phi(values, vectors_local, K, t)          # (rows_local, K)
        phi_m = phi * mask_local[:, None]                # train rows only
        Y = Y_local * mask_local
        N = N_local * mask_local
        eyeK = torch.eye(K, dtype=phi.dtype, device=phi.device)

        def cov_vec(a):
            """C·a on the train rows: Φ_m(Φ_mᵀa) + σa."""
            pa = mesh.psum(linalg.pdot(phi_m.T, a[:, None])[:, 0])
            return linalg.pdot(phi_m, pa[:, None])[:, 0] + sigma * a

        def newton_step(f):
            pi = torch.sigmoid(f) * mask_local
            W = N * pi * (1.0 - pi)
            sqrt_W = torch.sqrt(W)
            d = 1.0 + sigma * W
            b = W * f + (Y - N * pi)
            h = sqrt_W * cov_vec(b)
            # ΨᵀD⁻¹h = Φᵀ(√W·h/d): no division by √W (it is 0 on masked rows)
            A1, rhs, logd = _sum_rows(
                mesh, linalg.pdot(phi_m.T, (W / d)[:, None] * phi_m),
                linalg.pdot(phi_m.T, (sqrt_W * h / d)[:, None])[:, 0],
                torch.sum(torch.log(d)))
            L_S = linalg.cholesky(A1 + eyeK)
            sol = linalg.chol_solve(L_S, rhs[:, None])[:, 0]
            u = h / d - (sqrt_W / d) * linalg.pdot(phi_m, sol[:, None])[:, 0]
            a = b - sqrt_W * u
            logdet_half = 0.5 * (logd + 2.0 * torch.sum(torch.log(torch.diagonal(L_S) + EPS)))
            return cov_vec(a), a, logdet_half

        f = torch.zeros_like(Y)
        a, logdet_half = torch.zeros_like(Y), torch.zeros((), dtype=Y.dtype, device=Y.device)
        it, delta = 0, float("inf")
        while it < max_iter and delta >= tol:
            f_new, a, logdet_half = newton_step(f)
            delta = float(mesh.psum(torch.sum(torch.abs(f - f_new))))
            f, it = f_new, it + 1

        # the marginal at the mode (masked rows add nothing to the likelihood)
        loglik = torch.sum(mask_local * (Y * torch.nn.functional.logsigmoid(f)
                                         + (N - Y) * torch.nn.functional.logsigmoid(-f)))
        af, ll = _sum_rows(mesh, torch.sum(a * f), loglik)
        amll = -0.5 * af + ll - logdet_half

        # predictive moments at every local row:
        # mean = Φ·(Φ_mᵀ(Y − Nπ));  var = C22 − φᵀ·M_K·φ
        pi = torch.sigmoid(f) * mask_local
        W = N * pi * (1.0 - pi)
        d = 1.0 + sigma * W
        resid, A1 = _sum_rows(mesh, linalg.pdot(phi_m.T, (Y - N * pi)[:, None])[:, 0],
                              linalg.pdot(phi_m.T, (W / d)[:, None] * phi_m))
        mean_local = linalg.pdot(phi, resid[:, None])[:, 0]
        L_S = linalg.cholesky(A1 + eyeK)
        M_K = A1 - linalg.pdot(A1, linalg.chol_solve(L_S, A1))
        c22 = torch.sum(phi * phi, dim=1) + sigma
        var_local = c22 - torch.sum(linalg.pdot(phi, M_K) * phi, dim=1)
        label_local = (torch.sigmoid(mean_local) > 0.5).to(phi.dtype)
        return amll, mean_local, var_local, label_local

    return fn


def sharded_predict_weights_fn(mesh: Mesh, K: int, axis: str = "data"):
    """fn(values, vectors_local, w_local, mask_local, t, sigma) → C[:, train]·w
    at every local row, for any dual weight vector w on the masked train rows
    (zeros at test rows): the shape of PG-Gibbs or whitened-HMC collapsed
    prediction."""
    mesh.check_axis(axis)

    def fn(values, vectors_local, w_local, mask_local, t, sigma):
        phi = _phi(values, vectors_local, K, t)
        wm = w_local * mask_local
        pw = mesh.psum(linalg.pdot((phi * mask_local[:, None]).T, wm[:, None])[:, 0])
        return linalg.pdot(phi, pw[:, None])[:, 0] + sigma * wm

    return fn
