"""Pólya-Gamma Gibbs sampling for GP logistic classification.

The chain alternates f | ω (a Gaussian draw, GPML Eq 3.27) and
ω | f ~ PG(N, f), then predicts with the collapsed mean under the ω states.

Every function also takes a leading class axis: C (J, m, m), Y (J, m) and
Cnv (J, n, m) run J independent chains as the lanes of one chain (one
batched Cholesky a sweep, one host loop), as the JAX package vmaps them over
the classes.  Without the axis each call is the single chain it always was,
with the same random stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import linalg
from ..ops.polya_gamma import polya_gamma, polya_gamma_counts


class PGChainState(NamedTuple):
    f: torch.Tensor       # (..., m) latent function values
    omega: torch.Tensor   # (..., m) PG auxiliaries


def _conditional_draw(C, L_C, kappa, omega, eps1, eps2):
    """f | ω by Matheron's rule from the standard normals ε₁, ε₂ — ONE m×m
    Cholesky per sweep.

    The conditional is N(μ, Σ) with Σ = C − C√ω B⁻¹√ω C, μ = Σκ,
    B = √ωC√ω + I.  The zero-mean part is

        f₀ = g − C√ω B⁻¹(√ω g + u),   g = L_C ε₁ ~ N(0, C),  u = ε₂ ~ N(0, I)

    whose covariance is exactly Σ, and μ = Cκ − C√ω B⁻¹ √ω(Cκ).  No ω
    division anywhere, so tiny PG draws stay safe."""
    sqrt_om = torch.sqrt(omega)
    L_B = linalg.cholesky(linalg.add_diag(sqrt_om[..., :, None] * C * sqrt_om[..., None, :], 1.0))

    def mv(A, v):
        return linalg.pdot(A, v[..., None])[..., 0]

    a = mv(C, kappa)
    mu = a - mv(C, sqrt_om * linalg.chol_solve(L_B, (sqrt_om * a)[..., None])[..., 0])

    g = mv(L_C, eps1)
    c = linalg.chol_solve(L_B, (sqrt_om * g + eps2)[..., None])[..., 0]
    f0 = g - mv(C, sqrt_om * c)
    return mu + f0


def _resample_f(generator, C, L_C, kappa, omega):
    eps1 = torch.randn(kappa.shape, generator=generator, dtype=C.dtype, device=C.device)
    eps2 = torch.randn(kappa.shape, generator=generator, dtype=C.dtype, device=C.device)
    return _conditional_draw(C, L_C, kappa, omega, eps1, eps2)


def pg_gibbs_chain_trace(
    generator: torch.Generator,
    C: torch.Tensor,
    Y: torch.Tensor,
    n_sweeps: int = 100,
    N: Optional[torch.Tensor] = None,
    max_count: int = 1,
):
    """Run the PG Gibbs chain from ω₀ = 1, f₀ = 0 (no burn-in or thinning).

    Returns (final state, f trace (sweeps, ..., m), ω trace (sweeps, ..., m))."""
    m = Y.shape[-1]
    if N is None:
        N = torch.ones((m,), dtype=C.dtype, device=C.device)
    kappa = Y - N / 2.0
    L_C = linalg.cholesky(linalg.add_diag(C, 1e-10))

    state = PGChainState(C.new_zeros(Y.shape), C.new_ones(Y.shape))
    f_trace, omega_trace = [], []
    for _ in range(n_sweeps):
        f = _resample_f(generator, C, L_C, kappa, state.omega)
        if max_count == 1:
            omega = polya_gamma(generator, f)
        else:
            omega = polya_gamma_counts(generator, N.to(torch.int64), f, max_count)
        state = PGChainState(f, omega)
        f_trace.append(f)
        omega_trace.append(omega)
    return state, torch.stack(f_trace), torch.stack(omega_trace)


def pg_gibbs_chain(generator, C, Y, n_sweeps: int = 100, N=None, max_count: int = 1
                   ) -> Tuple[PGChainState, torch.Tensor]:
    """Run the PG Gibbs chain; returns final state and the f trace (sweeps, ..., m)."""
    state, f_trace, _ = pg_gibbs_chain_trace(generator, C, Y, n_sweeps, N, max_count)
    return state, f_trace


def collapsed_adjoints(C, Y, omega, N=None) -> torch.Tensor:
    """Dual weights adj = κ − √ω B⁻¹√ω (Cκ) of the collapsed mean under ω, so
    that the latent mean at any row x is C[x, train]·adj.

    ω may carry leading batch dimensions (several states at once) before
    the class axis of C and Y, if any; the result then has the same leading
    dimensions."""
    m = Y.shape[-1]
    if N is None:
        N = torch.ones((m,), dtype=C.dtype, device=C.device)
    kappa = Y - N / 2.0
    sqrt_om = torch.sqrt(omega)
    L_B = linalg.cholesky(linalg.add_diag(sqrt_om[..., :, None] * C * sqrt_om[..., None, :], 1.0))
    Ck = linalg.pdot(C, kappa[..., None])[..., 0]
    return kappa - sqrt_om * linalg.chol_solve(L_B, (sqrt_om * Ck)[..., None])[..., 0]


def collapsed_predict(C, Cnv, Y, omega, N=None) -> torch.Tensor:
    """Collapsed posterior-mean probabilities at the rows of Cnv under ω
    (batched over leading dimensions of ω, as ``collapsed_adjoints``)."""
    adj = collapsed_adjoints(C, Y, omega, N)
    if Cnv.dim() == 2:
        return torch.sigmoid(linalg.pdot(adj, Cnv.T))
    # a class axis: one product a class, adj (..., J, m) against Cnv (J, n, m),
    # as J batched GEMMs (broadcasting Cnv over the states would copy it)
    lead, (J, m) = adj.shape[:-2], adj.shape[-2:]
    out = linalg.pdot(adj.reshape(-1, J, m).transpose(0, 1), Cnv.mT)      # (J, states, n)
    return torch.sigmoid(out.transpose(0, 1).reshape(lead + (J, Cnv.shape[1])))


def test_pgbinary(
    generator: torch.Generator,
    C: torch.Tensor,
    Y: torch.Tensor,
    Cnv: torch.Tensor,
    n_sweeps: int = 100,
    N: Optional[torch.Tensor] = None,
    max_count: int = 1,
    avg_sweeps: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the PG chain and predict labels/probabilities at the rows of Cnv.
    Returns (labels, probabilities), each (..., n).

    With ``avg_sweeps > 0`` the collapsed probabilities are averaged over the
    last ``avg_sweeps`` ω states (Rao-Blackwellized); ``avg_sweeps=0``
    predicts from the final state alone."""
    _, _, omega_trace = pg_gibbs_chain_trace(generator, C, Y, n_sweeps, N, max_count)
    if avg_sweeps <= 0:
        pi = collapsed_predict(C, Cnv, Y, omega_trace[-1], N)
    else:
        S = min(avg_sweeps, n_sweeps)
        pi = torch.mean(collapsed_predict(C, Cnv, Y, omega_trace[-S:], N), dim=0)
    return (pi > 0.5).to(Y.dtype), pi
