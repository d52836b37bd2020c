"""Whitened low-rank latent parameterization of heat-kernel GPs.

The latent function at the m observed points is

    f = V · diag(exp(−t·λ/2)) · u,   u ~ N(0, I_K)

(``flgp_tpu.models.latent``), so the prior on the K-dimensional whitened
vector u is isotropic and a density evaluation is one (m, K) product, no
Cholesky.  The densities here are batched over chains: ``x`` is
``(..., dim)`` and a density is ``(...)``.  Each class has one density and
its analytic gradient (``value_and_grad``): two products, F = (U ⊙ S)·Vᵀ
forward and R·V back, and elementwise work, so a leapfrog step builds no
autograd tape.  ``precision=None`` runs both products at full float32;
``"tf32"`` (the counterpart of the JAX package's ``Precision.DEFAULT``) runs
them, and only them, in TF32 on the card, restoring
``torch.backends.cuda.matmul.allow_tf32`` afterwards: the graph stage stays at
full precision (``config.pin_full_precision``).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import EPS
from ..types import EigenPair

PRECISIONS = (None, "tf32")


class WhitenedGP(NamedTuple):
    """Static data of a whitened heat-kernel GP at a set of points."""

    V: torch.Tensor       # (m, K) spectral features at the observed points
    lam: torch.Tensor     # (K,) Laplacian eigenvalues 1 - λ(W)
    sigma: float          # ridge on the covariance diagonal


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        if d.index is not None:
            return d.index
        return torch.cuda.current_device() if d.type == "cuda" else 0

    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and index(a) == index(b)


def make_whitened(eigenpair: EigenPair, idx, K: int, sigma: float, device=None) -> WhitenedGP:
    """The whitened GP at the rows ``idx`` of the spectral pair.  ``device``:
    the CUDA device unless the caller names one; the pair must live there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: the samplers run on the card by default; '
                               'pass device="cpu" to build the model on the CPU')
        device = "cuda"
    vectors = eigenpair.vectors
    if not _same_device(vectors.device, device):
        raise ValueError(f"the eigenpair is on {vectors.device}, the model on {torch.device(device)}")
    idx = torch.as_tensor(idx, dtype=torch.int64, device=vectors.device)
    return WhitenedGP(vectors[idx, :K], eigenpair.laplacian_eigenvalues(K), float(sigma))


def whitened_inv_mass0(gp: WhitenedGP, t0: float, obs_curvature: float, n_hyper: int
                       ) -> torch.Tensor:
    """Analytic warmup-metric seed for HMC/NUTS/ChEES over a whitened GP
    posterior: Var[u_k | Y] ≈ 1/(1 + c̄·‖Φ_k‖²) with Φ_k = V_k·exp(−t0·λ_k/2)
    and c̄ the average observation curvature (¼ for the logit link,
    1/noise_var for Gaussian); the hyperparameter coordinates get unit mass.
    Whitened feature scales that span orders of magnitude (the Nyström
    spectrum) make a posterior a ones-seeded diagonal adaptation cannot
    recover inside a short warmup."""
    colsq = torch.sum(gp.V * gp.V, dim=0) * torch.exp(-t0 * gp.lam)
    var = 1.0 / (1.0 + obs_curvature * colsq)
    return torch.cat([var, torch.ones((n_hyper,), dtype=var.dtype, device=var.device)])


@contextlib.contextmanager
def _matmul_precision(precision: Optional[str], like: torch.Tensor):
    """TF32 for the products inside, on the card, when asked; the flag is
    restored whatever happens.  A CPU float32 product has no TF32 mode."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision is None or like.device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _scale(gp: WhitenedGP, t: torch.Tensor) -> torch.Tensor:
    """exp(−t·λ/2), shape t.shape + (K,)."""
    return torch.exp(-0.5 * t[..., None] * gp.lam)


def latent_f(gp: WhitenedGP, u: torch.Tensor, t, precision: Optional[str] = None
             ) -> torch.Tensor:
    """f = V·diag(exp(−t·λ/2))·u for u (..., K) and t (...): (..., m).  Its
    marginal variance is the heat kernel's up to the σ ridge."""
    t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
    with _matmul_precision(precision, u):
        return torch.matmul(_scale(gp, t) * u, gp.V.mT)


def log_prior_u(u: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(u * u, dim=-1)


def t_log_prior_density(t, p: float, q: float, tau: float) -> torch.Tensor:
    """log p(t) ∝ −p·log t − (t/τ)^(−q): the reference's penalty with its
    sign flipped to a density."""
    return -(p * torch.log(t + EPS) + (t / tau) ** (-q))


def bernoulli_logit_loglik(f: torch.Tensor, Y: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """Binomial-logit log likelihood (counts Y of N trials), summed over the
    last axis."""
    return torch.sum(Y * F.logsigmoid(f) + (N - Y) * F.logsigmoid(-f), dim=-1)


def gaussian_loglik(f: torch.Tensor, Y: torch.Tensor, noise_var) -> torch.Tensor:
    """Gaussian log likelihood summed over the last axis; ``noise_var`` is a
    scalar or one value per leading index of f."""
    nv = torch.as_tensor(noise_var, dtype=f.dtype, device=f.device)[..., None]
    return -0.5 * torch.sum((Y - f) ** 2 / nv + torch.log(2.0 * math.pi * nv), dim=-1)


def _theta_log_prior(theta, t, p, q, tau, mu0, s0):
    """Proper prior density in θ = log t: a lognormal base N(θ; μ0, s0²)
    tilted by the reference's penalty.  The penalty alone, with the log-t
    Jacobian, is improper upward (its θ-density grows like e^{(1−p)θ}), and a
    wide-exploring sampler runs away to θ = ∞ once the heat kernel washes
    out; with the base the target is proper and is the SMC/quadrature
    hyperposterior."""
    z = (theta - mu0) / s0
    base = -0.5 * z * z - math.log(s0) - 0.5 * math.log(2.0 * math.pi)
    return base + t_log_prior_density(t, p, q, tau)


def _theta_log_prior_grad(theta, t, p, q, tau, mu0, s0):
    """d/dθ of :func:`_theta_log_prior`, with t = exp(θ)."""
    return -(theta - mu0) / (s0 * s0) - p * t / (t + EPS) + q * (t / tau) ** (-q)


def _forward(gp: WhitenedGP, u, theta, precision):
    """t, exp(−t·λ/2), its product with u, and f = (u ⊙ scale)·Vᵀ."""
    t = torch.exp(theta)
    scale = _scale(gp, t)
    su = scale * u
    with _matmul_precision(precision, u):
        f = torch.matmul(su, gp.V.mT)
    return t, scale, su, f


def _backward(gp: WhitenedGP, u, t, scale, su, r, precision):
    """The gradient in u and in θ of log p(u) + ℓ(f), given r = dℓ/df."""
    with _matmul_precision(precision, u):
        rv = torch.matmul(r, gp.V)
    g_u = rv * scale - u
    g_theta = -0.5 * t * torch.sum(rv * su * gp.lam, dim=-1)
    return g_u, g_theta


class GpcLogPost(NamedTuple):
    """Joint log posterior of (u, log t) for the heat-kernel GPC.

    Flattened layout: x = [u (K,), log_t].  The t-prior is the proper
    lognormal-tilted density of :func:`_theta_log_prior`.  Calling it gives
    the density; :meth:`value_and_grad` the density and its gradient; both
    run the same code.
    """

    gp: WhitenedGP
    Y: torch.Tensor
    N: torch.Tensor
    p: float
    q: float
    tau: float
    mu0: float = 2.3
    s0: float = 1.5
    precision: Optional[str] = None

    @property
    def dim(self) -> int:
        return self.gp.V.shape[1] + 1

    @property
    def device(self) -> torch.device:
        return self.gp.V.device

    def unpack(self, x):
        return x[..., :-1], torch.exp(x[..., -1])

    def _evaluate(self, x: torch.Tensor, with_grad: bool):
        u, theta = x[..., :-1], x[..., -1]
        t, scale, su, f = _forward(self.gp, u, theta, self.precision)
        hyper = (theta, t, self.p, self.q, self.tau, self.mu0, self.s0)
        lp = log_prior_u(u) + bernoulli_logit_loglik(f, self.Y, self.N) + _theta_log_prior(*hyper)
        if not with_grad:
            return lp, None
        r = self.Y - self.N * torch.sigmoid(f)
        g_u, g_theta = _backward(self.gp, u, t, scale, su, r, self.precision)
        g_theta = g_theta + _theta_log_prior_grad(*hyper)
        return lp, torch.cat([g_u, g_theta[..., None]], dim=-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._evaluate(x, False)[0]

    def value_and_grad(self, x: torch.Tensor):
        """(log density (...), gradient (..., dim)) for x (..., dim)."""
        return self._evaluate(x, True)


class GprLogPost(NamedTuple):
    """Joint log posterior of (u, log t, log noise) for heat-kernel GPR.

    Flattened layout: x = [u (K,), log_t, log_noise].  The noise prior is
    inverse-gamma on noise + σ with the log-noise Jacobian, proper for α > 0.
    """

    gp: WhitenedGP
    Y: torch.Tensor
    p: float
    q: float
    tau: float
    alpha: float
    beta: float
    mu0: float = 2.3
    s0: float = 1.5
    precision: Optional[str] = None

    @property
    def dim(self) -> int:
        return self.gp.V.shape[1] + 2

    @property
    def device(self) -> torch.device:
        return self.gp.V.device

    def unpack(self, x):
        return x[..., :-2], torch.exp(x[..., -2]), torch.exp(x[..., -1])

    def _evaluate(self, x: torch.Tensor, with_grad: bool):
        u, theta, psi = x[..., :-2], x[..., -2], x[..., -1]
        noise = torch.exp(psi)
        z = noise + self.gp.sigma
        t, scale, su, f = _forward(self.gp, u, theta, self.precision)
        hyper = (theta, t, self.p, self.q, self.tau, self.mu0, self.s0)
        lp = log_prior_u(u) + gaussian_loglik(f, self.Y, z) + _theta_log_prior(*hyper)
        lp = lp - ((self.alpha + 1.0) * torch.log(z) + self.beta / z) + torch.log(noise)
        if not with_grad:
            return lp, None
        resid = self.Y - f
        g_u, g_theta = _backward(self.gp, u, t, scale, su, resid / z[..., None], self.precision)
        g_theta = g_theta + _theta_log_prior_grad(*hyper)
        m = self.Y.shape[-1]
        d_z = (0.5 * torch.sum(resid * resid, dim=-1) / (z * z) - 0.5 * m / z
               - (self.alpha + 1.0) / z + self.beta / (z * z))
        g_psi = d_z * noise + 1.0
        return lp, torch.cat([g_u, g_theta[..., None], g_psi[..., None]], dim=-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._evaluate(x, False)[0]

    def value_and_grad(self, x: torch.Tensor):
        """(log density (...), gradient (..., dim)) for x (..., dim)."""
        return self._evaluate(x, True)


def logpost_with_precision(base, precision: Optional[str]):
    """The same posterior as ``base`` (a :class:`GpcLogPost` or
    :class:`GprLogPost`) with its two latent products at ``precision``:
    ``None`` for full float32, ``"tf32"`` for TF32 on the card.  It is the
    same density object with one field changed; nothing is re-implemented."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return base._replace(precision=precision)
