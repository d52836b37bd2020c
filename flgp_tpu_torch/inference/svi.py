"""Stochastic variational inference for the whitened spectral GP models.

Two reparameterized Gaussian families trained with Adam on the ELBO, as
``flgp_tpu.inference.svi`` trains them:

- :class:`MeanField` — diagonal covariance.  It cannot represent posterior
  correlations: on a correlated target the marginal sds can be right while
  the joint under-covers.  The whitened spectral GP posteriors are
  near-independent by construction, which is why it is the default tier;
  check it against an MCMC run on a new model.
- :class:`LowRankGaussian` — covariance D + W·Wᵀ (diagonal plus a rank-R
  factor).  Its entropy takes the matrix determinant lemma, so nothing
  dim × dim is formed.

The log density is batched, ``(n, dim) -> (n,)``.  The ELBO's gradient is
the reparameterization's chain rule written out: ∇ log p at the draws comes
from the model's analytic ``value_and_grad`` (``models.latent``: its two
latent products; ``torch.autograd`` of the density alone where it has none),
and each family maps it, with the entropy's gradient, onto its parameters.
No autograd tape is built, since on the card a step is the host's launch
pace.  Adam is written out (β 0.9/0.999, bias-corrected, ε 1e-8) on the
family's parameters as one flat vector; the ELBO trace stays on the device,
and no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..config import resolve_device
from ..models.latent import _same_device
from ..ops import linalg
from .hmc import value_and_grad

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


def _randn(like: torch.Tensor, shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


class MeanField(NamedTuple):
    mu: torch.Tensor
    log_scale: torch.Tensor

    def draw(self, generator: torch.Generator, n: int):
        """n draws and the standard-normal noise they were made from."""
        eps = _randn(self.mu, (n,) + tuple(self.mu.shape), generator)
        return self.mu + torch.exp(self.log_scale) * eps, (eps,)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.draw(generator, n)[0]

    def entropy(self) -> torch.Tensor:
        d = self.mu.shape[0]
        return 0.5 * d * (1.0 + math.log(2.0 * math.pi)) + torch.sum(self.log_scale)

    def covariance(self) -> torch.Tensor:
        return torch.diag(torch.exp(2.0 * self.log_scale))

    def elbo_grad(self, g: torch.Tensor, noise) -> Tuple[torch.Tensor, ...]:
        """The gradient of mean(log p(draws)) + entropy in (mu, log_scale),
        given g = ∇ log p at the draws (n, dim) and their noise."""
        (eps,) = noise
        return (torch.mean(g, dim=0),
                torch.mean(g * eps, dim=0) * torch.exp(self.log_scale) + 1.0)


class LowRankGaussian(NamedTuple):
    """q(x) = N(mu, diag(exp(2·log_scale)) + W·Wᵀ), W: (dim, rank)."""

    mu: torch.Tensor
    log_scale: torch.Tensor
    W: torch.Tensor

    def draw(self, generator: torch.Generator, n: int):
        dim, rank = self.W.shape
        eps = _randn(self.mu, (n, dim), generator)
        z = _randn(self.mu, (n, rank), generator)
        return self.mu + torch.exp(self.log_scale) * eps + z @ self.W.T, (eps, z)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.draw(generator, n)[0]

    def _small(self) -> torch.Tensor:
        """S = I_R + Wᵀ D⁻¹ W."""
        rank = self.W.shape[1]
        d_inv = torch.exp(-2.0 * self.log_scale)
        return torch.eye(rank, dtype=self.mu.dtype, device=self.mu.device) + self.W.T @ (
            d_inv[:, None] * self.W)

    def entropy(self) -> torch.Tensor:
        """0.5·logdet(2πe·(D + WWᵀ)) by the matrix determinant lemma:
        logdet(D + WWᵀ) = logdet(D) + logdet(I_R + Wᵀ D⁻¹ W)."""
        dim = self.W.shape[0]
        logdet = 2.0 * torch.sum(self.log_scale) + torch.linalg.slogdet(self._small())[1]
        return 0.5 * dim * (1.0 + math.log(2.0 * math.pi)) + 0.5 * logdet

    def covariance(self) -> torch.Tensor:
        """Dense (dim, dim) covariance: diagnostics only."""
        return torch.diag(torch.exp(2.0 * self.log_scale)) + self.W @ self.W.T

    def elbo_grad(self, g: torch.Tensor, noise) -> Tuple[torch.Tensor, ...]:
        """As :meth:`MeanField.elbo_grad`, in (mu, log_scale, W).  The
        entropy's part: ∂½logdet S/∂W = D⁻¹WS⁻¹ and
        ∂½logdet S/∂log_scale_i = −D⁻¹ᵢ·wᵢᵀS⁻¹wᵢ (S⁻¹ from a Cholesky factor
        that is NaN, not an error, where S is not positive definite)."""
        eps, z = noise
        d_inv = torch.exp(-2.0 * self.log_scale)
        WS = self.W @ torch.cholesky_inverse(linalg.cholesky(self._small()))      # W·S⁻¹
        g_ls = (torch.mean(g * eps, dim=0) * torch.exp(self.log_scale) + 1.0
                - d_inv * torch.sum(WS * self.W, dim=1))
        g_W = g.T @ z / g.shape[0] + d_inv[:, None] * WS
        return torch.mean(g, dim=0), g_ls, g_W


Family = Union[MeanField, LowRankGaussian]


class SviResult(NamedTuple):
    posterior: Family
    elbo_trace: torch.Tensor     # (steps,) on the device


def _adam_elbo(q0: Family, logprob: LogProbFn, generator: torch.Generator, steps: int,
               n_mc: int, lr: float) -> SviResult:
    """Maximize E_q[log p(x)] + H(q) with Adam on the family's parameters,
    held as one flat vector."""
    vg = value_and_grad(logprob)
    shapes = [f.shape for f in q0]
    sizes = [f.numel() for f in q0]
    theta = torch.cat([f.detach().reshape(-1) for f in q0])
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    b1, b2 = 0.9, 0.999
    elbo = theta.new_empty((steps,))

    def unflatten(flat):
        return type(q0)(*(p.view(shape) for p, shape in zip(flat.split(sizes), shapes)))

    for i in range(steps):
        q = unflatten(theta)
        x, noise = q.draw(generator, n_mc)
        lp, g = vg(x)
        elbo[i] = torch.mean(lp) + q.entropy()
        grad = torch.cat([p.reshape(-1) for p in q.elbo_grad(g, noise)])
        m.mul_(b1).add_(grad, alpha=1 - b1)
        v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
        ic = i + 1.0
        # ascend the ELBO: the reference's descent on −ELBO, sign for sign
        theta = theta + lr * (m / (1 - b1**ic)) / (torch.sqrt(v / (1 - b2**ic)) + 1e-8)
    return SviResult(unflatten(theta), elbo)


def _start(generator: torch.Generator, logprob, device, init_mu, dim: int, dtype):
    device = resolve_device(device, "the SVI fits")
    if not _same_device(generator.device, device):
        raise ValueError(f"generator is on {generator.device}, the fit on {device}")
    model_device = getattr(logprob, "device", None)
    if model_device is not None and not _same_device(model_device, device):
        raise ValueError(f"the model is on {model_device}, the fit on {device}")
    if init_mu is None:
        return torch.zeros((dim,), dtype=dtype, device=device)
    return torch.as_tensor(init_mu, dtype=dtype, device=device)


def fit_svi(generator: torch.Generator, logprob: LogProbFn, dim: int, steps: int = 1000,
            n_mc: int = 8, lr: float = 0.02, init_mu: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32, device=None) -> SviResult:
    """Mean-field SVI from mu = 0 (or ``init_mu``) and log_scale = −2.
    ``device``: the CUDA device unless the caller names one; the generator
    and the model must live there."""
    mu0 = _start(generator, logprob, device, init_mu, dim, dtype)
    return _adam_elbo(MeanField(mu0, torch.full_like(mu0, -2.0)), logprob, generator, steps,
                      n_mc, lr)


def fit_svi_lowrank(generator: torch.Generator, logprob: LogProbFn, dim: int, rank: int = 5,
                    steps: int = 1000, n_mc: int = 8, lr: float = 0.02,
                    init_mu: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
                    device=None) -> SviResult:
    """Low-rank-plus-diagonal SVI: mean-field's cost plus one (dim, rank)
    factor, which captures the top-``rank`` correlation directions."""
    mu0 = _start(generator, logprob, device, init_mu, dim, dtype)
    # at W = 0 the entropy's gradient in W vanishes (a weak saddle): start
    # from a small random factor
    W0 = 0.01 * _randn(mu0, (dim, rank), generator) / math.sqrt(dim)
    return _adam_elbo(LowRankGaussian(mu0, torch.full_like(mu0, -2.0), W0), logprob, generator,
                      steps, n_mc, lr)
