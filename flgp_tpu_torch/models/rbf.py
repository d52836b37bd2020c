"""Ambient-space RBF Subset-of-Regressors GP baseline.

The reference R package ships a Subset-of-Regressors sparse GP (GPML
Eq 8.17) that no fit driver calls; ``flgp_tpu.models.rbf`` carries it as part
of the capability surface, and so does the port: the NMLL (both noise
models, differentiated by ``torch.autograd``), its trainer and its predictor.

Kernel convention: C = exp(−d²/(2t)), t the squared-bandwidth
hyperparameter.  As in ``models.gpr``, ``t`` may be a batch of values, and
``noise`` has t's shape (homoscedastic) or one more trailing axis of length m
(per point); the NMLL then has t's shape.
"""

from __future__ import annotations

import torch

from ..config import EPS
from ..inference.optimize import GprOptResult, minimize_t_noise, minimize_t_noisevec
from ..ops import linalg
from .gpr import _as_2d, _noise_diag, noise_log_prior


def _kernel(dist: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.exp(-dist / (2.0 * t[..., None, None]))


def rbf_sor_nmll(dist_UU, dist_XU, Y, t, noise, sigma: float) -> torch.Tensor:
    """SoR negative marginal log likelihood, both noise models through the
    diagonal z = noise + σ."""
    Y = _as_2d(Y)
    m, q = Y.shape
    s = dist_UU.shape[0]
    t, z = _noise_diag(t, noise, sigma, m, Y)
    z_inv = 1.0 / z

    C_ss = _kernel(dist_UU, t)
    C_ms = _kernel(dist_XU, t)
    L_ss = linalg.cholesky(linalg.add_diag(C_ss, 1e-10))
    Q = C_ss + linalg.pdot(C_ms.mT, z_inv[..., :, None] * C_ms)
    L_Q = linalg.cholesky(Q)
    ZiY = z_inv[..., :, None] * Y
    alpha = ZiY - z_inv[..., :, None] * linalg.pdot(
        C_ms, linalg.chol_solve(L_Q, linalg.pdot(C_ms.mT, ZiY)))

    nmll = 0.5 * torch.sum(Y * alpha, dim=(-2, -1)) / q
    nmll = nmll + linalg.chol_logdet_half(L_Q) - linalg.chol_logdet_half(L_ss)
    return nmll + 0.5 * torch.sum(torch.log(z + EPS), dim=-1)


def rbf_sor_nmll_posterior(dist_UU, dist_XU, Y, t, noise, sigma: float, alpha: float = 1e-1,
                           beta: float = 1e-3) -> torch.Tensor:
    """NMLL plus the inverse-gamma noise penalty (averaged over the points
    under the per-point model)."""
    t = torch.as_tensor(t, dtype=dist_UU.dtype, device=dist_UU.device)
    noise = torch.as_tensor(noise, dtype=dist_UU.dtype, device=dist_UU.device)
    return rbf_sor_nmll(dist_UU, dist_XU, Y, t, noise, sigma) + noise_log_prior(
        noise, sigma, alpha, beta, per_point=noise.dim() > t.dim())


def train_rbf_sor(dist_UU, dist_XU, Y, sigma: float = 1e-5, posterior: bool = True,
                  per_point_noise: bool = False, dtype: torch.dtype = torch.float32
                  ) -> GprOptResult:
    """(t, noise) by the coarse grid and Adam of ``inference.optimize``, on
    the device of the distances."""
    nmll = rbf_sor_nmll_posterior if posterior else rbf_sor_nmll

    def fn(t, noise):
        return nmll(dist_UU, dist_XU, Y, t, noise, sigma)

    common = dict(t_lb=1e-4, noise_lb=1e-4, dtype=dtype, device=dist_UU.device)
    if per_point_noise:
        res = minimize_t_noisevec(fn, _as_2d(Y).shape[0], t0=1.0, **common)
    else:
        res = minimize_t_noise(fn, **common)
    return GprOptResult(*(v[0] for v in res))


def predict_rbf_sor(dist_UU, dist_XU, dist_newU, Y, t, noise, sigma: float) -> torch.Tensor:
    """SoR predictive mean (scalar t; scalar or (m,) noise)."""
    Y2 = _as_2d(Y)
    m = Y2.shape[0]
    t, z = _noise_diag(t, noise, sigma, m, Y2)
    z_inv = 1.0 / z
    C_ss = _kernel(dist_UU, t)
    C_ms = _kernel(dist_XU, t)
    L_Q = linalg.cholesky(C_ss + linalg.pdot(C_ms.mT, z_inv[:, None] * C_ms))
    alpha = linalg.chol_solve(L_Q, linalg.pdot(C_ms.mT, z_inv[:, None] * Y2))
    pred = linalg.pdot(_kernel(dist_newU, t), alpha)
    return pred[:, 0] if Y.dim() == 1 else pred
