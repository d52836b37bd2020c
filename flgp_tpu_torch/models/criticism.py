"""Model criticism: held-out negative log likelihood; the port of
``flgp_tpu.models.criticism``.

The analytic Gaussian NLL for regression; for (multi)classification a
Monte-Carlo integral of the Bernoulli likelihood under the Gaussian posterior,
with 100 samples and a 1e-2 stabilizer inside the log.  The draws come from
the caller's ``torch.Generator``, on the moments' device.
"""

from __future__ import annotations

import math

import torch

from ..config import EPS


def nll_regression(mean: torch.Tensor, cov: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Gaussian predictive NLL, averaged over the points."""
    sq = (target - mean) ** 2 / cov
    return (torch.mean(sq + torch.log(cov + EPS)) + math.log(2.0 * math.pi)) / 2.0


def nll_classification(generator: torch.Generator, mean: torch.Tensor, cov: torch.Tensor,
                       target: torch.Tensor, n_samples: int = 100) -> torch.Tensor:
    """MC estimate of the Bernoulli predictive NLL of 0/1 targets."""
    eps = torch.randn((mean.shape[0], n_samples), generator=generator, dtype=mean.dtype,
                      device=mean.device)
    f = mean[:, None] + torch.sqrt(torch.clamp(cov, min=0.0))[:, None] * eps
    pi = torch.sigmoid(f)
    like = torch.mean(pi * target[:, None] + (1.0 - pi) * (1.0 - target[:, None]), dim=1)
    return -torch.mean(torch.log(like + 1e-2))


def negative_log_likelihood(generator: torch.Generator, mean: torch.Tensor, cov: torch.Tensor,
                            target: torch.Tensor, kind: str = "regression",
                            n_samples: int = 100) -> torch.Tensor:
    """Dispatch on the task: "regression", "binary" or "multinomial" (mean
    and cov (n, J), integer targets 0..J−1: the sum of the J one-vs-rest
    NLLs, each class with its own draws)."""
    if kind == "regression":
        return nll_regression(mean, cov, target)
    if kind == "binary":
        return nll_classification(generator, mean, cov, target, n_samples)
    if kind == "multinomial":
        J = mean.shape[1]
        onehot = torch.nn.functional.one_hot(target.to(torch.int64), J).to(mean.dtype)
        return sum(nll_classification(generator, mean[:, j], cov[:, j], onehot[:, j], n_samples)
                   for j in range(J))
    raise ValueError(f"unknown criticism kind: {kind}")
