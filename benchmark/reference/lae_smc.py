"""Plain reference of the one-vs-rest LAE hyperposterior: each class's
posterior over the diffusion time t, which the program samples by tempered SMC.

Written from the method's definition in plain PyTorch, independent of
flgp_tpu_torch: it imports nothing of the port and takes from ``lae_gpc.py``
the stages the point fit shares (nearest anchors, LAE weights, the spectrum,
the vectors, the Newton mode of the logit GP).  The target of class j over
θ = log t, up to a constant:

    log p(θ | y_j) = log N(θ; μ0, s0²) + log q(y_j | t) − p·log t − (t/τ)^−q

with log q the Laplace-approximate marginal likelihood of the logit GP whose
covariance on the training rows is V·diag(exp(−t(1 − σ)))·Vᵀ + sigma·I (the
dense m × m form, its Newton mode converged to a step under 1e-10), the
lognormal base N(μ0, s0²) the proper prior of θ, and the penalty
p·log t + (t/τ)^−q a tilt of the likelihood.  The classes' factors are
independent, so the joint posterior is their product and its evidence the
product of theirs.

Each class's posterior is 1-D, so quadrature gives it exactly: a coarse pass
of ``n_grid`` points over μ0 ± ``half_width_sds``·s0, then a refined pass of
``n_grid`` points over the coarse mean ± 8 coarse sd (at least one coarse
cell), whose weights give the θ- and t-moments and, as a Riemann sum, the
evidence.

``check`` judges the program's particles against the quadrature on the fit's
own eigenpair (its float32 values and vectors, upcast to float64 as the fit
casts them for the solve), and reads the quadrature on the reference's own
spectrum beside it.  The reference runs in float64 with TF32 off;
``CONTROL`` is one precision down, as in ``lae_gpc.py``, and ``control_fit``
puts it in the program's place: its own anchors, graph and spectrum, and
particles drawn from its own float32 quadrature.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch


def _base():
    spec = importlib.util.spec_from_file_location("bench_reference_lae_gpc",
                                                  Path(__file__).with_name("lae_gpc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _base()
F64, CONTROL = base.F64, base.CONTROL
LANE_BYTES = 1 << 30     # bytes of the dense covariances one Newton solve holds


class Posterior(NamedTuple):
    theta_mean: torch.Tensor     # (J,) posterior mean of θ = log t
    theta_sd: torch.Tensor       # (J,)
    t_mean: torch.Tensor         # (J,)
    t_sd: torch.Tensor           # (J,)
    log_z: torch.Tensor          # (J,) each class's log evidence
    thetas: torch.Tensor         # (J, n_grid) the refined grid
    weights: torch.Tensor        # (J, n_grid) its normalized weights
    coarse_max_weight: float     # near 1: the coarse grid collapsed onto one cell


def log_marginal(values: torch.Tensor, Vm: torch.Tensor, Y: torch.Tensor, t: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """The Laplace-approximate log marginal likelihood of the logit GP for
    lanes t (...,) against labels Y (..., m): −½aᵀf + log p(y | f) − ½ log det B
    at the mode."""
    w = base.heat_weights(values, t)
    C = (Vm * w[..., None, :]) @ Vm.T
    C = C + sigma * torch.eye(Vm.shape[0], dtype=C.dtype, device=C.device)
    f, a, logdet_half = base._newton(C, Y)
    lml = -0.5 * (a * f).sum(-1) + (Y * torch.nn.functional.logsigmoid(f)
                                     + (1 - Y) * torch.nn.functional.logsigmoid(-f)).sum(-1)
    return lml - logdet_half


def log_target(values, Vm, Yc, thetas, sigma: float, prior: dict) -> torch.Tensor:
    """log N(θ; μ0, s0²) + log q(y_j | t) − p·log t − (t/τ)^−q at each class's
    grid θ (J, G), the classes' labels Yc (J, m); the grid in blocks of lanes
    whose dense covariances fill ``LANE_BYTES``."""
    J, G = thetas.shape
    m = Vm.shape[0]
    per = max(1, LANE_BYTES // (J * m * m * thetas.element_size()))
    t = torch.exp(thetas)
    lml = torch.cat([log_marginal(values, Vm, Yc[:, None, :].expand(J, min(per, G - g), m),
                                  t[:, g:g + per], sigma) for g in range(0, G, per)], dim=1)
    mu0, s0 = prior["mu0"], prior["s0"]
    z = (thetas - mu0) / s0
    base_prior = -0.5 * z * z - math.log(s0) - 0.5 * math.log(2.0 * math.pi)
    tilt = -(prior["p"] * thetas + (t / prior["tau"]) ** (-prior["q"]))
    return base_prior + lml + tilt


def _weights(logw: torch.Tensor, thetas: torch.Tensor):
    """(normalized weights, θ-mean, θ-sd, log evidence) of each class's grid."""
    lse = torch.logsumexp(logw, dim=1)
    w = torch.exp(logw - lse[:, None])
    mean = (w * thetas).sum(1)
    sd = torch.sqrt((w * (thetas - mean[:, None]) ** 2).sum(1))
    return w, mean, sd, lse + torch.log(thetas[:, 1] - thetas[:, 0])


def quadrature(values: torch.Tensor, Vm: torch.Tensor, Yc: torch.Tensor, sigma: float,
               prior: dict, n_grid: int, half_width_sds: float) -> Posterior:
    """Each class's exact posterior over θ by the two-pass quadrature, in the
    dtype of ``values``."""
    J = Yc.shape[0]
    mu0, s0 = prior["mu0"], prior["s0"]
    coarse = torch.linspace(mu0 - half_width_sds * s0, mu0 + half_width_sds * s0, n_grid,
                            dtype=values.dtype, device=values.device).expand(J, n_grid)
    w0, mean0, sd0, _ = _weights(log_target(values, Vm, Yc, coarse, sigma, prior), coarse)
    half = torch.clamp(8.0 * sd0, min=float(coarse[0, 1] - coarse[0, 0]))
    steps = torch.linspace(0.0, 1.0, n_grid, dtype=values.dtype, device=values.device)
    fine = (mean0 - half)[:, None] + (2.0 * half)[:, None] * steps
    w, mean, sd, log_z = _weights(log_target(values, Vm, Yc, fine, sigma, prior), fine)
    ts = torch.exp(fine)
    t_mean = (w * ts).sum(1)
    t_sd = torch.sqrt((w * (ts - t_mean[:, None]) ** 2).sum(1))
    return Posterior(mean, sd, t_mean, t_sd, log_z, fine, w, float(w0.max()))


def prior_of(cfg: dict) -> dict:
    h = cfg["hyperposterior"]
    return dict(mu0=h["mu0"], s0=h["s0"], p=h["prior_p"], q=h["prior_q"], tau=h["prior_tau"])


def posterior_of(values, Vm, Yc, cfg: dict) -> Posterior:
    h = cfg["hyperposterior"]
    return quadrature(values, Vm, Yc, cfg["fit"]["sigma"], prior_of(cfg), h["quadrature_grid"],
                      h["quadrature_half_width_sds"])


# ---------------------------------------------------------------------------
# the check: the reference's readings of one fit's outputs
# ---------------------------------------------------------------------------


def sampler_readings(theta: torch.Tensor, log_evidence: float, quad: Posterior) -> dict:
    """The particles θ (P, J) and the sampler's log evidence against the
    quadrature: each class's |θ-mean gap| in quadrature sd (the worst and
    the mean over classes), the worst class's sd ratio either way up, the
    evidence gap in nats; read beside them, the t-means' worst gap in t-sd
    and the quadrature's own resolution and scale."""
    mean, sd = theta.mean(0), theta.std(0, correction=0)
    gap = torch.abs(mean - quad.theta_mean) / quad.theta_sd
    ratio = sd / quad.theta_sd
    t = torch.exp(theta)
    return {"theta_mean_gap": float(gap.max()), "theta_mean_gap_avg": float(gap.mean()),
            "theta_sd_ratio": float(torch.maximum(ratio, 1.0 / ratio).max()),
            "log_evidence_gap": abs(log_evidence - float(quad.log_z.sum())),
            "t_mean_gap": float((torch.abs(t.mean(0) - quad.t_mean) / quad.t_sd).max()),
            "coarse_max_weight": quad.coarse_max_weight,
            "theta_sd_min": float(quad.theta_sd.min()), "t_mean_max": float(quad.t_mean.max())}


def check(data, out: dict, cfg: dict, rows: torch.Tensor, dev) -> dict:
    """Every number compared, for the outputs ``out`` of one fit on ``data``.

    ``out`` holds, on the host: the anchors ``centers`` (s, d) and ``counts``
    (s,), the kNN lists ``idx`` and weights ``w`` (n, r), the spectrum's
    ``values`` (K,) and ``vectors`` at ``rows`` (the m training rows, then a
    sample of test rows), the final particles ``theta`` (P, J) of log t and
    the ``log_evidence`` the sampler estimated.  The anchors are judged by
    themselves and the spectrum against the reference's own from them, as
    ``lae_gpc.check`` judges them; the particles against the quadrature on
    the fit's own eigenpair."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, sigma = cfg["graph"], cfg["fit"]["sigma"]
    s, r, K = g["s"], g["r"], g["K"]
    X = torch.as_tensor(np.concatenate([data.x_train, data.x_test]), device=dev,
                        dtype=torch.float32).to(torch.float64)
    n, m = X.shape[0], data.x_train.shape[0]
    U = torch.as_tensor(out["centers"], device=dev).to(torch.float64)
    got = {}

    # subsample, graph and spectrum, as lae_gpc.check reads them
    assign = base.nearest(X, U, 1, F64)[0][:, 0]
    counts = base.counts_of(assign, s, torch.float64)
    got["count_gap"] = float(torch.abs(counts - torch.as_tensor(out["counts"], device=dev)
                                       .to(torch.float64)).sum()) / (2 * n)
    means = base.cluster_means(X, assign, s)
    rms = torch.sqrt(((X - U[assign]) ** 2).sum(1).mean())
    live = counts > 0
    got["anchor_gap"] = float(torch.sqrt(((U - means) ** 2).sum(1)[live].mean()) / rms)
    del means, assign
    idx_ref, _ = base.nearest(X, U, r, F64)
    idx_fit = torch.as_tensor(out["idx"], device=dev).long()
    same = (torch.sort(idx_ref, 1).values == torch.sort(idx_fit, 1).values).all(1)
    got["knn_rows_differ"] = float((~same).sum()) / n
    w_fit = torch.as_tensor(out["w"], device=dev).to(torch.float64)
    got["lae_gap"] = float(torch.abs(w_fit - base.lae(X, U, idx_fit, g["lae_iters"], F64)).max())
    del w_fit, idx_fit, same
    sp = base.spectrum(base.lae(X, U, idx_ref, g["lae_iters"], F64), idx_ref, counts, s, K, F64)
    del X
    vf = torch.as_tensor(out["values"], device=dev).to(torch.float64)
    got["eigenvalue_gap"] = float(torch.abs(vf - sp.values).max())
    sp = base.handed_over(sp, cfg)

    # the posterior on the fit's own eigenpair, against the particles
    Yc = base.class_columns(data.y_train, cfg["classes"], dev, torch.float64)
    Vf = torch.as_tensor(out["vectors"], device=dev).to(torch.float64)
    quad = posterior_of(vf, Vf[:m], Yc, cfg)
    theta = torch.as_tensor(out["theta"], device=dev).to(torch.float64)          # (P, J)
    got.update(sampler_readings(theta, float(out["log_evidence"]), quad))
    mean = theta.mean(0)

    # the same posterior on the reference's own spectrum (read: the float32
    # spectrum can move the ten-class objective), and the heat kernel at its
    # θ-means between the sampled rows and the training rows
    own = posterior_of(sp.values, base.vectors(sp, torch.arange(m, device=dev)), Yc, cfg)
    got["theta_gap_own_spectrum"] = float((torch.abs(mean - own.theta_mean)
                                           / own.theta_sd).max())
    Vr = base.vectors(sp, rows.to(dev))
    for j in range(Yc.shape[0]):
        tj = torch.exp(own.theta_mean[j])
        Hr = (Vr * base.heat_weights(sp.values, tj)) @ Vr[:m].T
        Hf = (Vf * base.heat_weights(vf, tj)) @ Vf[:m].T
        got["heat_kernel_gap"] = max(got.get("heat_kernel_gap", 0.0),
                                     float(torch.abs(Hf - Hr).max() / torch.abs(Hr).max()))
    return got


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, one precision down
# ---------------------------------------------------------------------------


def control_fit(data, cfg: dict, rows: torch.Tensor, seed: int, dev,
                p: base.Precision = CONTROL) -> dict:
    """A whole fit by the reference's arithmetic at precision p, in the layout
    ``check`` reads: anchors (Lloyd from uniform rows), graph, spectrum, and
    as many particles a class as the program holds, drawn from the
    reference's quadrature at p, with its evidence."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the TF32 rounding is written out
    g = cfg["graph"]
    s, r, K = g["s"], g["r"], g["K"]
    X = torch.as_tensor(np.concatenate([data.x_train, data.x_test]), device=dev,
                        dtype=torch.float32).to(p.graph)
    n, m = X.shape[0], data.x_train.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = X[torch.randperm(n, generator=gen, device=dev)[:s]]
    if p.tf32:
        U = base.tf32(U)
    assign = base.nearest(X, U, 1, p)[0][:, 0]
    for _ in range(g["kmeans_iters"]):
        cnt = base.counts_of(assign, s, p.graph)
        U = torch.where(cnt[:, None] > 0, base.cluster_means(X, assign, s), U)
        new = base.nearest(X, U, 1, p)[0][:, 0]
        moved = bool((new != assign).any())
        assign = new
        if not moved:
            break
    counts = base.counts_of(assign, s, p.graph)
    idx, _ = base.nearest(X, U, r, p)
    w = base.lae(X, U, idx, g["lae_iters"], p)
    sp = base.spectrum(w, idx, counts, s, K, p)
    Yc = base.class_columns(data.y_train, cfg["classes"], dev, p.tail)
    quad = posterior_of(sp.values.to(p.tail), base.vectors(sp, torch.arange(m, device=dev))
                        .to(p.tail), Yc, cfg)
    P = cfg["hyperposterior"]["n_particles"]
    pick = torch.multinomial(quad.weights, P, replacement=True, generator=gen)     # (J, P)
    theta = torch.gather(quad.thetas, 1, pick).T
    return dict(centers=U.cpu(), counts=counts.cpu(), idx=idx.cpu(), w=w.cpu(),
                values=sp.values.cpu(), vectors=base.vectors(sp, rows.to(dev)).cpu(),
                theta=theta.cpu(), log_evidence=float(quad.log_z.sum()))
