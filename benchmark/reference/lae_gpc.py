"""Plain reference of the LAE logit GP fits, binary and one-vs-rest multiclass.

Written from the method's definition in plain PyTorch, independent of
flgp_tpu_torch: it imports nothing of the port and takes nothing the port
derived.  Stages, each as the configuration states it:

- subsample (k-means): the nearest anchor of every point, the cluster counts
  and the cluster means, whose fixed point Lloyd's iteration seeks;
- graph: the r nearest anchors of every point, and the anchor-embedding
  weights, min ‖x − zᵀU‖² over the simplex by ``lae_iters`` FISTA steps of
  size 1/L (L the Gershgorin bound of U Uᵀ plus 1e-12), from z = 1/r;
- spectrum: the cluster-normalized graph Z (columns over their sums, times
  the cluster counts, then rows over their sums), A = Z·diag(colsum Z)^−½,
  the top K eigenpairs of AᵀA, σ = √eigenvalue, and the √n-scaled left
  singular vectors A·V/σ;
- train: per class, the diffusion time t minimizing the Laplace-approximate
  negative log marginal likelihood of the logit GP with covariance
  V·diag(exp(−t(1−σ)))·Vᵀ + sigma·I on the training rows, plus the prior
  p·log t + (t/τ)^−q, with the values σ rounded to the graph stage's dtype
  as the configuration hands them to the tail;
- predict: the Laplace posterior mean at the test rows, and labels from it
  (the sign for one class, the largest class mean for several).

The reference runs in float64 (``F64``).  ``CONTROL`` is the control, the
nearest precision below what the configuration states: the
graph stage's float32 products with their operands rounded to TF32 (10
mantissa bits, the rounding the card applies with TF32 on) and a float32
solve tail.  The rounding is written out, so the control computes the same on
any device.  ``control_fit`` puts the control in the program's place: it
draws its own anchors and runs every stage at that precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

EPS = 1e-9          # the guard on every division by a sum, as the method states it


class Precision(NamedTuple):
    graph: torch.dtype
    tail: torch.dtype
    tf32: bool


F64 = Precision(torch.float64, torch.float64, False)
CONTROL = Precision(torch.float32, torch.float32, True)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _op(x: torch.Tensor, p: Precision) -> torch.Tensor:
    """An operand of a graph-stage product at precision p."""
    x = x.to(p.graph)
    return tf32(x) if p.tf32 else x


def sqdist(X: torch.Tensor, U: torch.Tensor, p: Precision) -> torch.Tensor:
    """|x|² − 2x·u + |u|², every product at precision p."""
    Xo, Uo = _op(X, p), _op(U, p)
    return (Xo * Xo).sum(1, keepdim=True) - 2.0 * (Xo @ Uo.T) + (Uo * Uo).sum(1)[None, :]


def nearest(X: torch.Tensor, U: torch.Tensor, r: int, p: Precision, block: int = 1 << 15):
    """(indices (n, r), squared distances (n, r)) of the r nearest anchors."""
    n = X.shape[0]
    idx = torch.empty((n, r), dtype=torch.int64, device=X.device)
    d2 = torch.empty((n, r), dtype=p.graph, device=X.device)
    for i in range(0, n, block):
        d = sqdist(X[i:i + block], U, p)
        v, j = torch.topk(d, r, dim=1, largest=False, sorted=True)
        idx[i:i + block], d2[i:i + block] = j, v
    return idx, d2


def counts_of(assign: torch.Tensor, s: int, dtype) -> torch.Tensor:
    return torch.bincount(assign, minlength=s).to(dtype)


def cluster_means(X: torch.Tensor, assign: torch.Tensor, s: int) -> torch.Tensor:
    sums = torch.zeros((s, X.shape[1]), dtype=X.dtype, device=X.device).index_add_(0, assign, X)
    cnt = counts_of(assign, s, X.dtype)
    return sums / torch.clamp(cnt, min=1.0)[:, None]


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row onto the probability simplex."""
    r = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, r + 1, dtype=v.dtype, device=v.device)
    rho = torch.clamp(torch.sum(u - (css - 1.0) / k > 0, dim=-1), min=1)
    theta = (torch.gather(css, -1, (rho - 1)[:, None])[:, 0] - 1.0) / rho.to(v.dtype)
    return torch.clamp(v - theta[:, None], min=0.0)


def lae(X: torch.Tensor, U: torch.Tensor, idx: torch.Tensor, iters: int, p: Precision
        ) -> torch.Tensor:
    """Anchor-embedding weights (n, r) over the lists idx."""
    out = torch.empty(idx.shape, dtype=p.graph, device=X.device)
    r = idx.shape[1]
    block = max(1024, (1 << 26) // (r * X.shape[1]))
    for i in range(0, X.shape[0], block):
        Ui = _op(U, p)[idx[i:i + block]]                       # (b, r, d)
        x = _op(X[i:i + block], p)
        G = Ui @ Ui.mT                                          # (b, r, r)
        bvec = (Ui @ x[:, :, None])[:, :, 0]
        inv_L = 1.0 / (torch.abs(G).sum(2).amax(1) + 1e-12)
        z_prev = z = torch.full_like(bvec, 1.0 / r)
        d_prev, d_curr = 0.0, 1.0
        for _ in range(iters):
            v = z + ((d_prev - 1.0) / d_curr) * (z - z_prev)
            grad = (G @ v[:, :, None])[:, :, 0]
            z_prev, z = z, project_simplex(v - inv_L[:, None] * (grad - bvec))
            d_prev, d_curr = d_curr, (1.0 + math.sqrt(1.0 + 4.0 * d_curr * d_curr)) / 2.0
        out[i:i + block] = z
    return out


class Spectrum(NamedTuple):
    values: torch.Tensor      # (K,) σ, largest first
    A_vals: torch.Tensor      # (n, r) entries of A = Z·diag(colsum Z)^−½
    idx: torch.Tensor         # (n, r)
    V: torch.Tensor           # (s, K) right singular vectors


def spectrum(w: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor, s: int, K: int,
             p: Precision) -> Spectrum:
    """The top K of the cluster-normalized graph's spectrum (root: σ)."""
    w = w.to(p.graph)
    flat = idx.reshape(-1)
    col = torch.zeros((s,), dtype=w.dtype, device=w.device).index_add_(0, flat, w.reshape(-1))
    Z = w / (col + EPS)[idx] * counts.to(w.dtype)[idx]
    Z = Z / (Z.sum(1, keepdim=True) + EPS)
    D = torch.zeros((s,), dtype=w.dtype, device=w.device).index_add_(0, flat, Z.reshape(-1))
    A = Z / torch.sqrt(torch.abs(D) + EPS)[idx]
    Ao = _op(A, p)
    pairs = (idx[:, :, None] * s + idx[:, None, :]).reshape(-1)
    G = torch.zeros((s * s,), dtype=w.dtype, device=w.device).index_add_(
        0, pairs, (Ao[:, :, None] * Ao[:, None, :]).reshape(-1)).reshape(s, s)
    lam, V = torch.linalg.eigh(G)
    lam, V = torch.flip(lam, [0])[:K], torch.flip(V, [1])[:, :K]
    return Spectrum(torch.sqrt(torch.clamp(lam, min=0.0)), A, idx, V)


def vectors(sp: Spectrum, rows: Optional[torch.Tensor] = None, block: int = 1 << 16
            ) -> torch.Tensor:
    """The √n-scaled left singular vectors A·V/σ at ``rows`` (all rows if None)."""
    n = sp.idx.shape[0]
    scale = math.sqrt(n) / (sp.values + EPS)
    A, idx = (sp.A_vals, sp.idx) if rows is None else (sp.A_vals[rows], sp.idx[rows])
    out = torch.empty((A.shape[0], sp.V.shape[1]), dtype=sp.V.dtype, device=A.device)
    for i in range(0, A.shape[0], block):
        out[i:i + block] = torch.einsum("br,brk->bk", A[i:i + block], sp.V[idx[i:i + block]])
    return out * scale


# ---------------------------------------------------------------------------
# the solve tail
# ---------------------------------------------------------------------------


def handed_over(sp: Spectrum, cfg: dict) -> Spectrum:
    """The float64 spectrum with its values rounded to the graph stage's
    dtype, as the fit hands them to the solve tail."""
    dt = getattr(torch, cfg["fit"]["dtype"])
    return sp._replace(values=sp.values.to(dt).to(sp.values.dtype))


def heat_weights(values: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """exp(−t(1 − σ_k)), shape t.shape + (K,)."""
    return torch.exp(-t[..., None] * (1.0 - values))


def _newton(C: torch.Tensor, Y: torch.Tensor, max_iter: int = 200):
    """Mode of the Bernoulli-logit GP posterior (GPML Alg. 3.1) for every
    lane of C (..., m, m) and Y (..., m), to a step under 1e-10 (1e-4 in
    float32): (f, a = C⁻¹f, ½ log det B), ½ log det B = inf on a lane whose
    B = I + √W·C·√W its precision cannot factor."""
    tol = 1e-10 if C.dtype == torch.float64 else 1e-4
    f = torch.zeros_like(Y)
    eye = torch.eye(Y.shape[-1], dtype=C.dtype, device=C.device)
    failed = torch.zeros(Y.shape[:-1], dtype=torch.bool, device=C.device)
    for _ in range(max_iter):
        pi = torch.sigmoid(f)
        W = pi * (1.0 - pi)
        sW = torch.sqrt(W)
        L, info = torch.linalg.cholesky_ex(eye + sW[..., :, None] * C * sW[..., None, :])
        failed |= info != 0
        L = torch.where(failed[..., None, None], eye, L)
        b = W * f + (Y - pi)
        Cb = (C @ b[..., None])[..., 0]
        a = b - sW * torch.cholesky_solve((sW * Cb)[..., None], L)[..., 0]
        f_new = (C @ a[..., None])[..., 0]
        delta = torch.amax(torch.abs(f_new - f).masked_fill(failed[..., None], 0.0))
        f = f_new
        if float(delta) < tol:
            break
    logdet_half = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return f, a, logdet_half.masked_fill(failed, float("inf"))


def objective(values: torch.Tensor, Vm: torch.Tensor, Y: torch.Tensor, t: torch.Tensor,
              fit: dict) -> torch.Tensor:
    """Negative log posterior of t: −(Laplace log marginal) + p·log t +
    (t/τ)^−q, for lanes t (..., ) against labels Y (..., m)."""
    w = heat_weights(values, t)
    C = (Vm * w[..., None, :]) @ Vm.T
    C = C + fit["sigma"] * torch.eye(Vm.shape[0], dtype=C.dtype, device=C.device)
    f, a, logdet_half = _newton(C, Y)
    lml = -0.5 * (a * f).sum(-1) + (Y * torch.nn.functional.logsigmoid(f)
                                     + (1 - Y) * torch.nn.functional.logsigmoid(-f)).sum(-1)
    tr = fit["train"]
    return -(lml - logdet_half) + tr["prior_p"] * torch.log(t) + (t / tr["prior_tau"]) ** (
        -tr["prior_q"])


def train(values: torch.Tensor, Vm: torch.Tensor, Yc: torch.Tensor, fit: dict,
          grid: int = 97, rounds: int = 60) -> torch.Tensor:
    """t (J,) minimizing each class's objective: a log-spaced scan of
    [t_lb, t_top] then golden-section search in log t around the best cell."""
    tr = fit["train"]
    J = Yc.shape[0]
    lo, hi = math.log(tr["t_lb"]), math.log(tr["t_top"])
    u = torch.linspace(lo, hi, grid, dtype=values.dtype, device=values.device)
    F = torch.stack([objective(values, Vm, Yc[j].expand(grid, -1), torch.exp(u), fit)
                     for j in range(J)])                                  # (J, grid)
    F = torch.where(torch.isfinite(F), F, torch.full_like(F, float("inf")))
    i = torch.argmin(F, dim=1)
    a, b = u[torch.clamp(i - 1, min=0)], u[torch.clamp(i + 1, max=grid - 1)]
    g = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - g * (b - a), a + g * (b - a)

    def f(x):
        return objective(values, Vm, Yc, torch.exp(x), fit)

    fc, fd = f(c), f(d)
    for _ in range(rounds):
        left = fc < fd
        a, b = torch.where(left, a, c), torch.where(left, d, b)
        c_new, d_new = b - g * (b - a), a + g * (b - a)
        x_new = torch.where(left, c_new, d_new)
        f_new = f(x_new)
        c, d = torch.where(left, c_new, d), torch.where(left, c, d_new)
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
    return torch.exp((a + b) / 2.0)


def posterior_mean(values: torch.Tensor, Vm: torch.Tensor, Vtest: torch.Tensor, Yc: torch.Tensor,
                   t: torch.Tensor, sigma: float) -> torch.Tensor:
    """Laplace posterior mean (J, n_test) of each class at its t: C₂₁(y − π)
    at the mode, with C₂₁ = V_test·diag(w)·V_mᵀ applied as a product of
    factors."""
    w = heat_weights(values, t)                                           # (J, K)
    C = (Vm * w[:, None, :]) @ Vm.T + sigma * torch.eye(Vm.shape[0], dtype=Vm.dtype,
                                                         device=Vm.device)
    f, _, _ = _newton(C, Yc)
    coef = w * ((Yc - torch.sigmoid(f)) @ Vm)                             # (J, K)
    return coef @ Vtest.T


def labels_from_mean(mean: torch.Tensor) -> torch.Tensor:
    """One class: 1 where the mean is positive; several: the largest."""
    if mean.shape[0] == 1:
        return (mean[0] > 0).to(torch.float64)
    return torch.argmax(mean, dim=0).to(torch.float64)


def class_columns(y_train: np.ndarray, classes: int, dev, dtype) -> torch.Tensor:
    """(J, m) 0/1 labels: the labels themselves for one class, one-hot for several."""
    y = torch.as_tensor(y_train, device=dev)
    if classes == 1:
        return y.to(dtype)[None, :]
    return torch.nn.functional.one_hot(y.long(), classes).T.to(dtype)


# ---------------------------------------------------------------------------
# the check: the reference's readings of one fit's outputs
# ---------------------------------------------------------------------------


def check(data, out: dict, cfg: dict, rows: torch.Tensor, dev) -> dict:
    """Every number compared, for the outputs ``out`` of one fit on ``data``.

    ``out`` holds what the fit produced, moved to the host: ``centers`` (s,
    d), ``counts`` (s,), the kNN lists ``idx`` and weights ``w`` (n, r), the
    spectrum's ``values`` (K,) and ``vectors`` at ``rows`` (the m training
    rows, then a sample of test rows), ``t`` (J,), ``mean`` (n_test, J) and
    the labels ``y_test`` (n_test,).  The reference takes the fit's anchors,
    as it cannot replay the fit's random draw, and judges them by
    themselves; it takes the fit's t for the posterior mean, and judges that
    t by itself: by the reference's own objective there against at its own
    optimum."""
    g, fit = cfg["graph"], dict(cfg["fit"], train=cfg["train"])
    s, r, K = g["s"], g["r"], g["K"]
    # the points as the fit holds them (float32), in float64
    X = torch.as_tensor(np.concatenate([data.x_train, data.x_test]), device=dev,
                        dtype=torch.float32).to(torch.float64)
    n, m = X.shape[0], data.x_train.shape[0]
    U = torch.as_tensor(out["centers"], device=dev).to(torch.float64)
    got = {}

    # subsample: the fit's anchors against the points' own nearest anchors
    assign = nearest(X, U, 1, F64)[0][:, 0]
    counts = counts_of(assign, s, torch.float64)
    got["count_gap"] = float(torch.abs(counts - torch.as_tensor(out["counts"], device=dev)
                                       .to(torch.float64)).sum()) / (2 * n)
    # Lloyd's fixed point: each anchor the mean of the points nearest to it;
    # the root mean square over the anchors of that distance, against the
    # root-mean-square distance of a point to its anchor
    means = cluster_means(X, assign, s)
    rms = torch.sqrt(((X - U[assign]) ** 2).sum(1).mean())
    live = counts > 0
    got["anchor_gap"] = float(torch.sqrt(((U - means) ** 2).sum(1)[live].mean()) / rms)

    # graph: the fit's lists against the nearest anchors; its weights against
    # the weights over its own lists
    idx_ref, _ = nearest(X, U, r, F64)
    idx_fit = torch.as_tensor(out["idx"], device=dev).long()
    same = (torch.sort(idx_ref, 1).values == torch.sort(idx_fit, 1).values).all(1)
    got["knn_rows_differ"] = float((~same).sum()) / n
    w_fit = torch.as_tensor(out["w"], device=dev).to(torch.float64)
    got["lae_gap"] = float(torch.abs(w_fit - lae(X, U, idx_fit, g["lae_iters"], F64)).max())

    # spectrum, from the reference's own graph
    w_ref = lae(X, U, idx_ref, g["lae_iters"], F64)
    sp = spectrum(w_ref, idx_ref, counts, s, K, F64)
    del w_ref
    got["eigenvalue_gap"] = float(torch.abs(
        torch.as_tensor(out["values"], device=dev).to(torch.float64) - sp.values).max())

    # the values go on to the solve tail as the configuration hands them over:
    # in the graph stage's dtype.  Float32 rounds 1 − 5e-10, the top values of
    # disconnected components, to 1, and the objective's tail at large t rests
    # on that difference alone
    sp = handed_over(sp, cfg)

    # train: the reference's own optimum of t from its own spectrum
    J = cfg.get("classes", 1)
    Vm = vectors(sp, torch.arange(m, device=dev))
    Yc = class_columns(data.y_train, J, dev, torch.float64)
    t_ref = train(sp.values, Vm, Yc, fit)
    t_fit = torch.as_tensor(out["t"], device=dev).to(torch.float64)
    got["t_gap"] = float(torch.abs(torch.log(t_fit) - torch.log(t_ref)).max())
    got["t_fit_max"], got["t_ref_max"] = float(t_fit.max()), float(t_ref.max())
    # how far the fit's t is from optimal, in nats of the reference's own
    # objective: near 0 for any t where the objective is flat (the torus above
    # t ≈ 3e4), where t itself is not identified, and large for a wrong optimum
    got["objective_gap"] = float((objective(sp.values, Vm, Yc, t_fit, fit)
                                  - objective(sp.values, Vm, Yc, t_ref, fit)).max())

    # the heat kernel at the reference's t between the sampled rows and the
    # training rows: blind to the eigenvectors' signs and to rotations inside
    # an eigenvalue's space
    Vr = vectors(sp, rows)
    Vf = torch.as_tensor(out["vectors"], device=dev).to(torch.float64)
    vf = torch.as_tensor(out["values"], device=dev).to(torch.float64)
    for j in range(J):
        Hr = (Vr * heat_weights(sp.values, t_ref[j])) @ Vr[:m].T
        Hf = (Vf * heat_weights(vf, t_ref[j])) @ Vf[:m].T
        got["heat_kernel_gap"] = max(got.get("heat_kernel_gap", 0.0),
                                     float(torch.abs(Hf - Hr).max() / torch.abs(Hr).max()))

    # predict: the Laplace mean at the fit's t, and the labels
    Vtest = vectors(sp, torch.arange(m, n, device=dev))
    mean_ref = posterior_mean(sp.values, Vm, Vtest, Yc, t_fit, fit["sigma"])     # (J, n_test)
    mean_fit = torch.as_tensor(out["mean"], device=dev).to(torch.float64).reshape(
        mean_ref.shape[1], J).T
    got["mean_gap"] = float(torch.abs(mean_fit - mean_ref).max() / torch.abs(mean_ref).max())
    # the same per point as a probability, which stays bounded where the mean
    # is near 0
    got["prob_gap"] = float(torch.abs(torch.sigmoid(mean_fit) - torch.sigmoid(mean_ref)).max())
    y_fit = torch.as_tensor(out["y_test"], device=dev).to(torch.float64)
    got["label_disagree"] = float((y_fit != labels_from_mean(mean_ref)).float().mean())
    got["label_error"] = float((y_fit.cpu().numpy() != data.y_test).mean())
    return got


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, one precision down
# ---------------------------------------------------------------------------


def control_fit(data, cfg: dict, rows: torch.Tensor, seed: int, dev,
                p: Precision = CONTROL) -> dict:
    """A whole fit by the reference's arithmetic at precision p, in the
    layout ``check`` reads: anchors (Lloyd from uniform rows), graph, spectrum, t, posterior mean and labels."""
    g, fit = cfg["graph"], dict(cfg["fit"], train=cfg["train"])
    s, r, K = g["s"], g["r"], g["K"]
    X = torch.as_tensor(np.concatenate([data.x_train, data.x_test]), device=dev,
                        dtype=torch.float32).to(p.graph)
    n, m = X.shape[0], data.x_train.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = X[torch.randperm(n, generator=gen, device=dev)[:s]]
    if p.tf32:
        U = tf32(U)
    assign = nearest(X, U, 1, p)[0][:, 0]
    for _ in range(g["kmeans_iters"]):
        cnt = counts_of(assign, s, p.graph)
        U = torch.where(cnt[:, None] > 0, cluster_means(X, assign, s), U)
        new = nearest(X, U, 1, p)[0][:, 0]
        moved = bool((new != assign).any())
        assign = new
        if not moved:
            break
    counts = counts_of(assign, s, p.graph)
    idx, _ = nearest(X, U, r, p)
    w = lae(X, U, idx, g["lae_iters"], p)
    sp = spectrum(w, idx, counts, s, K, p)
    Yc = class_columns(data.y_train, cfg.get("classes", 1), dev, p.tail)
    J = Yc.shape[0]
    values = sp.values.to(p.tail)
    Vm = vectors(sp, torch.arange(m, device=dev)).to(p.tail)
    t = train(values, Vm, Yc, fit)
    Vtest = vectors(sp, torch.arange(m, n, device=dev)).to(p.tail)
    mean = posterior_mean(values, Vm, Vtest, Yc, t, fit["sigma"]).T       # (n_test, J)
    return dict(centers=U.cpu(), counts=counts.cpu(), idx=idx.cpu(), w=w.cpu(),
                values=sp.values.cpu(), vectors=vectors(sp, rows).cpu(), t=t.cpu(),
                mean=(mean[:, 0] if J == 1 else mean).cpu(),
                y_test=labels_from_mean(mean.T).cpu().numpy())
