"""Anchor-point subsampling: k-means, random, and mini-batch k-means.

The returned cluster counts double as the "cluster sizes" the
cluster-normalized graph Laplacian consumes.  Every random draw comes from
the caller's ``torch.Generator``, which must live on the data's device.
Data-dependent loops (Lloyd's early exit) check their condition on the host
once per round.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import Subsample
from .distance import sqdist
from .knn import knn


class SubsampleResult(NamedTuple):
    centers: torch.Tensor   # (s, d)
    counts: torch.Tensor    # (s,) — points assigned to each center


def _gumbel(generator: torch.Generator, n: int, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1)."""
    u = torch.rand((n,), generator=generator, dtype=like.dtype, device=like.device)
    u = torch.clamp(u, min=torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


def _assign(X: torch.Tensor, centers: torch.Tensor, block: int = 1 << 16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest center (first on ties) and its squared distance, by row blocks
    so the (n, s) distance matrix never exists whole."""
    n = X.shape[0]
    assign = torch.empty((n,), dtype=torch.int64, device=X.device)
    mind = torch.empty((n,), dtype=X.dtype, device=X.device)
    for i in range(0, n, block):
        m, a = torch.min(sqdist(X[i:i + block], centers), dim=1)
        assign[i:i + block] = a
        mind[i:i + block] = m
    return assign, mind


def _counts(assign: torch.Tensor, s: int, dtype: torch.dtype) -> torch.Tensor:
    ones = torch.ones(assign.shape, dtype=dtype, device=assign.device)
    return torch.zeros((s,), dtype=dtype, device=assign.device).index_add_(0, assign, ones)


def _update(X: torch.Tensor, assign: torch.Tensor, s: int, old: torch.Tensor):
    counts = _counts(assign, s, X.dtype)
    sums = torch.zeros((s, X.shape[1]), dtype=X.dtype, device=X.device).index_add_(0, assign, X)
    centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], old)
    return centers, counts


def lloyd(X: torch.Tensor, init: torch.Tensor, iters: int = 100
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations with early exit once assignments stabilize.

    Returns (centers, counts, total within-cluster SS).
    """
    s = init.shape[0]
    centers = init
    assign = torch.full((X.shape[0],), -1, dtype=torch.int64, device=X.device)
    for _ in range(iters):
        new_assign, _ = _assign(X, centers)
        centers, _ = _update(X, new_assign, s, centers)
        changed = bool(torch.any(new_assign != assign))
        assign = new_assign
        if not changed:
            break
    assign, mind = _assign(X, centers)
    return centers, _counts(assign, s, X.dtype), torch.sum(mind)


def _random_rows(generator: torch.Generator, X: torch.Tensor, s: int) -> torch.Tensor:
    """s distinct rows, uniformly without replacement."""
    idx = torch.randperm(X.shape[0], generator=generator, device=X.device)[:s]
    return X[idx]


def _kmeanspp_rows(generator: torch.Generator, X: torch.Tensor, s: int) -> torch.Tensor:
    """k-means++ seeding: each next center is a row drawn with probability ∝
    squared distance to the nearest chosen center (Gumbel-max sampling)."""
    n = X.shape[0]
    i0 = torch.randint(0, n, (1,), generator=generator, device=X.device)
    c = X[i0]                                              # (1, d)
    mind = torch.sum((X - c) ** 2, dim=1)
    rows = [c]
    for _ in range(s - 1):
        logits = torch.log(torch.clamp(mind, min=1e-30))
        idx = torch.argmax(logits + _gumbel(generator, n, logits)).reshape(1)
        c = X[idx]
        mind = torch.minimum(mind, torch.sum((X - c) ** 2, dim=1))
        rows.append(c)
    return torch.cat(rows, dim=0)


def _kmeanspar_rows(
    generator: torch.Generator, X: torch.Tensor, s: int, rounds: int = 4,
    oversample: float = 2.0, polish_iters: int = 5,
) -> torch.Tensor:
    """k-means‖ seeding (Bahmani et al. 2012) with fixed shapes.

    ``rounds`` passes each draw a block of B ≈ oversample·s/rounds candidates
    with probability ∝ d²(x, nearest chosen) — Gumbel-top-B is weighted
    sampling without replacement — then one 1-NN pass (kernel K1 with r = 1)
    updates the distances.  The ~2s candidates, weighted by their 1-NN mass,
    are reduced to s seeds by weighted k-means++ on the candidate set plus a
    few weighted Lloyd polish iterations.
    """
    n, d = X.shape
    B = max(-(-int(oversample * s) // rounds), 1)
    C = 1 + rounds * B
    i0 = torch.randint(0, n, (1,), generator=generator, device=X.device)
    c0 = X[i0]
    mind = torch.sum((X - c0) ** 2, dim=1)

    cands = [c0]
    for _ in range(rounds):
        logits = torch.log(torch.clamp(mind, min=1e-30))
        idx = torch.topk(logits + _gumbel(generator, n, logits), B).indices
        cr = X[idx].contiguous()
        mind = torch.minimum(mind, knn(X, cr, 1).sqdists[:, 0])
        cands.append(cr)
    cands = torch.cat(cands, dim=0)

    # weight candidates by their 1-NN mass over the full dataset
    assign = knn(X, cands, 1).indices[:, 0].long()
    w = _counts(assign, C, X.dtype)

    # weighted k-means++ over the candidate set (C ≈ 2s: each step is O(C·d))
    dcc = torch.clamp(sqdist(cands, cands), min=0.0)
    j = torch.argmax(w).reshape(1)
    mindc = dcc[j][0]
    rows = [cands[j]]
    for _ in range(s - 1):
        logits = torch.log(torch.clamp(w * mindc, min=1e-30))
        j = torch.argmax(logits + _gumbel(generator, C, logits)).reshape(1)
        mindc = torch.minimum(mindc, dcc[j][0])
        rows.append(cands[j])
    centers = torch.cat(rows, dim=0)

    # weighted Lloyd polish on the candidate set
    for _ in range(polish_iters):
        a = torch.argmin(sqdist(cands, centers), dim=1)
        cw = torch.zeros((s,), dtype=X.dtype, device=X.device).index_add_(0, a, w)
        csum = torch.zeros((s, d), dtype=X.dtype, device=X.device).index_add_(
            0, a, w[:, None] * cands)
        centers = torch.where(cw[:, None] > 0, csum / torch.clamp(cw, min=1.0)[:, None], centers)
    return centers


def kmeans(
    generator: torch.Generator, X: torch.Tensor, s: int, nstart: int = 1, iters: int = 100,
    init: str = "auto",
) -> SubsampleResult:
    """k-means with ``nstart`` restarts, best by within-cluster SS.

    ``init``: "auto" seeds with k-means‖ when the data is large enough for
    the serial k-means++ scan to hurt (n ≥ 4s and s ≥ 64) and k-means++
    otherwise; "kmeans||", "kmeans++", and "random" force a scheme."""
    n = X.shape[0]
    if init == "auto":
        init = "kmeans||" if (n >= 4 * s and s >= 64) else "kmeans++"
    seed_fn = {
        "kmeans||": _kmeanspar_rows,
        "kmeans++": _kmeanspp_rows,
        "random": _random_rows,
    }[init]
    best = None
    for _ in range(nstart):
        centers, counts, wss = lloyd(X, seed_fn(generator, X, s), iters)
        if best is None or float(wss) < float(best[2]):
            best = (centers, counts, wss)
    return SubsampleResult(best[0], best[1])


def minibatch_kmeans(
    generator: torch.Generator,
    X: torch.Tensor,
    s: int,
    batch_size: int | None = None,
    iters: int = 100,
    nstart: int = 1,
) -> SubsampleResult:
    """Sculley-style mini-batch k-means; final counts from a full 1-NN pass.

    All minibatch indices are drawn up front, with replacement within a batch
    (immaterial to Sculley's update)."""
    n = X.shape[0]
    if batch_size is None:
        batch_size = min(10 * s, n)
    batch_size = min(batch_size, n)

    best = None
    for _ in range(nstart):
        centers = _random_rows(generator, X, s)
        ncounts = torch.zeros((s,), dtype=X.dtype, device=X.device)
        bidxs = torch.randint(0, n, (iters, batch_size), generator=generator, device=X.device)
        for bidx in bidxs:
            Xb = X[bidx]
            assign, _ = _assign(Xb, centers)
            bc = _counts(assign, s, X.dtype)
            bsum = torch.zeros_like(centers).index_add_(0, assign, Xb)
            ncounts = ncounts + bc
            lr = torch.where(ncounts > 0, bc / torch.clamp(ncounts, min=1.0), 0.0)
            bmean = bsum / torch.clamp(bc, min=1.0)[:, None]
            centers = centers + lr[:, None] * (bmean - centers)
        wss = torch.sum(_assign(X, centers)[1])
        if best is None or float(wss) < float(best[1]):
            best = (centers, wss)
    centers = best[0].contiguous()
    labels = knn(X, centers, 1).indices[:, 0].long()
    return SubsampleResult(centers, _counts(labels, s, X.dtype))


def random_subsample(generator: torch.Generator, X: torch.Tensor, s: int) -> SubsampleResult:
    """Uniform row subsample; counts from a 1-NN pass so that
    cluster-normalized Laplacians remain usable."""
    centers = _random_rows(generator, X, s).contiguous()
    labels = knn(X, centers, 1).indices[:, 0].long()
    return SubsampleResult(centers, _counts(labels, s, X.dtype))


def subsample(
    generator: torch.Generator,
    X: torch.Tensor,
    s: int,
    method: Subsample = Subsample.KMEANS,
    nstart: int = 1,
    iters: int = 100,
) -> SubsampleResult:
    """Dispatch on the subsample method."""
    method = Subsample(method)
    if method == Subsample.KMEANS:
        return kmeans(generator, X, s, nstart=nstart, iters=iters)
    if method == Subsample.RANDOM:
        return random_subsample(generator, X, s)
    if method == Subsample.MINIBATCH_KMEANS:
        return minibatch_kmeans(generator, X, s, nstart=nstart, iters=iters)
    raise ValueError(f"unsupported subsample method: {method}")
