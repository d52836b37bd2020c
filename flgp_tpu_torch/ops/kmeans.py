"""Anchor-point subsampling: k-means, random, and mini-batch k-means.

The returned cluster counts double as the "cluster sizes" the
cluster-normalized graph Laplacian consumes.  Every random draw comes from
the caller's ``torch.Generator``, which must live on the data's device.
Data-dependent loops (Lloyd's early exit) check their condition on the host
once per round (``utils.metrics.to_host``); each Lloyd round counts one
``lloyd_rounds``, and each of its assignment passes that runs on K1 one
``lloyd_kernel_rounds``.  k-means‖'s weighted k-means++ reduction of its
candidates counts one ``seedings`` and, where ``seed_on_kernel`` holds, runs
as one launch of ``hk.weighted_kmeanspp`` on noise drawn up front.

Every sum over a cluster's points adds in an order fixed by the data alone
(``_segment_sums``), so one seed gives one set of anchors, bit for bit, on
the CUDA device as on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import Subsample
from . import hopper_kernels as hk
from .distance import sqdist
from ..utils.metrics import count, to_host
from .knn import knn


class SubsampleResult(NamedTuple):
    centers: torch.Tensor   # (s, d)
    counts: torch.Tensor    # (s,) — points assigned to each center


def _gumbel(generator: torch.Generator, n: int, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1)."""
    u = torch.rand((n,), generator=generator, dtype=like.dtype, device=like.device)
    u = torch.clamp(u, min=torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


def _gumbel_rows(generator: torch.Generator, rows: int, n: int, like: torch.Tensor
                 ) -> torch.Tensor:
    """(rows, n) standard Gumbel draws, row k the bits of the k-th of ``rows``
    calls of ``_gumbel(generator, n, like)``: each row is drawn by its own call,
    in order (on the card that keeps each draw's Philox offset), and the
    transform, elementwise, runs once over all of them, in place."""
    u = torch.empty((rows, n), dtype=like.dtype, device=like.device)
    for row in u:
        row.uniform_(generator=generator)
    return u.clamp_(min=torch.finfo(like.dtype).tiny).log_().neg_().log_().neg_()


# The widest data at which K1 at r = 1 was measured to find the nearest
# center faster than the blocked distance matrix by 1.25x or more, one whole
# pass against the other on the H100, at each of 7e4 × 600, 10,240 × 1,024
# and 1e6 × 1,024 points × centers (PERF.md §6; at d = 128 and 10,240 × 1,024
# K1 leads by 1.13x only, at d = 256 the matrix path wins there): K1 keeps
# each distance in registers, the matrix path writes the (n, s) matrix and
# reads it back, which only wide data's float32 GEMM outweighs.
_KERNEL_ASSIGN_MAX_D = 64


def assign_on_kernel(device_type: str, dtype: torch.dtype, d: int) -> bool:
    """Whether Lloyd's assignment takes K1 at r = 1 for data of this device type,
    dtype and width: float32 on the card up to ``_KERNEL_ASSIGN_MAX_D``.  The
    CPU, float64 and wider data keep the blocked distance matrix."""
    return device_type == "cuda" and dtype == torch.float32 and d <= _KERNEL_ASSIGN_MAX_D


def _assign(X: torch.Tensor, centers: torch.Tensor, kernel: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest center (first on ties) and its squared distance: with
    ``kernel`` (the caller's ``assign_on_kernel``) K1 at r = 1 (int32
    indices), else the plain pass."""
    if kernel:
        nearest = hk.knn(X.contiguous(), centers.contiguous(), 1)
        return nearest.indices[:, 0], nearest.sqdists[:, 0]
    return _assign_plain(X, centers)


def _assign_plain(X: torch.Tensor, centers: torch.Tensor, block: int = 1 << 16
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
    """Points per cluster.  The summands are 1.0, which float32 adds exactly
    while a count stays below 2^24, so the order of the device's atomics
    cannot change the result."""
    ones = torch.ones(assign.shape, dtype=dtype, device=assign.device)
    return torch.zeros((s,), dtype=dtype, device=assign.device).index_add_(0, assign, ones)


def _segment_sums(values: torch.Tensor, assign: torch.Tensor, s: int) -> torch.Tensor:
    """Σ of the rows of ``values`` (n, d) in each of the s clusters, (s, d) in
    float64.  The rows are stably sorted by cluster and each cluster's sum
    runs over them one after the other, in row order: no atomics, so the
    result is the same bits on every run (``index_add_`` on a CUDA tensor
    adds in the order its atomics land).  On float64 input this is the sum
    ``index_add_`` gives on the CPU, bit for bit."""
    order = torch.sort(assign, stable=True).indices
    lengths = torch.bincount(assign, minlength=s)
    if assign.is_cuda:
        count("host_syncs", 2)     # bincount reads assign's max and min on the host
    return torch.segment_reduce(values[order].to(torch.float64), "sum", lengths=lengths,
                                axis=0, unsafe=True)


def _update(X: torch.Tensor, assign: torch.Tensor, s: int, old: torch.Tensor):
    counts = _counts(assign, s, X.dtype)
    sums = _segment_sums(X, assign, s).to(X.dtype)
    centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], old)
    return centers, counts


def lloyd(X: torch.Tensor, init: torch.Tensor, iters: int = 100
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations with early exit once assignments stabilize.

    Returns (centers, counts, total within-cluster SS).
    """
    s = init.shape[0]
    centers = init
    kernel = assign_on_kernel(X.device.type, X.dtype, X.shape[1])
    assign = torch.full((X.shape[0],), -1, dtype=torch.int64, device=X.device)
    for _ in range(iters):
        count("lloyd_rounds")
        new_assign, _ = _assign(X, centers, kernel)
        if kernel:
            count("lloyd_kernel_rounds")
        centers, _ = _update(X, new_assign, s, centers)
        changed = to_host(torch.any(new_assign != assign))
        assign = new_assign
        if not changed:
            break
    assign, mind = _assign(X, centers, kernel)
    if kernel:
        count("lloyd_kernel_rounds")
    return centers, _counts(assign, s, X.dtype), torch.sum(mind)


def _random_rows(generator: torch.Generator, X: torch.Tensor, s: int) -> torch.Tensor:
    """s distinct rows, uniformly without replacement."""
    idx = torch.randperm(X.shape[0], generator=generator, device=X.device)[:s]
    return X[idx]


def seed_on_kernel(device_type: str, dtype: torch.dtype, C: int) -> bool:
    """Whether k-means‖'s weighted k-means++ over C candidates of this device
    type and dtype takes the kernel (``hk.weighted_kmeanspp``): float32 on the
    card, up to the candidates one block's shared memory holds.  The CPU and
    float64 keep the plain loop."""
    return device_type == "cuda" and dtype == torch.float32 and C <= hk.KMEANSPP_MAX_C


def _weighted_kmeanspp_plain(dcc: torch.Tensor, w: torch.Tensor, noise: torch.Tensor
                             ) -> torch.Tensor:
    """Weighted k-means++ over C candidates by Gumbel-max: the first pick is
    argmax(w), each next the candidate with the largest log(w·d²) + noise[k],
    d² to the nearest pick so far (``dcc``, (C, C)).  One step a row of
    ``noise`` (steps, C); returns the steps + 1 picks, int64."""
    j = torch.argmax(w).reshape(1)
    mindc = dcc[j][0]
    picks = [j]
    for z in noise:
        logits = torch.log(torch.clamp(w * mindc, min=1e-30))
        j = torch.argmax(logits + z).reshape(1)
        mindc = torch.minimum(mindc, dcc[j][0])
        picks.append(j)
    return torch.cat(picks)


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

    # weighted k-means++ over the candidate set (C ≈ 2s): its noise drawn
    # first, then one launch on the card or the plain loop
    dcc = torch.clamp(sqdist(cands, cands), min=0.0)
    noise = _gumbel_rows(generator, s - 1, C, w)
    count("seedings")
    if seed_on_kernel(X.device.type, X.dtype, C):
        picks = hk.weighted_kmeanspp(dcc, w, noise)
    else:
        picks = _weighted_kmeanspp_plain(dcc, w, noise)
    del noise, dcc
    centers = cands[picks]

    # weighted Lloyd polish on the candidate set
    for _ in range(polish_iters):
        a = torch.argmin(sqdist(cands, centers), dim=1)
        sums = _segment_sums(torch.cat([w[:, None], w[:, None] * cands], dim=1), a, s).to(X.dtype)
        cw, csum = sums[:, 0], sums[:, 1:]
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
        wss = to_host(wss)
        if best is None or wss < best[2]:
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

    kernel = assign_on_kernel(X.device.type, X.dtype, X.shape[1])
    best = None
    for _ in range(nstart):
        centers = _random_rows(generator, X, s)
        ncounts = torch.zeros((s,), dtype=X.dtype, device=X.device)
        bidxs = torch.randint(0, n, (iters, batch_size), generator=generator, device=X.device)
        for bidx in bidxs:
            Xb = X[bidx]
            assign, _ = _assign(Xb, centers, kernel)
            bc = _counts(assign, s, X.dtype)
            bsum = _segment_sums(Xb, assign, s).to(X.dtype)
            ncounts = ncounts + bc
            lr = torch.where(ncounts > 0, bc / torch.clamp(ncounts, min=1.0), 0.0)
            bmean = bsum / torch.clamp(bc, min=1.0)[:, None]
            centers = centers + lr[:, None] * (bmean - centers)
        wss = to_host(torch.sum(_assign(X, centers, kernel)[1]))
        if best is None or wss < best[1]:
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
