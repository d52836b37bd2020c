"""Brute-force batched k-nearest-neighbors against the anchor set."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .distance import sqdist

# Largest fan-in the CUDA kernel is instantiated for (its top-r list lives
# in registers); wider requests take the plain version.
KERNEL_MAX_R = 16


class KnnResult(NamedTuple):
    indices: torch.Tensor    # (n, r) int32 — columns of the r nearest anchors
    sqdists: torch.Tensor    # (n, r) — squared distances


def knn(X: torch.Tensor, U: torch.Tensor, r: int, block: int = 8192) -> KnnResult:
    """r nearest anchors (by squared Euclidean distance) for each row of X,
    nearest first, ties to the lowest anchor index.

    float32 with r ≤ 16 goes through the hand-written kernel's wrapper (which
    itself runs the plain version for CPU tensors); float64 and wider r take
    the plain version on any device.
    """
    if X.dtype == torch.float32 and U.dtype == torch.float32 and r <= KERNEL_MAX_R:
        from . import hopper_kernels

        return hopper_kernels.knn(X, U, r)
    return knn_plain(X, U, r, block)


def knn_plain(X: torch.Tensor, U: torch.Tensor, r: int, block: int = 8192) -> KnnResult:
    """Blocked (n, s) distance matmul, then r rounds of masked row-argmin.

    ``torch.argmin`` returns the first minimal index, so ties go to the lowest
    anchor index (``torch.topk`` does not promise an order among ties).
    """
    n, s = X.shape[0], U.shape[0]
    if not 1 <= r <= s:
        raise ValueError(f"knn needs 1 <= r <= s, got r={r}, s={s}")
    indices = torch.empty((n, r), dtype=torch.int32, device=X.device)
    sqdists = torch.empty((n, r), dtype=X.dtype, device=X.device)
    for i in range(0, n, block):
        d = sqdist(X[i:i + block], U)
        for k in range(r):
            j = torch.argmin(d, dim=1, keepdim=True)
            indices[i:i + block, k] = j[:, 0].to(torch.int32)
            sqdists[i:i + block, k] = torch.gather(d, 1, j)[:, 0]
            d.scatter_(1, j, float("inf"))
    return KnnResult(indices, sqdists)
