"""Core containers: ELL sparse matrices and eigen-pairs.

The cross-similarity matrix Z has exactly ``r`` nonzeros per row, stored as
dense ``(n, r)`` values plus ``(n, r)`` column indices (the fixed fan-in ELL
layout of ``flgp_tpu.types``).  Scatter-adds are ``index_add_``, so duplicate
column indices within a row add.
"""

from __future__ import annotations

from typing import Tuple

import torch


class EllMatrix:
    """Row-sparse (n, s) matrix with fixed fan-in r.

    ``values[i, k]`` is the entry at ``(i, indices[i, k])``.  Duplicate column
    indices within a row are allowed (they act additively in every op).
    """

    def __init__(self, values: torch.Tensor, indices: torch.Tensor, num_cols: int):
        self.values = values
        self.indices = indices
        self.num_cols = int(num_cols)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.num_cols)

    @property
    def fan_in(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def _flat_idx(self) -> torch.Tensor:
        return self.indices.reshape(-1).long()

    def rowsum(self) -> torch.Tensor:
        return torch.sum(self.values, dim=1)

    def colsum(self) -> torch.Tensor:
        """1ᵀZ by scatter-add."""
        out = self.values.new_zeros((self.num_cols,))
        return out.index_add_(0, self._flat_idx(), self.values.reshape(-1))

    def scale_rows(self, scale: torch.Tensor) -> "EllMatrix":
        return EllMatrix(self.values * scale[:, None], self.indices, self.num_cols)

    def scale_cols(self, scale: torch.Tensor) -> "EllMatrix":
        return EllMatrix(self.values * scale[self.indices.long()], self.indices, self.num_cols)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Z @ v for v of shape (s,)."""
        return torch.sum(self.values * v[self.indices.long()], dim=1)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        """Zᵀ @ u for u of shape (n,)."""
        out = self.values.new_zeros((self.num_cols,))
        return out.index_add_(0, self._flat_idx(), (self.values * u[:, None]).reshape(-1))

    def to_dense(self) -> torch.Tensor:
        n, s = self.shape
        out = self.values.new_zeros((n, s))
        rows = torch.arange(n, device=self.values.device)[:, None].expand_as(self.indices)
        return out.index_put_((rows, self.indices.long()), self.values, accumulate=True)

    def matmat(self, W: torch.Tensor, block: int = 4096) -> torch.Tensor:
        """Z @ W for dense W of shape (s, K): an (n, r, K) gather contracted
        over r, in row blocks so the gather buffer stays small."""
        n = self.shape[0]
        out = W.new_empty((n, W.shape[1]))
        for i in range(0, n, block):
            v = self.values[i:i + block]
            Wg = W[self.indices[i:i + block].long()]          # (b, r, K)
            out[i:i + block] = torch.einsum("nr,nrk->nk", v, Wg)
        return out

    def gram(self, block: int = 2048) -> torch.Tensor:
        """ZᵀZ as a dense (s, s) matrix: row blocks densified into (block, s)
        tiles, accumulating blockᵀ @ block."""
        n, s = self.shape
        acc = self.values.new_zeros((s, s))
        for i in range(0, n, block):
            dense = EllMatrix(self.values[i:i + block], self.indices[i:i + block], s).to_dense()
            acc += dense.T @ dense
        return acc


class EigenPair:
    """Spectral pair of the two-step similarity matrix W.

    ``values`` are eigenvalues of W (σ² of A, or σ when ``root``); ``vectors``
    are the √n-rescaled eigenvectors, one row per data point.
    """

    def __init__(self, values: torch.Tensor, vectors: torch.Tensor):
        self.values = values
        self.vectors = vectors

    @property
    def K(self) -> int:
        return self.values.shape[-1]

    def laplacian_eigenvalues(self, K: int) -> torch.Tensor:
        """Graph-Laplacian eigenvalues 1 - λ(W)."""
        return 1.0 - self.values[..., :K]
