"""Core containers: ELL sparse matrices and eigen-pairs.

The cross-similarity matrix Z has exactly ``r`` nonzeros per row, stored as
dense ``(n, r)`` values plus ``(n, r)`` column indices (the fixed fan-in ELL
layout of ``flgp_tpu.types``).  Scatter-adds are ``index_add_``, so duplicate
column indices within a row add.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class EllTranspose(NamedTuple):
    """The structure of Zᵀ as CSR, for an (n, r) ELL matrix Z with s columns:
    row i of Zᵀ holds the entries of Z whose column index is i, in the order
    of their flat position j·r + k.  It depends on the indices alone, so one
    structure serves every value array on the same graph:
    ``values.reshape(-1)[perm]`` are the CSR values."""

    ptr: torch.Tensor     # (s + 1,) int32 row starts
    src: torch.Tensor     # (n·r,) int32 row j of Z of each entry; past ptr[s]: entries in no row
    perm: torch.Tensor    # (n·r,) int64 flat position of each entry in the (n, r) arrays


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

    def colsum_ordered(self) -> torch.Tensor:
        """1ᵀZ added in an order fixed by the graph, so the same bits on every
        run: on a CUDA tensor, where a scatter-add's atomics land in any
        order, the entries are stably sorted by column and each column is
        summed in float64 in row order, then rounded once; on the CPU the
        scatter-add, which already adds in row order."""
        if not self.values.is_cuda:
            return self.colsum()
        flat = self._flat_idx()
        order = torch.sort(flat, stable=True).indices
        lengths = torch.bincount(flat, minlength=self.num_cols)
        sums = torch.segment_reduce(self.values.reshape(-1)[order].to(torch.float64), "sum",
                                    lengths=lengths, unsafe=True)
        return sums.to(self.values.dtype)

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
        """Z @ W for dense W of shape (s, K).  float32 tensors on a CUDA
        device go through the hand-written kernel K9 (``ell_matmat``);
        float64, and anything on the CPU, takes :meth:`matmat_plain`."""
        if W.is_cuda and W.dtype == torch.float32 and self.values.dtype == torch.float32:
            from .ops import hopper_kernels

            return hopper_kernels.ell_matmat(
                self.values.contiguous(), self.indices.to(torch.int32).contiguous(),
                W.contiguous())
        return self.matmat_plain(W, block)

    def matmat_plain(self, W: torch.Tensor, block: int = 4096) -> torch.Tensor:
        """Z @ W as an (n, r, K) gather contracted over r, in row blocks so
        the gather buffer stays small."""
        n = self.shape[0]
        out = W.new_empty((n, W.shape[1]))
        for i in range(0, n, block):
            v = self.values[i:i + block]
            Wg = W[self.indices[i:i + block].long()]          # (b, r, K)
            out[i:i + block] = torch.einsum("nr,nrk->nk", v, Wg)
        return out

    def rmatmat(self, M: torch.Tensor, block: int = 4096) -> torch.Tensor:
        """Zᵀ @ M for dense M of shape (n, K): a scatter-add of weighted
        rows, in row blocks so the (block·r, K) buffer stays small.  The
        transposed half of the sparse GLGP operator's plain composition."""
        n, r = self.values.shape
        out = M.new_zeros((self.num_cols, M.shape[1]))
        for i in range(0, n, block):
            v = self.values[i:i + block]
            rows = (v[:, :, None] * M[i:i + block, None, :]).reshape(-1, M.shape[1])
            out.index_add_(0, self.indices[i:i + block].reshape(-1).long(), rows)
        return out

    def transpose_structure(self, skip: Optional[torch.Tensor] = None) -> EllTranspose:
        """CSR structure of Zᵀ: a stable sort of the flat column indices, the
        row starts from a count and a cumulative sum.  An index outside
        [0, s), and an entry that the (n·r,) bool mask ``skip`` names, sorts
        past the last row and belongs to none."""
        n, r = self.indices.shape
        s = self.num_cols
        if n * r >= 2 ** 31:
            raise ValueError(f"the int32 CSR structure needs n·r < 2^31, got {n}·{r}")
        flat = self._flat_idx()
        keep = (flat >= 0) & (flat < s)
        if skip is not None:
            keep = keep & ~skip
        key = torch.where(keep, flat, s)
        perm = torch.sort(key, stable=True).indices
        ptr = torch.zeros((s + 1,), dtype=torch.int32, device=flat.device)
        ptr[1:] = torch.cumsum(torch.bincount(key, minlength=s + 1)[:s], dim=0)
        return EllTranspose(ptr, (perm // r).to(torch.int32), perm)

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
