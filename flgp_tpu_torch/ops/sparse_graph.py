"""Symmetric kNN-graph operator for the sparse GLGP path.

The GLGP sparse path symmetrizes a kNN graph: Z_sym = (Z + Zᵀ)/2.  A
transpose breaks the fixed fan-in of the ELL layout, so the JAX package keeps
the symmetrized operator as a 2·n·r-edge COO list whose first n·r edges are
the graph and whose last n·r are its transpose, with the same values.  This
container has the same name and methods, and the same edge list as
``rows``/``cols``/``vals``, but stores the (n, r) ELL arrays the list was
built from: the product is then the forward half, a gather (kernel K9
``ell_matmat`` for float32 CUDA tensors), plus the transposed half, a
scatter-add (``index_add_``).  It is the same sum as over the COO edges, in
another order; duplicate edges act additively, which is the +/2 semantics.
This is the operator LOBPCG drives for the large-n eigensolve.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import EPS
from ..types import EllMatrix


class SymCoo:
    """Z + Zᵀ for an (n, n) ELL graph Z with ``values`` at ``indices``."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, n: int):
        self.indices = indices      # (n, r) int32
        self.values = values        # (n, r)
        self.n = int(n)

    @property
    def _ell(self) -> EllMatrix:
        return EllMatrix(self.values, self.indices, self.n)

    @property
    def rows(self) -> torch.Tensor:
        """(2·n·r,) int32 edge rows: the graph's, then the transpose's."""
        n, r = self.indices.shape
        own = torch.arange(n, dtype=torch.int32, device=self.indices.device).repeat_interleave(r)
        return torch.cat([own, self.indices.reshape(-1).to(torch.int32)])

    @property
    def cols(self) -> torch.Tensor:
        half = self.rows.shape[0] // 2
        return torch.roll(self.rows, half)

    @property
    def vals(self) -> torch.Tensor:
        flat = self.values.reshape(-1)
        return torch.cat([flat, flat])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x of shape (n,) or (n, k)."""
        X = x[:, None] if x.dim() == 1 else x
        Z = self._ell
        out = Z.matmat(X) + Z.rmatmat(X)
        return out[:, 0] if x.dim() == 1 else out

    def rowsum(self) -> torch.Tensor:
        Z = self._ell
        return Z.rowsum() + Z.colsum()

    def scale_sym(self, d: torch.Tensor) -> "SymCoo":
        """diag(d) · A · diag(d): both halves scale by d[i]·d[indices[i, k]],
        so one (n, r) value array serves both."""
        return SymCoo(self.indices, self.values * d[:, None] * d[self.indices.long()], self.n)


def symmetrize_knn(knn_idx: torch.Tensor, knn_vals: torch.Tensor, n: int) -> SymCoo:
    """(Z + Zᵀ)/2 from ELL kNN values: each directed edge contributes v/2 in
    both orientations."""
    return SymCoo(knn_idx.to(torch.int32), knn_vals / 2.0, n)


def glgp_operator(sym: SymCoo) -> Tuple[SymCoo, torch.Tensor]:
    """Double normalization of the GLGP graph: A = D⁻¹·Z_sym·D⁻¹, then
    W = D_A^{-1/2}·A·D_A^{-1/2}.

    Returns (W, sqrt_D_A_inv); the latter rescales the eigenvectors."""
    d_inv = 1.0 / (sym.rowsum() + EPS)
    A = sym.scale_sym(d_inv)
    sqrt_da_inv = 1.0 / torch.sqrt(A.rowsum() + EPS)
    return A.scale_sym(sqrt_da_inv), sqrt_da_inv
