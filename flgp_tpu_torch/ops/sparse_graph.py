"""Symmetric kNN-graph operator for the sparse GLGP path.

The GLGP sparse path symmetrizes a kNN graph: Z_sym = (Z + Zᵀ)/2.  A
transpose breaks the fixed fan-in of the ELL layout, so the JAX package keeps
the symmetrized operator as a 2·n·r-edge COO list whose first n·r edges are
the graph and whose last n·r are its transpose, with the same values.  This
container has the same name and methods, and the same edge list as
``rows``/``cols``/``vals``, but stores the (n, r) ELL arrays the list was
built from.  The product is then two gathers: over the ELL rows (the forward
half) and over the rows of the transpose kept as CSR.  Most edges of a kNN
graph have their reverse in the graph too (i is a neighbour of j and j of
i): such a transposed entry names a row of x that the forward half of the
same output row gathers anyway, so its value is added to that forward
entry's weight and the CSR keeps only the entries whose reverse is missing
(``SymStructure``: two sorts of the indices, made once per graph and shared
by every bandwidth and rescaling, since only the values change).  For
float32 CUDA tensors both gathers run in one launch of the kernel
``ell_sym_matmat``; otherwise the plain composition gathers the forward half
and scatter-adds the transposed one (``index_add_``).  It is the same sum
as over the COO edges, in another order; duplicate edges act additively,
which is the +/2 semantics.  This is the operator LOBPCG drives for the
large-n eigensolve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import EPS
from ..types import EllMatrix, EllTranspose


class SymStructure(NamedTuple):
    """What the kernel product of Z + Zᵀ needs beside the (n, r) ELL arrays
    of Z, from the indices alone.  Entry p = i·r + k of Z is the edge
    i → indices[i, k]; it is *mutual* when its reverse edge is in Z as well.
    A mutual entry's transposed copy is folded into the forward weight of
    the reverse edge (its first copy, ``twin``); ``transpose`` holds the rest."""

    transpose: EllTranspose   # CSR of the transposed entries that are not mutual
    mutual: torch.Tensor      # (n·r,) bool
    twin: torch.Tensor        # (n·r,) int64 flat position of the reverse edge, 0 where not mutual


def sym_structure(indices: torch.Tensor, n: int) -> SymStructure:
    """The structure of Z + Zᵀ for the (n, r) indices of Z on n points: a
    stable sort of the edge keys row·n + col finds each edge's reverse (a
    self-loop is its own), a second sort builds the CSR of what is left."""
    r = indices.shape[1]
    col = indices.reshape(-1).long()
    row = torch.arange(n, device=indices.device).repeat_interleave(r)
    valid = (col >= 0) & (col < n)
    # invalid entries get a key below every real one, so no reverse key finds them
    keys, order = torch.sort(torch.where(valid, row * n + col, -1), stable=True)
    pos = torch.searchsorted(keys, col * n + row).clamp_(max=n * r - 1)
    mutual = valid & (keys[pos] == col * n + row)
    twin = torch.where(mutual, order[pos], 0)
    transpose = EllMatrix(indices, indices, n).transpose_structure(skip=mutual)
    return SymStructure(transpose, mutual, twin)


class SymCoo:
    """Z + Zᵀ for an (n, n) ELL graph Z with ``values`` at ``indices``."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, n: int,
                 structure: Optional[SymStructure] = None):
        self.indices = indices      # (n, r) int32
        self.values = values        # (n, r)
        self.n = int(n)
        self.structure = structure  # of ``indices``; built at first need when None
        self._kernel_values = None  # kernel_arrays' (structure, values, version, forward, CSR values)

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

    def kernel_arrays(self) -> Tuple[torch.Tensor, EllTranspose, torch.Tensor]:
        """(forward values (n, r), CSR structure, CSR values) as the kernel
        ``ell_sym_matmat`` takes them: every mutual entry's value is added to
        its reverse edge's forward weight, the others are permuted into the
        CSR's order.  The structure is made once per graph, the values once
        per operator: they are kept for as long as ``structure`` and
        ``values`` are the same objects with the same contents (a tensor
        counts its in-place writes), so assigning or overwriting either
        gives a fresh product.  Adding is exact in its order: a slot receives
        the values of the duplicates of one edge only, zeros otherwise."""
        if self.structure is None:
            self.structure = sym_structure(self.indices, self.n)
        st, values = self.structure, self.values
        kept = self._kernel_values
        if kept is None or kept[0] is not st or kept[1] is not values \
                or kept[2] != values._version:
            flat = values.reshape(-1)
            folded = torch.where(st.mutual, flat, torch.zeros_like(flat))
            forward = flat.clone().index_add_(0, st.twin, folded).reshape(values.shape)
            kept = self._kernel_values = (st, values, values._version, forward,
                                          flat[st.transpose.perm])
        return kept[3], st.transpose, kept[4]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x of shape (n,) or (n, k).  float32 tensors on a CUDA
        device go through the kernel ``ell_sym_matmat``; float64, and
        anything on the CPU, takes the plain composition."""
        X = x[:, None] if x.dim() == 1 else x
        if X.is_cuda and X.dtype == torch.float32 and self.values.dtype == torch.float32:
            from . import hopper_kernels

            forward, tr, vt = self.kernel_arrays()
            out = hopper_kernels.ell_sym_matmat(
                forward, self.indices.to(torch.int32).contiguous(), tr.ptr, tr.src, vt,
                X.contiguous())
        else:
            Z = self._ell
            out = Z.matmat_plain(X) + Z.rmatmat(X)
        return out[:, 0] if x.dim() == 1 else out

    def rowsum(self) -> torch.Tensor:
        Z = self._ell
        return Z.rowsum() + Z.colsum()

    def scale_sym(self, d: torch.Tensor) -> "SymCoo":
        """diag(d) · A · diag(d): both halves scale by d[i]·d[indices[i, k]],
        so one (n, r) value array serves both."""
        return SymCoo(self.indices, self.values * d[:, None] * d[self.indices.long()], self.n,
                      self.structure)


def symmetrize_knn(knn_idx: torch.Tensor, knn_vals: torch.Tensor, n: int,
                   structure: Optional[SymStructure] = None) -> SymCoo:
    """(Z + Zᵀ)/2 from ELL kNN values: each directed edge contributes v/2 in
    both orientations.  ``structure`` is ``sym_structure(knn_idx, n)`` where
    the caller already has it (one graph, many bandwidths)."""
    return SymCoo(knn_idx.to(torch.int32), knn_vals / 2.0, n, structure)


def glgp_operator(sym: SymCoo) -> Tuple[SymCoo, torch.Tensor]:
    """Double normalization of the GLGP graph: A = D⁻¹·Z_sym·D⁻¹, then
    W = D_A^{-1/2}·A·D_A^{-1/2}.

    Returns (W, sqrt_D_A_inv); the latter rescales the eigenvectors."""
    d_inv = 1.0 / (sym.rowsum() + EPS)
    A = sym.scale_sym(d_inv)
    sqrt_da_inv = 1.0 / torch.sqrt(A.rowsum() + EPS)
    return A.scale_sym(sqrt_da_inv), sqrt_da_inv
