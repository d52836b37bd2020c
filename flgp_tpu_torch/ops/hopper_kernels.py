"""Wrappers of the hand-written Hopper kernels K1–K8, with their plain versions.

K1 ``knn`` (csrc/knn.cu), K2 ``lae_weights`` (csrc/lae.cu), K3–K5
``ell_colsum``, ``ell_norm_gram``, ``ell_norm_matmat`` (csrc/ell.cu) and their
chunked feature-major variants K6–K8 ``ell_colsum_t``, ``ell_norm_gram_t``,
``ell_norm_matmat_t`` (csrc/ell_t.cu) replace the TPU kernels of the same
names in flgp_tpu/ops/pallas_kernels.py (K2: ``fused_lae_tiles``, with the
Gram assembly that feeds it).

Each wrapper takes its plain PyTorch version for tensors on the CPU, and only
then.  For CUDA tensors it checks device, dtype (float32 values, int32
indices), shape and contiguity, raises on anything else, launches the kernel
on the current stream and adds one to ``LAUNCHES[name]``.  A build or launch
error raises; nothing falls back.  The float64 path never reaches these
wrappers: the callers (``ops.knn``, ``ops.lae``, ``ops.spectrum``) dispatch
on dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import EPS
from ..types import EllMatrix
from . import _build
from .knn import KERNEL_MAX_R, KnnResult, knn_plain
from .lae import lae_weights_plain

# Launches of each kernel since the last reset_launches().
LAUNCHES = {"knn": 0, "lae_weights": 0, "ell_colsum": 0, "ell_norm_gram": 0,
            "ell_norm_matmat": 0, "ell_colsum_t": 0, "ell_norm_gram_t": 0,
            "ell_norm_matmat_t": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_fan_in(r: int) -> None:
    if not 1 <= r <= KERNEL_MAX_R:
        raise ValueError(f"the CUDA kernels take 1 <= r <= {KERNEL_MAX_R}, got r={r}")


def _launch(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K1 kNN
# ---------------------------------------------------------------------------


def knn(X: torch.Tensor, U: torch.Tensor, r: int) -> KnnResult:
    """r nearest anchors of each row of X (K1); see ``ops.knn.knn``."""
    if X.device.type == "cpu":
        return knn_plain(X, U, r)
    n, d = X.shape
    s = U.shape[0]
    _check_fan_in(r)
    if r > s:
        raise ValueError(f"knn needs r <= s, got r={r}, s={s}")
    _check("X", X, torch.float32, (n, d), X.device)
    _check("U", U, torch.float32, (s, d), X.device)
    idx = torch.empty((n, r), dtype=torch.int32, device=X.device)
    dist = torch.empty((n, r), dtype=torch.float32, device=X.device)
    _launch("knn", X.device, _build.load().flgp_knn,
            X.data_ptr(), U.data_ptr(), n, s, d, r, idx.data_ptr(), dist.data_ptr())
    return KnnResult(idx, dist)


# ---------------------------------------------------------------------------
# K2 LAE weights
# ---------------------------------------------------------------------------


def lae_weights(X: torch.Tensor, anchors: torch.Tensor, knn_idx: torch.Tensor,
                iters: int = 150) -> torch.Tensor:
    """FISTA simplex weights (K2), (n, r) row-major; see ``ops.lae.lae_weights``."""
    if X.device.type == "cpu":
        return lae_weights_plain(X, anchors, knn_idx, iters)
    n, d = X.shape
    s = anchors.shape[0]
    r = knn_idx.shape[1]
    _check_fan_in(r)
    _check("X", X, torch.float32, (n, d), X.device)
    _check("anchors", anchors, torch.float32, (s, d), X.device)
    _check("knn_idx", knn_idx, torch.int32, (n, r), X.device)
    out = torch.empty((n, r), dtype=torch.float32, device=X.device)
    _launch("lae_weights", X.device, _build.load().flgp_lae,
            X.data_ptr(), anchors.data_ptr(), knn_idx.data_ptr(), n, s, d, r, int(iters),
            out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3–K5: the ELL graph tail
# ---------------------------------------------------------------------------


def ell_colsum_plain(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    return EllMatrix(values, indices, s).colsum()


def ell_colsum(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """Column sums C = 1ᵀZ of an (n, r) ELL graph (K3), shape (s,)."""
    if values.device.type == "cpu":
        return ell_colsum_plain(values, indices, s)
    n, r = values.shape
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    out = torch.zeros((s,), dtype=torch.float32, device=values.device)
    _launch("ell_colsum", values.device, _build.load().flgp_ell_colsum,
            values.data_ptr(), indices.data_ptr(), n * r, s, out.data_ptr())
    return out


def _normalized(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                eps: float) -> EllMatrix:
    Z = EllMatrix(values, indices, cscale.shape[0]).scale_cols(cscale)
    return Z.scale_rows(1.0 / (Z.rowsum() + eps))


def ell_norm_gram_plain(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                        eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    Zn = _normalized(values, indices, cscale, eps)
    return Zn.gram(), Zn.colsum()


def ell_norm_gram(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                  eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ĝ = ZₙᵀZₙ (s, s), D = colsum(Zₙ) (s,)) for Zₙ = rownorm(Z·diag(cscale)) (K4)."""
    if values.device.type == "cpu":
        return ell_norm_gram_plain(values, indices, cscale, eps)
    n, r = values.shape
    s = cscale.shape[0]
    _check_fan_in(r)
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    _check("cscale", cscale, torch.float32, (s,), values.device)
    G = torch.zeros((s, s), dtype=torch.float32, device=values.device)
    D = torch.zeros((s,), dtype=torch.float32, device=values.device)
    _launch("ell_norm_gram", values.device, _build.load().flgp_ell_norm_gram,
            values.data_ptr(), indices.data_ptr(), cscale.data_ptr(), n, r, s, float(eps),
            G.data_ptr(), D.data_ptr())
    return G, D


def ell_norm_matmat_plain(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                          W: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return _normalized(values, indices, cscale, eps).matmat(W)


def ell_norm_matmat(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                    W: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """rownorm(Z·diag(cscale)) @ W (K5), shape (n, K)."""
    if values.device.type == "cpu":
        return ell_norm_matmat_plain(values, indices, cscale, W, eps)
    n, r = values.shape
    s, K = W.shape
    _check_fan_in(r)
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    _check("cscale", cscale, torch.float32, (s,), values.device)
    _check("W", W, torch.float32, (s, K), values.device)
    out = torch.empty((n, K), dtype=torch.float32, device=values.device)
    _launch("ell_norm_matmat", values.device, _build.load().flgp_ell_norm_matmat,
            values.data_ptr(), indices.data_ptr(), cscale.data_ptr(), W.data_ptr(), n, r, s, K,
            float(eps), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6–K8: the same tail on the chunked feature-major (nch, r, c) layout
# ---------------------------------------------------------------------------
# Entry (i, k, j) is the k-th neighbour of point i·c + j.  Pad points (past
# the real n) must carry zero weights: a zero row normalizes to 0·(1/eps) = 0
# and adds nothing to any sum.


def _check_t(values: torch.Tensor, indices: torch.Tensor) -> Tuple[int, int, int]:
    if values.dim() != 3:
        raise ValueError(f"values must be (nch, r, c), got shape {tuple(values.shape)}")
    nch, r, c = values.shape
    _check("values", values, torch.float32, (nch, r, c), values.device)
    _check("indices", indices, torch.int32, (nch, r, c), values.device)
    return nch, r, c


def _normalized_t(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    w1 = values * cscale[indices.long()]
    return w1 / (torch.sum(w1, dim=1, keepdim=True) + eps)


def ell_colsum_t_plain(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    return EllMatrix(values, indices, s).colsum()


def ell_colsum_t(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """Column sums C = 1ᵀZ of a chunked (nch, r, c) ELL graph (K6), shape (s,)."""
    if values.device.type == "cpu":
        return ell_colsum_t_plain(values, indices, s)
    nch, r, c = _check_t(values, indices)
    out = torch.zeros((s,), dtype=torch.float32, device=values.device)
    _launch("ell_colsum_t", values.device, _build.load().flgp_ell_colsum_t,
            values.data_ptr(), indices.data_ptr(), nch * r * c, s, out.data_ptr())
    return out


def ell_norm_gram_t_plain(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                          eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """D by scatter-add, Ĝ by a scatter-add of all r² pairs of each point."""
    s = cscale.shape[0]
    wn = _normalized_t(values, indices, cscale, eps)
    idx = indices.long()
    D = EllMatrix(wn, indices, s).colsum()
    pairs = (wn[:, :, None, :] * wn[:, None, :, :]).reshape(-1)
    flat = (idx[:, :, None, :] * s + idx[:, None, :, :]).reshape(-1)
    G = values.new_zeros((s * s,)).index_add_(0, flat, pairs).reshape(s, s)
    return G, D


def ell_norm_gram_t(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                    eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ĝ = ZₙᵀZₙ (s, s), D = colsum(Zₙ) (s,)) on the chunked layout (K7)."""
    if values.device.type == "cpu":
        return ell_norm_gram_t_plain(values, indices, cscale, eps)
    nch, r, c = _check_t(values, indices)
    s = cscale.shape[0]
    _check_fan_in(r)
    _check("cscale", cscale, torch.float32, (s,), values.device)
    # float64 accumulators, rounded to float32 once (see csrc/ell_t.cu)
    G = torch.zeros((s, s), dtype=torch.float64, device=values.device)
    D = torch.zeros((s,), dtype=torch.float64, device=values.device)
    _launch("ell_norm_gram_t", values.device, _build.load().flgp_ell_norm_gram_t,
            values.data_ptr(), indices.data_ptr(), cscale.data_ptr(), nch, r, c, s, float(eps),
            G.data_ptr(), D.data_ptr())
    return G.to(torch.float32), D.to(torch.float32)


def ell_norm_matmat_t_plain(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                            W: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Chunk by chunk, so the (r, c, K) gather of W stays one chunk's size."""
    nch, _, c = values.shape
    wn = _normalized_t(values, indices, cscale, eps)
    out = W.new_empty((nch * c, W.shape[1]))
    for i in range(nch):
        out[i * c:(i + 1) * c] = torch.einsum("rc,rck->ck", wn[i], W[indices[i].long()])
    return out


def ell_norm_matmat_t(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                      W: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """rownorm(Z·diag(cscale)) @ W on the chunked layout (K8), point-major
    (nch·c, K); the caller slices off the pad rows."""
    if values.device.type == "cpu":
        return ell_norm_matmat_t_plain(values, indices, cscale, W, eps)
    nch, r, c = _check_t(values, indices)
    s, K = W.shape
    _check_fan_in(r)
    _check("cscale", cscale, torch.float32, (s,), values.device)
    _check("W", W, torch.float32, (s, K), values.device)
    out = torch.empty((nch * c, K), dtype=torch.float32, device=values.device)
    _launch("ell_norm_matmat_t", values.device, _build.load().flgp_ell_norm_matmat_t,
            values.data_ptr(), indices.data_ptr(), cscale.data_ptr(), W.data_ptr(), nch, r, c, s,
            K, float(eps), out.data_ptr())
    return out
