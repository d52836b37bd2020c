"""Wrappers of the hand-written Hopper kernels K1–K9 and of the symmetric
operator product ``ell_sym_matmat``, with their plain versions.

K1 ``knn`` (csrc/knn.cu), K2 ``lae_weights`` (csrc/lae.cu), K3–K5
``ell_colsum``, ``ell_norm_gram``, ``ell_norm_matmat``, their chunked
feature-major variants K6–K8 ``ell_colsum_t``, ``ell_norm_gram_t``,
``ell_norm_matmat_t`` (csrc/ell_t.cu; K5 in csrc/ell.cu) and K9
``ell_matmat`` (csrc/ell_matmat.cu) replace the TPU kernels of the same
names in flgp_tpu/ops/pallas_kernels.py (K2: ``fused_lae_tiles``, with the
Gram assembly that feeds it).  K3 and K4 launch the bodies of K6 and K7 on
the point-major (n, r) layout, which is the chunked one with c = 1; their
sums are exact (fixed point in shared memory, float64 across blocks), so
C, Ĝ and D are the same bits on every launch.  ``ell_sym_matmat``
(csrc/ell_matmat.cu) is K9's gather applied to a graph and to its
transpose in one launch: the product (Z + Zᵀ)·X of the sparse GLGP
operator.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and only
then.  For CUDA tensors it checks device, dtype (float32 values, int32
indices), shape and contiguity, raises on anything else, launches the kernel
on the current stream and adds one to ``LAUNCHES[name]``.  A build or launch
error raises; nothing falls back.  The float64 path never reaches these
wrappers: the callers (``ops.knn``, ``ops.lae``, ``ops.spectrum``,
``EllMatrix.matmat``, ``SymCoo.matvec``) dispatch on dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import EPS
from ..types import EllMatrix
from . import _build
from .knn import KERNEL_MAX_R, KnnResult, knn_plain
from .lae import fista_momentum, lae_weights_plain

# Launches of each kernel since the last reset_launches().
LAUNCHES = {"knn": 0, "lae_weights": 0, "ell_colsum": 0, "ell_norm_gram": 0,
            "ell_norm_matmat": 0, "ell_colsum_t": 0, "ell_norm_gram_t": 0,
            "ell_norm_matmat_t": 0, "ell_matmat": 0, "ell_sym_matmat": 0}


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
    return _knn(X, U, r, split=0)


# K1's tiled body (csrc/knn_tiled.cu): a block owns 64 rows and walks the
# anchors in tiles of 128.  Where the row blocks cannot fill the card, blocks
# divide a row block's anchor tiles and a second kernel merges their lists.
_TILED_ROWS = 64
_TILED_ANCHORS = 128
_FILL_BLOCKS = 132            # a block on each of the H100's 132 SMs


def knn_anchor_split(n: int, s: int) -> int:
    """Blocks that divide each row block's anchor tiles in K1's tiled body
    (a power of two up to 32): the most that keep the grid within
    ``_FILL_BLOCKS`` blocks while each still scans a tile.  Beyond that the
    merge pass and the extra lists cost more than filling the card gains."""
    blocks = -(-n // _TILED_ROWS)
    tiles = -(-s // _TILED_ANCHORS)
    split = 1
    while split < 32 and 2 * split * blocks <= _FILL_BLOCKS and tiles >= 2 * split:
        split *= 2
    return split


def _knn(X: torch.Tensor, U: torch.Tensor, r: int, split: int,
         legacy: bool = False) -> KnnResult:
    """K1 on CUDA tensors.  d = 2 and 3 take their template bodies, where
    ``split`` lanes share a row and divide the anchors (a power of two up to
    32; 0 lets the kernel's entry point choose from (n, s)).  Every other d
    takes the tiled body, where ``split`` blocks divide a row block's anchors
    (0: ``knn_anchor_split``), or with ``legacy`` the old run-time-d body
    with the lanes' meaning of ``split``: the tiled body's bit oracle, for
    the tests and chip_smoke.py only.  The result depends on neither."""
    n, d = X.shape
    s = U.shape[0]
    _check_fan_in(r)
    if r > s:
        raise ValueError(f"knn needs r <= s, got r={r}, s={s}")
    _check("X", X, torch.float32, (n, d), X.device)
    _check("U", U, torch.float32, (s, d), X.device)
    tiled = d not in (2, 3) and not legacy
    if tiled and split == 0:
        split = knn_anchor_split(n, s)
    idx = torch.empty((n, r), dtype=torch.int32, device=X.device)
    dist = torch.empty((n, r), dtype=torch.float32, device=X.device)
    # the anchors as the kernel's pre-pass packs them: (−2u, |u|²) records,
    # d + 1 floats rounded up to a multiple of 4 at most
    packed = torch.empty((s, (max(d, 3) + 4) // 4 * 4), dtype=torch.float32, device=X.device)
    # the tiled body's lists of each block of a split: distances, then indices
    part = torch.empty((2 * split * n * r if tiled and split > 1 else 0,), dtype=torch.float32,
                       device=X.device)
    _launch("knn", X.device, _build.load().flgp_knn,
            X.data_ptr(), U.data_ptr(), n, s, d, r, int(split), int(legacy), packed.data_ptr(),
            part.data_ptr(), idx.data_ptr(), dist.data_ptr())
    return KnnResult(idx, dist)


# ---------------------------------------------------------------------------
# K2 LAE weights
# ---------------------------------------------------------------------------


_MOMENTUM = {}   # (iters, device) -> the FISTA momentum table on that device


def _momentum_table(iters: int, device: torch.device) -> torch.Tensor:
    key = (int(iters), device)
    if key not in _MOMENTUM:
        _MOMENTUM[key] = torch.as_tensor(fista_momentum(int(iters)), device=device)
    return _MOMENTUM[key]


def lae_weights(X: torch.Tensor, anchors: torch.Tensor, knn_idx: torch.Tensor,
                iters: int = 150) -> torch.Tensor:
    """FISTA simplex weights (K2), (n, r) row-major; see ``ops.lae.lae_weights``."""
    if X.device.type == "cpu":
        return lae_weights_plain(X, anchors, knn_idx, iters)
    return _lae_weights(X, anchors, knn_idx, iters, fused=False)


def _lae_weights(X: torch.Tensor, anchors: torch.Tensor, knn_idx: torch.Tensor, iters: int,
                 fused: bool) -> torch.Tensor:
    """K2 on CUDA tensors, point-major.  ``fused`` takes the kernel's
    fused-multiply-add variant, which is not the plain version bit for bit;
    no fit uses it, the smoke test and the card tests measure it."""
    n, d = X.shape
    r = knn_idx.shape[1]
    _check("X", X, torch.float32, (n, d), X.device)
    _check("knn_idx", knn_idx, torch.int32, (n, r), X.device)
    out = torch.empty((n, r), dtype=torch.float32, device=X.device)
    # the (n, r) layout is the chunked one with c = 1
    _launch_lae(X, d, 1, d, anchors, knn_idx, n, n, 1, r, iters, fused, out)
    return out


def lae_weights_t_plain(Xt: torch.Tensor, anchors: torch.Tensor, knn_idx_t: torch.Tensor,
                        iters: int = 150) -> torch.Tensor:
    """``lae_weights_plain`` on each chunk's point-major view, laid back into
    (nch, r, c); the pad points keep weight 0.  One chunk at a time, so the
    (c, r, r) Gram arrays stay one chunk's size."""
    n = Xt.shape[1]
    nch, r, c = knn_idx_t.shape
    w = torch.zeros((nch, r, c), dtype=Xt.dtype, device=Xt.device)
    for i in range(nch):
        lo, hi = i * c, min((i + 1) * c, n)
        if hi > lo:
            w[i, :, :hi - lo] = lae_weights_plain(Xt[:, lo:hi].T, anchors,
                                                  knn_idx_t[i, :, :hi - lo].T, iters).T
    return w


def lae_weights_t(Xt: torch.Tensor, anchors: torch.Tensor, knn_idx_t: torch.Tensor,
                  iters: int = 150) -> torch.Tensor:
    """FISTA simplex weights (K2) of a feature-major cloud Xt (d, n) on the
    chunked (nch, r, c) layout, nch·c ≥ n: one launch over all points, exact
    zeros on the pads; see ``ops.lae.lae_weights_t``."""
    if Xt.device.type == "cpu":
        return lae_weights_t_plain(Xt, anchors, knn_idx_t, iters)
    return _lae_weights_t(Xt, anchors, knn_idx_t, iters, fused=False)


def _lae_weights_t(Xt: torch.Tensor, anchors: torch.Tensor, knn_idx_t: torch.Tensor, iters: int,
                   fused: bool) -> torch.Tensor:
    """K2 on CUDA tensors, feature-major; ``fused`` as in ``_lae_weights``."""
    d, n = Xt.shape
    if knn_idx_t.dim() != 3:
        raise ValueError(f"knn_idx_t must be (nch, r, c), got shape {tuple(knn_idx_t.shape)}")
    nch, r, c = knn_idx_t.shape
    if not (nch - 1) * c < n <= nch * c:
        raise ValueError(f"{nch} chunks of {c} points do not hold n={n} points")
    _check("Xt", Xt, torch.float32, (d, n), Xt.device)
    _check("knn_idx_t", knn_idx_t, torch.int32, (nch, r, c), Xt.device)
    out = torch.empty((nch, r, c), dtype=torch.float32, device=Xt.device)
    _launch_lae(Xt, 1, n, d, anchors, knn_idx_t, n, nch * c, c, r, iters, fused, out)
    return out


def _launch_lae(X: torch.Tensor, xs_p: int, xs_k: int, d: int, anchors: torch.Tensor,
                idx: torch.Tensor, n: int, npts: int, c: int, r: int, iters: int, fused: bool,
                out: torch.Tensor) -> None:
    """Both K2 entries: coordinate k < d of point p is at X[p·xs_p + k·xs_k];
    idx and out are (npts/c, r, c), of which (n, r) is the case c = 1."""
    s = anchors.shape[0]
    _check_fan_in(r)
    _check("anchors", anchors, torch.float32, (s, d), X.device)
    if not 0 <= int(iters) <= 12288:
        raise ValueError(f"the CUDA kernel takes 0 <= iters <= 12288, got iters={iters}")
    _launch("lae_weights", X.device, _build.load().flgp_lae,
            X.data_ptr(), xs_p, xs_k, anchors.data_ptr(), idx.data_ptr(), n, npts, c, s, d, r,
            int(iters), _momentum_table(iters, X.device).data_ptr(), int(bool(fused)),
            out.data_ptr())


# ---------------------------------------------------------------------------
# K3–K5: the ELL graph tail
# ---------------------------------------------------------------------------


def ell_colsum_plain(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    return EllMatrix(values, indices, s).colsum()


_FIXED_SCALE = 2.0 ** 24         # the kernels' fixed-point unit is 2^-24
_FIXED_MAX = 128.0               # from this magnitude on a term is added as it is


def _colsum_fixed_plain(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """The column sums of K3 and K6 with their exact arithmetic, for the
    tests and the smoke test only: each float32 term with |v| < 128 rounded
    to a whole number of 2^-24 units (ties to even, as ``__float2int_rn``)
    and the units summed in int64, a larger term added as it is in float64,
    the total rounded to float32 once.  Any layout, any order of entries:
    the kernels' C equals this bit for bit while a column's sum of |terms|
    stays below 2^29."""
    v = values.reshape(-1).double()
    idx = indices.reshape(-1).long()
    keep = (idx >= 0) & (idx < s) & (v != 0.0)
    v, idx = v[keep], idx[keep]
    small = torch.abs(v) < _FIXED_MAX
    units = torch.where(small, torch.round(v * _FIXED_SCALE), 0.0).long()
    total = torch.zeros((s,), dtype=torch.int64, device=v.device).index_add_(0, idx, units)
    large = torch.zeros((s,), dtype=torch.float64, device=v.device).index_add_(
        0, idx, torch.where(small, 0.0, v))
    return (total.double() / _FIXED_SCALE + large).to(torch.float32)


def _colsum(name: str, values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """K3 and K6: one launch over the flat entries of either layout into a
    zeroed float64 (s,) buffer, returned before its rounding to float32."""
    out = torch.zeros((s,), dtype=torch.float64, device=values.device)
    _launch(name, values.device, _build.load().flgp_ell_colsum_t,
            values.data_ptr(), indices.data_ptr(), values.numel(), s, out.data_ptr())
    return out


def ell_colsum(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """Column sums C = 1ᵀZ of an (n, r) ELL graph (K3), shape (s,)."""
    if values.device.type == "cpu":
        return ell_colsum_plain(values, indices, s)
    return ell_colsum_partial(values, indices, s).to(torch.float32)


def ell_colsum_partial(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """K3's column sums in float64, before the one rounding to float32 that
    ``ell_colsum`` applies.  The kernel's sums are exact, so the partial sums
    of row blocks add in float64 to the whole graph's sums bit for bit: the
    multi-device layer all-reduces these.  On the CPU: the plain version's
    sums in float64."""
    if values.device.type == "cpu":
        return ell_colsum_plain(values, indices, s).double()
    n, r = values.shape
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    return _colsum("ell_colsum", values, indices, s)


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
    return _ell_norm_gram(values, indices, cscale, eps, table_slots=0)[:2]


def ell_norm_gram_partial(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                          eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's (Ĝ, D) in float64, before the one rounding to float32 that
    ``ell_norm_gram`` applies: exact sums, so the partials of row blocks add
    in float64 to the whole graph's bit for bit (the multi-device layer
    all-reduces these).  On the CPU: the plain version's in float64."""
    if values.device.type == "cpu":
        G, D = ell_norm_gram_plain(values, indices, cscale, eps)
        return G.double(), D.double()
    return _ell_norm_gram(values, indices, cscale, eps, table_slots=0, rounded=False)[:2]


def _ell_norm_gram(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                   eps: float, table_slots: int, rounded: bool = True) -> Tuple[torch.Tensor, ...]:
    """K4 on CUDA tensors: K7's body on the (n, r) layout; ``table_slots``
    and the counts returned beside Ĝ and D as in ``_ell_norm_gram_t``."""
    n, r = values.shape
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    return _gram("ell_norm_gram", values, indices, cscale, eps, table_slots, n, r, 1, rounded)


def _gram(name: str, values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
          eps: float, table_slots: int, nch: int, r: int, c: int,
          rounded: bool = True) -> Tuple[torch.Tensor, ...]:
    """K4 and K7: one launch into a zeroed float64 buffer that holds Ĝ, D
    and the two counts; Ĝ and D rounded to float32 once, in one cast (left
    in float64 without ``rounded``)."""
    s = cscale.shape[0]
    _check_fan_in(r)
    _check("cscale", cscale, torch.float32, (s,), values.device)
    buf = torch.zeros((s * s + s + 2,), dtype=torch.float64, device=values.device)
    stats = buf[s * s + s:].view(torch.int64)
    _launch(name, values.device, _build.load().flgp_ell_norm_gram_t,
            values.data_ptr(), indices.data_ptr(), cscale.data_ptr(), nch, r, c, s, float(eps),
            int(table_slots), buf.data_ptr(), buf[s * s:].data_ptr(), stats.data_ptr())
    out = buf[:s * s + s].to(torch.float32) if rounded else buf[:s * s + s]
    return out[:s * s].view(s, s), out[s * s:], stats


def ell_norm_matmat_plain(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                          W: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return _normalized(values, indices, cscale, eps).matmat_plain(W)


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
    _check_t(values, indices)
    return _colsum("ell_colsum_t", values, indices, s).to(torch.float32)


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
    return _ell_norm_gram_t(values, indices, cscale, eps, table_slots=0)[:2]


def _ell_norm_gram_t(values: torch.Tensor, indices: torch.Tensor, cscale: torch.Tensor,
                     eps: float, table_slots: int) -> Tuple[torch.Tensor, ...]:
    """K7 on CUDA tensors.  ``table_slots`` is the size of the kernel's
    shared-memory table of pair sums (a power of two in [2, 16384]; 0 lets the
    entry point choose).  The result does not depend on it, bit for bit: only
    the share of additions that stay in shared memory does; the tests force
    it.  Also returns the kernel's counts (pair additions kept in shared
    memory, sent straight to the global cells) as an int64 tensor on the
    device."""
    nch, r, c = _check_t(values, indices)
    return _gram("ell_norm_gram_t", values, indices, cscale, eps, table_slots, nch, r, c)


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


# ---------------------------------------------------------------------------
# K9: the raw ELL product, and the symmetric operator product built on it
# ---------------------------------------------------------------------------


def ell_matmat_plain(values: torch.Tensor, indices: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return EllMatrix(values, indices, W.shape[0]).matmat_plain(W)


def ell_matmat(values: torch.Tensor, indices: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z @ W for the raw (n, r) ELL graph Z and W (s, K) (K9), shape (n, K):
    out[i] = Σₖ values[i, k]·W[indices[i, k]].  Any r ≥ 1, s and K."""
    if values.device.type == "cpu":
        return ell_matmat_plain(values, indices, W)
    return _ell_matmat(values, indices, W, slab_cols=0)


def _ell_matmat(values: torch.Tensor, indices: torch.Tensor, W: torch.Tensor,
                slab_cols: int) -> torch.Tensor:
    """K9 on CUDA tensors.  ``slab_cols`` is the width of the column slabs
    the kernel walks K in; 0 lets its entry point choose from (s, K).  The
    result does not depend on it; the tests force it."""
    n, r = values.shape
    s, K = W.shape
    if r < 1:
        raise ValueError(f"ell_matmat needs r >= 1, got r={r}")
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    _check("W", W, torch.float32, (s, K), values.device)
    out = torch.empty((n, K), dtype=torch.float32, device=values.device)
    _launch("ell_matmat", values.device, _build.load().flgp_ell_matmat,
            values.data_ptr(), indices.data_ptr(), W.data_ptr(), n, r, s, K, int(slab_cols),
            out.data_ptr())
    return out


def ell_sym_matmat_plain(values: torch.Tensor, indices: torch.Tensor, ptr: torch.Tensor,
                         src: torch.Tensor, vt: torch.Tensor, X: torch.Tensor,
                         block: int = 1 << 16) -> torch.Tensor:
    """(Z + Zᵀ) @ X from the same arguments as the kernel: the forward half
    as a gather over the ELL arrays, the transposed half as a scatter-add of
    the CSR entries (entry e of row i adds vt[e]·X[src[e]] to out[i]), in
    blocks of entries so the weighted copy stays small."""
    n = values.shape[0]
    out = EllMatrix(values, indices, n).matmat_plain(X)
    nnz = int(ptr[-1])
    dst = torch.repeat_interleave(torch.arange(n, device=X.device), torch.diff(ptr.long()))
    for e in range(0, nnz, block):
        stop = min(e + block, nnz)        # src and vt may run on past the last row
        rows = vt[e:stop, None] * X[src[e:stop].long()]
        out.index_add_(0, dst[e:stop], rows)
    return out


def ell_sym_matmat(values: torch.Tensor, indices: torch.Tensor, ptr: torch.Tensor,
                   src: torch.Tensor, vt: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(Z + Zᵀ) @ X for the raw (n, r) ELL graph Z on n points and X (n, K):
    out[i] = Σₖ values[i, k]·X[indices[i, k]] + Σ_{e ∈ [ptr[i], ptr[i+1])} vt[e]·X[src[e]],
    with (ptr, src, vt) rows of Zᵀ as CSR (``EllMatrix.transpose_structure``
    and the values it permutes): all of them, or, as ``SymCoo`` calls it,
    those whose reverse edge Z lacks, the others folded into ``values``.
    One launch, no atomics."""
    if values.device.type == "cpu":
        return ell_sym_matmat_plain(values, indices, ptr, src, vt, X)
    return _ell_sym_matmat(values, indices, ptr, src, vt, X, slab_cols=0)


def _ell_sym_matmat(values: torch.Tensor, indices: torch.Tensor, ptr: torch.Tensor,
                    src: torch.Tensor, vt: torch.Tensor, X: torch.Tensor,
                    slab_cols: int) -> torch.Tensor:
    """The symmetric product on CUDA tensors; ``slab_cols`` as in ``_ell_matmat``."""
    n, r = values.shape
    K = X.shape[1]
    if r < 1:
        raise ValueError(f"ell_sym_matmat needs r >= 1, got r={r}")
    _check("values", values, torch.float32, (n, r), values.device)
    _check("indices", indices, torch.int32, (n, r), values.device)
    _check("ptr", ptr, torch.int32, (n + 1,), values.device)
    _check("src", src, torch.int32, (n * r,), values.device)
    _check("vt", vt, torch.float32, (n * r,), values.device)
    _check("X", X, torch.float32, (n, K), values.device)
    out = torch.empty((n, K), dtype=torch.float32, device=values.device)
    _launch("ell_sym_matmat", values.device, _build.load().flgp_ell_sym_matmat,
            values.data_ptr(), indices.data_ptr(), ptr.data_ptr(), src.data_ptr(), vt.data_ptr(),
            X.data_ptr(), n, r, K, int(slab_cols), out.data_ptr())
    return out
