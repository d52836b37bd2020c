"""Out-of-core fits: X streams from disk, the graph and the spectrum stay on
the device.

Only X is large: the ELL graph (n·r values and indices) and the (n, K)
eigenvector store fit on the device when X does not fit in host memory.  So
the streamed pipeline reads the on-disk matrix (``native.MatrixFile``, the
FLGP0001 format) in row chunks, builds each chunk's kNN (K1) and LAE weights
(K2) on the device, and writes them into preallocated (n, r) buffers.  On a
CUDA device the host reads the next chunk into one of two pinned buffers
while the device works on the chunk before, and the host never holds more
than two chunks of X.  K1 and K2 are per row, so a chunk of any length
gives the rows' results of the whole array: the tail chunk is launched
short, as it is.  Everything downstream
(K3–K5 spectrum, training, prediction) is the in-memory path, so given the
same anchors the streamed spectrum is the in-memory one bit for bit on the
card.

Anchors for out-of-core data come from a reservoir sample of the rows,
k-means on the device, and a streamed 1-NN count pass (``streamed_subsample``).

A fit's layers are the recorder's spans (``utils.metrics``), one tree under
``fit``: ``reservoir`` (the sample's pass), ``subsample`` (its k-means and the
count pass), ``graph`` (the graph pass), ``spectrum``, ``train`` and
``predict``.  The counter ``stream_chunks`` counts each chunk handed to a
pass's consumer, ``stream_buffer_waits`` each wait of the host on a pinned
buffer's copy; such a wait is not a ``host_syncs``: it waits for one copy, and
the launch queue runs on behind it.

The predict tail is O(n·K): prediction anywhere is C[·, train]·adj with
C = ΦΦᵀ + σI and Φ the K-dim heat-kernel factor of the eigenvectors, so the
tail streams row blocks of the (n, K) eigenvector store and never forms an
(n, m) block (n = 1e7 and m = 1000 would need 80 GB in float64).  The
vectors may stay float32 on the device: each row block is cast to the solve
dtype on its own, so the store is never copied whole.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FitConfig, GraphConfig, KernelType, resolve_device
from ..inference.pg_gibbs import collapsed_adjoints, pg_gibbs_chain_trace
from ..models import gpr as gpr_mod
from ..models.gpc import _newton_mode
from ..native import MatrixFile, StreamLoader
from ..ops import linalg
from ..ops.heat_kernel import heat_kernel, heat_kernel_weights
from ..ops.kmeans import SubsampleResult, kmeans
from ..ops.knn import knn
from ..ops.lae import lae_weights
from ..ops.spectrum import spectrum_fused
from ..types import EigenPair, EllMatrix
from ..utils.metrics import count, fit_entry, span, to_device, to_host
from .drivers import _counts, _solve_cast, _start, _train_gpc, _train_gpr
from .multiclass import _train_mult, one_hot_labels

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                 np.dtype(np.int32): torch.int32}


def reservoir_sample(mat: MatrixFile, size: int, chunk_rows: int = 1 << 16,
                     seed: int = 0) -> np.ndarray:
    """Uniform sample of ``size`` rows in one streamed pass (Vitter's
    Algorithm R, vectorized per chunk): ``flgp_tpu.fit.streaming``'s numpy
    code line for line, so one file, seed and ``chunk_rows`` give its sample
    bit for bit."""
    if size > mat.shape[0]:
        raise ValueError("matrix smaller than the requested sample")
    rng = np.random.default_rng(seed)
    sample = np.empty((size, mat.shape[1]), mat.dtype)
    seen = 0
    for lo, chunk in StreamLoader(mat, chunk_rows):
        count("stream_chunks")
        if seen < size:  # fill the reservoir first
            take = min(size - seen, len(chunk))
            sample[seen : seen + take] = chunk[:take]
            seen += take
            chunk = chunk[take:]
        if len(chunk):
            idx = seen + np.arange(len(chunk))
            j = rng.integers(0, idx + 1)
            take = j < size
            sample[j[take]] = chunk[take]
            seen += len(chunk)
    return sample


def _stream_chunks(mat: MatrixFile, chunk_rows: int, device: torch.device,
                   consume: Callable[[int, torch.Tensor], None], overlap: bool = True) -> None:
    """``consume(lo, chunk)`` for the row chunks of ``mat`` in order, each
    chunk a tensor on ``device`` in the file's dtype, valid during the call.

    On a CUDA device with ``overlap`` the host reads chunk i+1 into one of
    two pinned buffers while the device still runs chunk i's work, launched
    without waiting.  Each buffer's copy to the device is queued on the
    current stream (``non_blocking``), so stream order puts it after the
    work on the chunk before and before the work on its own chunk, and the
    host waits on the event of a buffer's last copy before filling it again.
    The pass is paced by the host's work a chunk, not by the device, so a
    side stream for the copies, its events and ``madvise`` read-ahead only
    added host time.  Without ``overlap`` the pass alternates strictly: read,
    copy, work, synchronize.  On the CPU the chunks come from
    ``StreamLoader``."""
    n, d = mat.shape
    chunk_rows = min(chunk_rows, n)
    if device.type != "cuda":
        for lo, chunk in StreamLoader(mat, chunk_rows):
            count("stream_chunks")
            consume(lo, torch.from_numpy(chunk).to(device))
        return
    tdtype = _TORCH_DTYPES[np.dtype(mat.dtype)]
    host = [torch.empty((chunk_rows, d), dtype=tdtype, pin_memory=True)
            for _ in range(2 if overlap else 1)]
    dev = torch.empty((chunk_rows, d), dtype=tdtype, device=device)
    copied = [None] * len(host)
    for i, lo in enumerate(range(0, n, chunk_rows)):
        b = i % len(host)
        if copied[b] is not None:
            count("stream_buffer_waits")
            copied[b].synchronize()               # the copy that read host[b] is done
        rows = mat.read_into(lo, chunk_rows, host[b].data_ptr())
        dev[:rows].copy_(host[b][:rows], non_blocking=overlap)
        if overlap:
            copied[b] = torch.cuda.Event()
            copied[b].record()
        count("stream_chunks")
        consume(lo, dev[:rows])
        if not overlap:
            torch.cuda.synchronize(device)


def streamed_subsample(
    generator: torch.Generator,
    mat: MatrixFile,
    g: GraphConfig,
    sample_factor: int = 50,
    chunk_rows: int = 1 << 16,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> SubsampleResult:
    """Anchors for out-of-core X: ``ops.kmeans.kmeans`` on a uniform sample
    of ``sample_factor``·s rows (one streamed pass), then a streamed 1-NN
    count pass (K1 at r = 1 for float32 on the card) so cluster-normalized
    Laplacians see the true cluster sizes.  The counts accumulate on the
    device in int64, with no host read in the pass, and are cast to float64
    once at the end (exact at any n).  ``dtype``: the anchors' dtype, the file's by default.  ``device=None``
    means the CUDA device and raises without one."""
    device = resolve_device(device, "streamed_subsample")
    dtype = dtype or _TORCH_DTYPES[np.dtype(mat.dtype)]
    with span("reservoir"):
        sample = reservoir_sample(mat, min(sample_factor * g.s, mat.shape[0]), chunk_rows)
    with span("subsample"):
        sub = kmeans(generator, to_device(sample, dtype, device), g.s, nstart=g.nstart,
                     iters=g.kmeans_iters)
        centers = sub.centers.contiguous()
        counts = torch.zeros((g.s,), dtype=torch.int64, device=device)
        ones = torch.ones((min(chunk_rows, mat.shape[0]),), dtype=torch.int64, device=device)

        def count_pass(lo, chunk):
            # integer additions: exact in any order; ``torch.bincount`` would
            # read the labels' maximum to the host once a chunk
            lab = knn(chunk.to(dtype), centers, 1).indices[:, 0]
            counts.index_add_(0, lab.long(), ones[:lab.shape[0]])

        _stream_chunks(mat, chunk_rows, device, count_pass)
        return SubsampleResult(centers, counts.to(torch.float64))


def streamed_ell_graph(
    mat: MatrixFile,
    anchors: torch.Tensor,
    g: GraphConfig,
    chunk_rows: int = 1 << 16,
    _overlap: bool = True,
) -> EllMatrix:
    """One streamed pass X → the (n, r) ELL graph on the anchors' device:
    per chunk K1, then K2 (LAE) or the SE weights exp(−d²/(4ε²)), written
    into preallocated values and indices.  ``_overlap=False`` runs the pass
    without overlapping IO and compute (for measuring the overlap)."""
    n = mat.shape[0]
    anchors = anchors.contiguous()
    vals = torch.empty((n, g.r), dtype=anchors.dtype, device=anchors.device)
    idx = torch.empty((n, g.r), dtype=torch.int32, device=anchors.device)

    def build(lo, chunk):
        X = chunk.to(anchors.dtype)
        res = knn(X, anchors, g.r)
        if g.kernel == KernelType.LAE:
            w = lae_weights(X, anchors, res.indices)
        else:
            w = torch.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
        vals[lo:lo + X.shape[0]] = w
        idx[lo:lo + X.shape[0]] = res.indices

    _stream_chunks(mat, chunk_rows, anchors.device, build, _overlap)
    return EllMatrix(vals, idx, anchors.shape[0])


def streamed_build_spectrum(
    generator: torch.Generator,
    mat: MatrixFile,
    g: GraphConfig,
    chunk_rows: int = 1 << 16,
    anchors: Optional[SubsampleResult] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[EigenPair, SubsampleResult]:
    """Out-of-core ``fit.spectral.build_spectrum``: X on disk, the spectrum on
    the device, through ``spectrum_fused`` (K3–K5 in float32).  Given the
    same anchors it is the in-memory spectrum bit for bit on the card.
    ``anchors`` must live on ``device`` (``None``: the CUDA device);
    ``dtype`` is the subsampler's, as in :func:`streamed_subsample`."""
    device = resolve_device(device, "streamed_build_spectrum")
    if anchors is not None and anchors.centers.device.type != device.type:
        raise ValueError(f"anchors are on {anchors.centers.device}, the spectrum on {device}")
    sub = anchors if anchors is not None else streamed_subsample(
        generator, mat, g, chunk_rows=chunk_rows, device=device, dtype=dtype)
    with span("graph"):
        Z = streamed_ell_graph(mat, sub.centers, g, chunk_rows)
    with span("spectrum"):
        return spectrum_fused(Z.values, Z.indices, g.s, g.resolved_K(), g.gl, g.root,
                              sub.counts), sub


class StreamedGpcResult(NamedTuple):
    """GPC outputs with every per-row tensor covering all n rows of the file
    (train and test alike, the transductive layout), on the fit's device."""

    labels: torch.Tensor      # (n,) PG-Gibbs threshold (binary) or argmax (multiclass) labels
    probs: torch.Tensor       # (n,) binary, or (J, n) multiclass, PG probabilities
    post_mean: torch.Tensor   # (n,) or (n, J) Laplace posterior mean
    post_var: torch.Tensor    # (n,) or (n, J) Laplace posterior variance
    pars: dict


def _phi_train(eig: EigenPair, t, K: int, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened train-row features Φ_m = V_m·diag(exp(−t·λ/2)), the K-dim
    factor of the heat kernel, and the weights exp(−t·λ/2)."""
    w = torch.sqrt(heat_kernel_weights(eig, t, K))
    return eig.vectors[idx, :K] * w[None, :], w


def _pg_adjoints(generator: torch.Generator, Cvv, Y, N, n_gibbs: int, max_count: int,
                 avg_sweeps: int) -> torch.Tensor:
    """PG-Gibbs dual weights (S, m): the chain runs on the (m, m) train
    kernel as in ``test_pgbinary``, and each of the last S ω states gives
    adj = κ − √ω B⁻¹√ω (C κ), batched over the states."""
    _, _, om_trace = pg_gibbs_chain_trace(generator, Cvv, Y, n_gibbs, N, max_count)
    omegas = om_trace[-1:] if avg_sweeps <= 0 else om_trace[-min(avg_sweeps, n_gibbs):]
    return collapsed_adjoints(Cvv, Y, omegas, N)


def _chunked_rows(fn: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]], V: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, ...]:
    """``fn`` over row slices of V (views: V is neither padded nor copied),
    each result written into its slice of a preallocated (n, ...) output.
    Extra memory is what ``fn`` makes for one block."""
    n = V.shape[0]
    outs = None
    for lo in range(0, n, chunk):
        res = fn(V[lo:lo + chunk])
        if outs is None:
            outs = tuple(x.new_empty((n,) + tuple(x.shape[1:])) for x in res)
        for o, x in zip(outs, res):
            o[lo:lo + x.shape[0]] = x
    return outs


def _gpc_lowrank_tail(
    generator: torch.Generator,
    eig: EigenPair,
    Y: torch.Tensor,
    N: torch.Tensor,
    train_idx: torch.Tensor,
    K: int,
    cfg: FitConfig,
    t,
    max_count: int,
    chunk: int = 1 << 16,
):
    """Binary-GPC predict tail in O(n·K) memory: PG-Gibbs labels,
    Rao-Blackwellized probabilities and Laplace posterior moments at every
    row of the eigenpair.

    The (m, m) train kernel is the dense tail's (same Gibbs chain for the
    same generator state); everything n-sized streams through row blocks of
    ``eig.vectors``.  Returns (labels, probs, mean, var), each (n,) in
    ``cfg.dtype``."""
    dtype = cfg.dtype
    train_idx = torch.as_tensor(train_idx, device=eig.vectors.device).long()
    m = train_idx.shape[0]
    # the eigenvalues and the m train rows in the solve dtype
    eig_m = EigenPair(eig.values.to(dtype), eig.vectors[train_idx, :K].to(dtype))
    rows = torch.arange(m, device=train_idx.device)
    Cvv = linalg.add_diag(heat_kernel(eig_m, t, K, rows, rows), cfg.sigma)
    Phi_m, w_half = _phi_train(eig_m, t, K, rows)

    # PG-Gibbs prediction: projected duals (S, K)
    adjs = _pg_adjoints(generator, Cvv, Y, N, cfg.n_gibbs, max_count, cfg.gibbs_avg_sweeps)
    P = linalg.pdot(adjs, Phi_m)

    # Laplace posterior moments (GPML Alg 3.2) in K dimensions
    st = _newton_mode(Cvv, Y, torch.ones_like(Y), cfg.train.newton_tol,
                      cfg.train.newton_max_iter)
    pi_m = torch.sigmoid(st.f)
    sqrt_W = torch.sqrt(pi_m * (1.0 - pi_m))
    B = linalg.add_diag(sqrt_W[:, None] * Cvv * sqrt_W[None, :], 1.0)
    Binv = linalg.chol_solve(linalg.cholesky(B), torch.eye(m, dtype=dtype, device=Cvv.device))
    beta = sqrt_W[:, None] * Binv * sqrt_W[None, :]
    M = linalg.pdot(Phi_m.T, linalg.pdot(beta, Phi_m))          # (K, K)
    resid = linalg.pdot(Phi_m.T, (Y - pi_m)[:, None])[:, 0]      # (K,)

    def per_block(Vc):
        Phi_c = Vc[:, :K].to(dtype) * w_half[None, :]
        pi = torch.mean(torch.sigmoid(linalg.pdot(Phi_c, P.T)), dim=1)
        mean = linalg.pdot(Phi_c, resid[:, None])[:, 0]
        var = (torch.sum(Phi_c * Phi_c, dim=1) + cfg.sigma
               - torch.sum(linalg.pdot(Phi_c, M) * Phi_c, dim=1))
        return pi, mean, var

    pi_all, mean_all, var_all = _chunked_rows(per_block, eig.vectors, chunk)
    # train rows carry the σ-ridge cross term: their prediction row is Cvv,
    # which includes σ
    mu_train = linalg.pdot(Phi_m, P.T) + cfg.sigma * adjs.T      # (m, S)
    pi_all[train_idx] = torch.mean(torch.sigmoid(mu_train), dim=1)
    labels = (pi_all > 0.5).to(dtype)
    return labels, pi_all, mean_all, var_all


# ---------------------------------------------------------------------------
# Out-of-core drivers
# ---------------------------------------------------------------------------
# Each trains through ``_solve_cast`` as the in-memory drivers do, on the m
# train rows of the eigenvector store only (an (m, K) copy in the solve
# dtype), so ``FitConfig.solve_dtype`` is honoured; with ``solve_dtype=None``
# the tail runs on the spectrum's dtype, as the JAX package's streamed
# drivers run it.


def _streamed_spectrum(generator, mat: MatrixFile, cfg: FitConfig, chunk_rows: int, device,
                       train_idx):
    device = _start(generator, device)
    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    eig, _ = streamed_build_spectrum(generator, mat, g, chunk_rows, device=device,
                                     dtype=cfg.dtype)
    n = mat.shape[0]
    idx = to_device(np.asarray(train_idx), torch.int64, device)
    return device, eig, n, min(g.resolved_K(), g.s, n), idx


def _train_rows(eig: EigenPair, idx) -> EigenPair:
    return EigenPair(eig.values, eig.vectors[idx])


@fit_entry
def fit_lae_logit_gp_streamed(
    generator: torch.Generator,
    mat: MatrixFile,
    Y_train,
    train_idx,
    N=None,
    cfg: FitConfig = FitConfig(),
    chunk_rows: int = 1 << 16,
    device=None,
) -> StreamedGpcResult:
    """Out-of-core binary GPC: X streams from ``mat``, whose rows are all the
    points (train and test); ``train_idx`` marks the m labelled rows and
    ``Y_train`` (m,) their labels, ``N`` optional binomial counts.  The
    trained t is the in-memory driver's on the same spectrum (the same
    ``_train_gpc``); prediction and the Laplace moments run in O(n·K) memory.
    ``generator`` drives every draw and must live on ``device`` (``None``:
    the CUDA device)."""
    device, eig, n, K, idx = _streamed_spectrum(generator, mat, cfg, chunk_rows, device,
                                                train_idx)
    m = idx.shape[0]
    Y = to_device(np.asarray(Y_train), cfg.dtype, device)
    N_arr, max_count = _counts(N, m, cfg.dtype, device)
    scfg, eig_m, (Ys, Ns) = _solve_cast(cfg, _train_rows(eig, idx), Y, N_arr)
    with span("train"):
        res = _train_gpc(eig_m, Ys, Ns, slice(0, m), K, scfg)
    with span("predict"):
        labels, probs, mean, var = _gpc_lowrank_tail(generator, eig, Ys, Ns, idx, K, scfg,
                                                     res.x, max_count, chunk_rows)
    return StreamedGpcResult(labels, probs, mean, var, dict(t=res.x, obj=res.obj))


@fit_entry
def fit_lae_logit_mult_gp_streamed(
    generator: torch.Generator,
    mat: MatrixFile,
    Y_train,
    train_idx,
    cfg: FitConfig = FitConfig(),
    chunk_rows: int = 1 << 16,
    device=None,
) -> StreamedGpcResult:
    """Out-of-core multinomial (one-vs-rest) GPC: the J binary t-optimizations
    of ``multiclass._train_mult`` on the shared streamed spectrum, one
    low-rank PG tail per class, each with its own generator seeded from
    ``generator``, and the argmax labels.  ``Y_train`` holds the integer
    labels 0..J−1; probs (J, n), post_mean and post_var (n, J), t (J,)."""
    device, eig, n, K, idx = _streamed_spectrum(generator, mat, cfg, chunk_rows, device,
                                                train_idx)
    m = idx.shape[0]
    Y = to_device(np.asarray(Y_train), cfg.dtype, device)
    aug_y = one_hot_labels(Y, int(to_host(torch.max(Y))) + 1)
    scfg, eig_m, (aug_s,) = _solve_cast(cfg, _train_rows(eig, idx), aug_y)
    with span("train"):
        res = _train_mult(eig_m, aug_s, m, K, scfg)
    with span("predict"):
        N_arr = torch.ones((m,), dtype=scfg.dtype, device=device)
        seeds = to_host(torch.randint(0, 2 ** 62, (aug_s.shape[1],), generator=generator,
                                      device=device)).tolist()
        tails = [_gpc_lowrank_tail(torch.Generator(device=device).manual_seed(seed), eig,
                                   aug_s[:, j], N_arr, idx, K, scfg, res.x[j], 1, chunk_rows)
                 for j, seed in enumerate(seeds)]
    probs = torch.stack([tail[1] for tail in tails])
    mean = torch.stack([tail[2] for tail in tails], dim=1)
    var = torch.stack([tail[3] for tail in tails], dim=1)
    labels = torch.argmax(probs, dim=0).to(scfg.dtype)
    return StreamedGpcResult(labels, probs, mean, var, dict(t=res.x, obj=res.obj))


@fit_entry
def fit_lae_regression_gp_streamed(
    generator: torch.Generator,
    mat: MatrixFile,
    Y_train,
    train_idx,
    cfg: FitConfig = FitConfig(sigma=1e-5),
    chunk_rows: int = 1 << 16,
    device=None,
):
    """Transductive GPR where the design matrix never fits in host memory:
    the rows of ``mat`` are all points, ``train_idx`` marks the observed
    ones.  Returns (posterior mean at every row (n,), dict(t, noise, obj)).
    The prediction runs over row blocks of the eigenvector store, each with
    the m train rows, cast to the solve dtype block by block."""
    device, eig, n, K, idx = _streamed_spectrum(generator, mat, cfg, chunk_rows, device,
                                                train_idx)
    m = idx.shape[0]
    Y = to_device(np.asarray(Y_train), cfg.dtype, device)
    scfg, eig_m, (Ys,) = _solve_cast(cfg, _train_rows(eig, idx), Y)
    with span("train"):
        res = _train_gpr(eig_m, Ys, slice(0, m), K, scfg)
    train, rows = slice(0, m), slice(m, None)

    def predict(Vc):
        block = EigenPair(eig_m.values, torch.cat([eig_m.vectors, Vc.to(scfg.dtype)]))
        return (gpr_mod.gpr_predict(block, Ys, train, rows, K, res.t, res.noise, scfg.sigma),)

    with span("predict"):
        (pred,) = _chunked_rows(predict, eig.vectors, chunk_rows)
    return pred, dict(t=res.t, noise=res.noise, obj=res.obj)
