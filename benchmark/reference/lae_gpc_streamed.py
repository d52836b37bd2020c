"""Plain reference of the out-of-core binary LAE logit GP fit: X in an
FLGP0001 file, anchors by k-means on a reservoir sample, the O(n·K) tail.

Written from the method's definition in plain PyTorch and numpy, independent
of flgp_tpu_torch: it imports nothing of the port, reads the file itself (a
32-byte header of magic, dtype code, rows and columns, then the rows) and
takes from ``lae_gpc.py`` the stages the in-memory fit shares (nearest
anchors, LAE weights, the spectrum, the objective of t and its search).
Stages, each as the configuration states it:

- reservoir: a uniform sample of ``sample_factor``·s rows by Algorithm R in
  one pass over the file, the chunks of ``chunk_rows`` rows in order, a chunk's
  replacement slots drawn at once from ``numpy.random.default_rng(sample_seed)``
  (slot j uniform in [0, i] for the i-th row, replaced where j < size, later
  rows over earlier ones);
- subsample: Lloyd's fixed point on that sample (each anchor the mean of the
  sample points nearest to it), and the count of every row of the file by its
  nearest anchor;
- graph, spectrum, train: ``lae_gpc.py``'s, over all n rows of the file;
- predict: the Laplace posterior at the fit's t (GPML Alg. 3.1–3.2) with the
  covariance V·diag(w)·Vᵀ + sigma·I, w = exp(−t(1 − σ)): the mean and the
  variance of the latent value at the checked test rows from the fit's own
  eigenpair, and the mean at every test row from the reference's spectrum,
  row block by row block, so nothing (n, m) is formed.

The reference runs in float64 (``F64``) with TF32 off; ``CONTROL`` is one
precision down, as in ``lae_gpc.py``, and ``control_fit`` puts it in the
program's place.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch


def _base():
    spec = importlib.util.spec_from_file_location("bench_reference_lae_gpc",
                                                  Path(__file__).with_name("lae_gpc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _base()
F64, CONTROL = base.F64, base.CONTROL
MAGIC = b"FLGP0001"
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32}
BLOCK = 1 << 20     # test rows a block of the predictive mean


def read_rows(path: str) -> np.ndarray:
    """The file's rows, memory-mapped (n, d), in its own dtype."""
    with open(path, "rb") as f:
        head = f.read(32)
    if head[:8] != MAGIC:
        raise ValueError(f"{path} is not an FLGP0001 file")
    code = int(np.frombuffer(head, np.int32, 1, 8)[0])
    rows, cols = (int(v) for v in np.frombuffer(head, np.int64, 2, 16))
    return np.memmap(path, dtype=_DTYPES[code], mode="r", offset=32, shape=(rows, cols))


def reservoir(X: np.ndarray, size: int, chunk_rows: int, seed: int) -> np.ndarray:
    """Algorithm R over the rows of X in chunks of ``chunk_rows``."""
    rng = np.random.default_rng(seed)
    out = np.empty((size, X.shape[1]), X.dtype)
    seen = 0
    for lo in range(0, X.shape[0], chunk_rows):
        chunk = np.asarray(X[lo:lo + chunk_rows])
        fill = min(max(size - seen, 0), len(chunk))
        out[seen:seen + fill] = chunk[:fill]
        seen += fill
        rest = chunk[fill:]
        if len(rest):
            slot = rng.integers(0, seen + np.arange(len(rest)) + 1)
            keep = slot < size
            out[slot[keep]] = rest[keep]
            seen += len(rest)
    return out


def _vector_blocks(sp, lo: int, hi: int):
    """(first row, vectors) of the rows lo..hi in blocks of ``BLOCK``."""
    for a in range(lo, hi, BLOCK):
        rows = torch.arange(a, min(a + BLOCK, hi), device=sp.idx.device)
        yield a - lo, base.vectors(sp, rows)


class Laplace:
    """The Laplace posterior of the binary logit GP at t on the m training
    rows: the weights w, the mean's coefficients w·Vmᵀ(y − π), and the
    Cholesky factor L of B = I + √W·C·√W at the mode."""

    def __init__(self, values, Vm, y, t, sigma: float):
        self.w = base.heat_weights(values, t)                             # (K,)
        self.Vm, self.sigma = Vm, sigma
        C = (Vm * self.w) @ Vm.T + sigma * torch.eye(Vm.shape[0], dtype=Vm.dtype,
                                                     device=Vm.device)
        f, _, _ = base._newton(C, y)
        pi = torch.sigmoid(f)
        self.sW = torch.sqrt(pi * (1.0 - pi))
        self.L = torch.linalg.cholesky(
            torch.eye(Vm.shape[0], dtype=C.dtype, device=C.device)
            + self.sW[:, None] * C * self.sW[None, :])
        self.coef = self.w * ((y - pi) @ Vm)                              # (K,)

    def mean(self, Vx):
        return Vx @ self.coef

    def var(self, Vx):
        """k(x, x) − k(x, m)·√W·B⁻¹·√W·k(m, x) at the rows of Vx, none of
        them a training row."""
        kxx = (Vx * Vx * self.w).sum(1) + self.sigma
        kmx = (self.Vm * self.w) @ Vx.T                                   # (m, b)
        v = torch.linalg.solve_triangular(self.L, self.sW[:, None] * kmx, upper=False)
        return kxx - (v * v).sum(0)


def check(data, out: dict, cfg: dict, rows: torch.Tensor, dev) -> dict:
    """Every number compared, for the outputs ``out`` of one fit on ``data``
    (``path``: the FLGP0001 file of all n rows, the m training rows first;
    ``y_train``, ``y_test``).

    ``out`` holds, on the host: the reservoir ``sample`` the fit drew, its
    ``centers`` (s, d) and ``counts`` (s,), the graph's ``idx`` and weights
    ``w`` (n, r), the spectrum's ``values`` (K,) and ``vectors`` at ``rows``
    (the m training rows, then a sample of test rows), ``t`` (1,), the
    posterior ``mean`` (n_test,) and labels ``y_test`` (n_test,) at every test
    row, and the posterior ``var`` at the sampled test rows ``rows[m:]``.  As
    ``lae_gpc.check``, the reference takes the fit's anchors and t and judges
    each by itself; the sample it draws again from the file."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, fit, st = cfg["graph"], dict(cfg["fit"], train=cfg["train"]), cfg["stream"]
    s, r, K = g["s"], g["r"], g["K"]
    Xf = read_rows(data.path)
    X = torch.from_numpy(np.array(Xf)).to(dev).to(torch.float64)
    n, m = X.shape[0], len(data.y_train)
    U = torch.as_tensor(out["centers"], device=dev).to(torch.float64)
    got = {}

    # reservoir: the reference's own draw from the file against the fit's sample
    sample = reservoir(Xf, min(st["sample_factor"] * s, n), st["chunk_rows"], st["sample_seed"])
    fit_sample = np.asarray(out["sample"])
    got["sample_differs"] = float(fit_sample.shape != sample.shape
                                  or not np.array_equal(fit_sample, sample))

    # subsample: every row's nearest anchor counted; Lloyd's fixed point on the
    # sample, as lae_gpc.check judges it on the points k-means ran on
    assign = base.nearest(X, U, 1, F64)[0][:, 0]
    counts = base.counts_of(assign, s, torch.float64)
    got["count_gap"] = float(torch.abs(counts - torch.as_tensor(out["counts"], device=dev)
                                       .to(torch.float64)).sum()) / (2 * n)
    S = torch.from_numpy(sample).to(dev).to(torch.float64)
    own = base.nearest(S, U, 1, F64)[0][:, 0]
    means = base.cluster_means(S, own, s)
    rms = torch.sqrt(((S - U[own]) ** 2).sum(1).mean())
    live = base.counts_of(own, s, torch.float64) > 0
    got["anchor_gap"] = float(torch.sqrt(((U - means) ** 2).sum(1)[live].mean()) / rms)
    del S, own, means, assign

    # graph
    idx_ref, _ = base.nearest(X, U, r, F64)
    idx_fit = torch.as_tensor(out["idx"], device=dev).long()
    same = (torch.sort(idx_ref, 1).values == torch.sort(idx_fit, 1).values).all(1)
    got["knn_rows_differ"] = float((~same).sum()) / n
    w_fit = torch.as_tensor(out["w"], device=dev).to(torch.float64)
    got["lae_gap"] = float(torch.abs(w_fit - base.lae(X, U, idx_fit, g["lae_iters"], F64)).max())
    del w_fit, idx_fit, same

    # spectrum, from the reference's own graph, handed to the tail in the
    # graph stage's dtype (lae_gpc.check says why)
    w_ref = base.lae(X, U, idx_ref, g["lae_iters"], F64)
    sp = base.spectrum(w_ref, idx_ref, counts, s, K, F64)
    del w_ref, X
    got["eigenvalue_gap"] = float(torch.abs(
        torch.as_tensor(out["values"], device=dev).to(torch.float64) - sp.values).max())
    sp = base.handed_over(sp, cfg)

    # train: the reference's own optimum of t
    Vm = base.vectors(sp, torch.arange(m, device=dev))
    Yc = base.class_columns(data.y_train, 1, dev, torch.float64)
    t_ref = base.train(sp.values, Vm, Yc, fit)
    t_fit = torch.as_tensor(out["t"], device=dev).to(torch.float64).reshape(1)
    got["t_gap"] = float(torch.abs(torch.log(t_fit) - torch.log(t_ref)).max())
    got["t_fit_max"], got["t_ref_max"] = float(t_fit.max()), float(t_ref.max())
    got["objective_gap"] = float((base.objective(sp.values, Vm, Yc, t_fit, fit)
                                  - base.objective(sp.values, Vm, Yc, t_ref, fit)).max())

    # the heat kernel at the reference's t between the sampled rows and the
    # training rows (read: blind to signs and rotations of the vectors)
    Vr = base.vectors(sp, rows.to(dev))
    Vf = torch.as_tensor(out["vectors"], device=dev).to(torch.float64)
    vf = torch.as_tensor(out["values"], device=dev).to(torch.float64)
    Hr = (Vr * base.heat_weights(sp.values, t_ref[0])) @ Vr[:m].T
    Hf = (Vf * base.heat_weights(vf, t_ref[0])) @ Vf[:m].T
    got["heat_kernel_gap"] = float(torch.abs(Hf - Hr).max() / torch.abs(Hr).max())
    del Vr, Hr, Hf

    # predict, the tail's arithmetic: the Laplace moments at the fit's t from
    # the fit's own eigenpair (its values and its vectors at the training rows
    # and the checked test rows, in float64), against the fit's mean and
    # variance at the checked test rows.  At the t the fit finds (1e6–1e8: t
    # is not identified on the torus, lae_gpc.check) the weights
    # exp(−t(1 − σ)) turn an eigenvalue's float32 error of 1e-7 into factors
    # of e and more, so the moments are judged on the fit's own spectrum, and
    # the spectrum by itself above
    checked = rows[m:].to(dev) - m
    mean_fit = torch.as_tensor(out["mean"], device=dev).to(torch.float64)
    var_fit = torch.as_tensor(out["var"], device=dev).to(torch.float64)
    own = Laplace(vf, Vf[:m], Yc[0], t_fit[0], fit["sigma"])
    mean_own, var_own = own.mean(Vf[m:]), own.var(Vf[m:])
    got["mean_gap"] = float(torch.abs(mean_fit[checked] - mean_own).max()
                            / torch.abs(mean_own).max())
    got["var_gap"] = float(torch.abs(var_fit - var_own).max() / torch.abs(var_own).max())
    del Vf

    # predict, against the reference's own spectrum at the fit's t, at every
    # test row: the probabilities and labels (the means' gap and the
    # variances' are read)
    post = Laplace(sp.values, Vm, Yc[0], t_fit[0], fit["sigma"])
    y_fit = torch.as_tensor(out["y_test"], device=dev).to(torch.float64)
    y_true = torch.as_tensor(data.y_test, device=dev).to(torch.float64)
    worst = top = prob = 0.0
    disagree = wrong = 0
    for a, Vb in _vector_blocks(sp, m, n):
        ref = post.mean(Vb)
        b = slice(a, a + ref.shape[0])
        worst = max(worst, float(torch.abs(mean_fit[b] - ref).max()))
        top = max(top, float(torch.abs(ref).max()))
        prob = max(prob, float(torch.abs(torch.sigmoid(mean_fit[b]) - torch.sigmoid(ref)).max()))
        disagree += int((y_fit[b] != (ref > 0).to(torch.float64)).sum())
        wrong += int((y_fit[b] != y_true[b]).sum())
    got["spectrum_mean_gap"] = worst / top
    got["prob_gap"] = prob
    got["label_disagree"] = disagree / (n - m)
    got["label_error"] = wrong / (n - m)
    var_ref = post.var(base.vectors(sp, rows[m:].to(dev)))
    got["spectrum_var_gap"] = float(torch.abs(var_fit - var_ref).max() / torch.abs(var_ref).max())
    return got


def control_fit(data, cfg: dict, rows: torch.Tensor, seed: int, dev,
                p: base.Precision = CONTROL) -> dict:
    """A whole fit by the reference's arithmetic at precision p, in the layout
    ``check`` reads: the sample (the reference's own draw), anchors (Lloyd on
    the sample from uniform sample rows), the counts over the file, graph,
    spectrum, t, and the Laplace moments."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the TF32 rounding is written out
    g, fit, st = cfg["graph"], dict(cfg["fit"], train=cfg["train"]), cfg["stream"]
    s, r, K = g["s"], g["r"], g["K"]
    Xf = read_rows(data.path)
    X = torch.from_numpy(np.array(Xf)).to(dev).to(p.graph)
    n, m = X.shape[0], len(data.y_train)
    sample = reservoir(Xf, min(st["sample_factor"] * s, n), st["chunk_rows"], st["sample_seed"])
    S = torch.from_numpy(sample).to(dev).to(p.graph)
    gen = torch.Generator(device=dev).manual_seed(seed)
    U = S[torch.randperm(S.shape[0], generator=gen, device=dev)[:s]]
    if p.tf32:
        U = base.tf32(U)
    assign = base.nearest(S, U, 1, p)[0][:, 0]
    for _ in range(g["kmeans_iters"]):
        cnt = base.counts_of(assign, s, p.graph)
        U = torch.where(cnt[:, None] > 0, base.cluster_means(S, assign, s), U)
        new = base.nearest(S, U, 1, p)[0][:, 0]
        moved = bool((new != assign).any())
        assign = new
        if not moved:
            break
    counts = base.counts_of(base.nearest(X, U, 1, p)[0][:, 0], s, p.graph)
    idx, _ = base.nearest(X, U, r, p)
    w = base.lae(X, U, idx, g["lae_iters"], p)
    sp = base.spectrum(w, idx, counts, s, K, p)
    values = sp.values.to(p.tail)
    Vm = base.vectors(sp, torch.arange(m, device=dev)).to(p.tail)
    Yc = base.class_columns(data.y_train, 1, dev, p.tail)
    t = base.train(values, Vm, Yc, fit)
    post = Laplace(values, Vm, Yc[0], t[0], fit["sigma"])
    mean = torch.cat([post.mean(Vb.to(p.tail)) for _, Vb in _vector_blocks(sp, m, n)])
    var = post.var(base.vectors(sp, rows[m:].to(dev)).to(p.tail))
    return dict(sample=sample, centers=U.cpu(), counts=counts.cpu(), idx=idx.cpu(), w=w.cpu(),
                values=sp.values.cpu(), vectors=base.vectors(sp, rows.to(dev)).cpu(),
                t=t.cpu(), mean=mean.cpu(), var=var.cpu(),
                y_test=(mean > 0).to(torch.float64).cpu().numpy())

