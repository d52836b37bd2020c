#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flgp_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit if it fails:

1. the card: name and power limit from nvidia-smi; a CUDA device is required
   (there is no CPU path) and TF32 is switched off;
2. build: nvcc compiles the kernels K1–K8 from flgp_tpu_torch/csrc for sm_90a;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   main path gives them: the torus config (n=4800, d=2, s=600, r=3, K=100)
   and the large config (n=1e6, d=2, s=1024, r=3, K=128), with both times;
4. the torus fit through ``fit_lae_logit_gp`` (error ≤ 0.03; all five
   kernels must be launched by it), then a second, warm fit for its time;
5. the n=1e6 fit (error ≤ 0.03), its wall time, build_spectrum's time alone
   and the peak device memory;
6. the chunked feature-major kernels K6–K8 vs their plain versions at the
   n=1e7 shape (153 chunks of 65536 points, r=3, s=1024, K=128, pads in the
   last chunk), and the chunked spectrum (K6–K8) vs the point-major one
   (K3–K5) on one n=1e6 graph;
7. the n=1e7 fit of the huge-n path (k-means anchors on a column sample,
   full-n cluster sizes, chunked graph, fused K6–K8 spectrum tail, training,
   O(n·K) predict tail) on two anchor draws (error ≤ 0.03 on each; K1, K2
   and K6–K8 must be launched by it), with stage times and peak memory.

The line before the last is one JSON object with the kernels' launches,
errors and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


if not (ROOT / "flgp_tpu_torch" / "__init__.py").is_file():
    _fail(f"no flgp_tpu_torch package beside {Path(__file__).name}; run it from a checkout")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import flgp_tpu_torch as ft  # noqa: E402
from flgp_tpu_torch.config import EPS, LaplacianType, pin_full_precision  # noqa: E402
from flgp_tpu_torch.datasets import torus_rings  # noqa: E402
from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc  # noqa: E402
from flgp_tpu_torch.fit.spectral import build_spectrum  # noqa: E402
from flgp_tpu_torch.fit.streaming import _gpc_lowrank_tail  # noqa: E402
from flgp_tpu_torch.ops import _build  # noqa: E402
from flgp_tpu_torch.ops import colmajor as col  # noqa: E402
from flgp_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from flgp_tpu_torch.ops.knn import knn_plain  # noqa: E402
from flgp_tpu_torch.ops.lae import lae_weights_plain  # noqa: E402
from flgp_tpu_torch.ops.spectrum import spectrum_fused  # noqa: E402
from flgp_tpu_torch.types import EigenPair  # noqa: E402

# name -> (CUDA source, TPU kernel it replaces: the pallas_call line)
KERNELS = {
    "knn": ("flgp_tpu_torch/csrc/knn.cu", "flgp_tpu/ops/pallas_kernels.py:99"),
    "lae_weights": ("flgp_tpu_torch/csrc/lae.cu", "flgp_tpu/ops/pallas_kernels.py:259"),
    "ell_colsum": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:361"),
    "ell_norm_gram": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:430"),
    "ell_norm_matmat": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:493"),
    "ell_colsum_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:550"),
    "ell_norm_gram_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:626"),
    "ell_norm_matmat_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:689"),
}
# the kernels each path must launch
MAIN_PATH = ("knn", "lae_weights", "ell_colsum", "ell_norm_gram", "ell_norm_matmat")
HUGE_PATH = ("knn", "lae_weights", "ell_colsum_t", "ell_norm_gram_t", "ell_norm_matmat_t")
SHAPES = {  # the configurations of the main path and of the huge-n path
    "torus": dict(n=4800, m=100, seed=1234, s=600, r=3, K=100),
    "large": dict(n=1_000_000, m=1000, seed=3, s=1024, r=3, K=128),
    "huge": dict(n=10_000_000, m=1000, seed=4, s=1024, r=3, K=128, chunk=1 << 16),
}
ERR_GATE = 0.03


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        _fail("nvidia-smi not found: this smoke test needs an NVIDIA GPU")
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _maxabs(a, b) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def _allclose(name, got, ref, rtol, atol):
    bad = torch.abs(got.double() - ref.double()) > atol + rtol * torch.abs(ref.double())
    if bool(torch.any(bad)):
        _fail(f"{name}: {int(bad.sum())} entries outside rtol={rtol} atol={atol} "
              f"(max abs err {_maxabs(got, ref):.3e})")


def check_kernels(label: str, cfg: dict, dev, results: dict) -> None:
    """Each kernel against its plain version on the same device inputs."""
    ds = torus_rings(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"])
    X = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32,
                        device=dev).contiguous()
    n, s, r, K = X.shape[0], cfg["s"], cfg["r"], cfg["K"]
    g = torch.Generator(device=dev).manual_seed(7)
    U = X[torch.randperm(n, generator=g, device=dev)[:s]].contiguous()
    # the k-means‖ candidate set: 1 + 4·ceil(2s/4) rows, searched with r = 1
    C = 1 + 4 * (-(-2 * s // 4))
    Uc = X[torch.randperm(n, generator=g, device=dev)[:C]].contiguous()
    reps_k, reps_p = (20, 5) if n < 100_000 else (10, 3)
    rows = []

    def record(name, err, ms, plain_ms):
        ent = results.setdefault(name, dict(max_abs_err=0.0))
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        ent[f"ms_{label}"], ent[f"plain_ms_{label}"] = ms, plain_ms
        rows.append(f"  {label:5s} {name:16s} kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
                    f"max_abs_err {err:.3e}")

    # K1 at the graph's r and at k-means‖'s r = 1 over the candidate set
    x2 = torch.sum(X * X, dim=1)
    for rr, UU in ((r, U), (1, Uc)):
        got = hk.knn(X, UU, rr)
        torch.cuda.synchronize()
        ref = knn_plain(X, UU, rr)
        differ = torch.any(got.indices != ref.indices, dim=1)
        n_differ = int(differ.sum())
        # a differing row must be a near-tie: same sorted d² within 1e-5·(|x|²+|u|²)
        u2max = float(torch.max(torch.sum(UU * UU, dim=1)))
        gap = torch.abs(got.sqdists[differ] - ref.sqdists[differ])
        n_far = int(torch.sum(torch.any(gap > 1e-5 * (x2[differ][:, None] + u2max), dim=1)))
        print(f"  {label:5s} knn r={rr}: {n_differ} of {n} rows differ, {n_far} of them "
              f"not near-ties", flush=True)
        if n_differ > 1e-4 * n:
            _fail(f"knn r={rr} {label}: indices differ on {n_differ} of {n} rows (> 0.01%)")
        if n_far:
            _fail(f"knn r={rr} {label}: {n_far} differing rows are not near-ties")
        _allclose(f"knn d² r={rr} {label}", got.sqdists, ref.sqdists, 1e-5, 1e-5)
        if rr == r:
            record("knn", _maxabs(got.sqdists, ref.sqdists),
                   cuda_ms(lambda: hk.knn(X, U, r), reps_k),
                   cuda_ms(lambda: knn_plain(X, U, r), reps_p))
        else:
            rows.append(f"  {label:5s} knn r=1 over {C} candidates: kernel "
                        f"{cuda_ms(lambda: hk.knn(X, Uc, 1), reps_k):9.4f} ms  plain "
                        f"{cuda_ms(lambda: knn_plain(X, Uc, 1), reps_p):9.4f} ms")
    idx = knn_plain(X, U, r).indices

    # K2
    got = hk.lae_weights(X, U, idx)
    torch.cuda.synchronize()
    ref = lae_weights_plain(X, U, idx)
    _allclose(f"lae_weights {label}", got, ref, 0.0, 2e-4)
    if float(torch.max(torch.abs(got.sum(1) - 1.0))) > 1e-5 or float(got.min()) < 0.0:
        _fail(f"lae_weights {label}: rows off the simplex")
    record("lae_weights", _maxabs(got, ref), cuda_ms(lambda: hk.lae_weights(X, U, idx), reps_k),
           cuda_ms(lambda: lae_weights_plain(X, U, idx), reps_p))
    w = ref

    # K3
    got = hk.ell_colsum(w, idx, s)
    torch.cuda.synchronize()
    ref = hk.ell_colsum_plain(w, idx, s)
    _allclose(f"ell_colsum {label}", got, ref, 1e-5, 0.0)
    record("ell_colsum", _maxabs(got, ref), cuda_ms(lambda: hk.ell_colsum(w, idx, s), reps_k),
           cuda_ms(lambda: hk.ell_colsum_plain(w, idx, s), reps_p))

    # K4, with the cluster-normalized column scale of the main path
    counts = torch.bincount(idx[:, 0].long(), minlength=s).to(torch.float32)
    cscale = (1.0 / (ref + EPS) * counts).contiguous()
    G, D = hk.ell_norm_gram(w, idx, cscale)
    torch.cuda.synchronize()
    Gp, Dp = hk.ell_norm_gram_plain(w, idx, cscale)
    for nm, a, b in (("G", G, Gp), ("D", D, Dp)):
        if _maxabs(a, b) > 1e-5 * float(torch.max(torch.abs(b))):
            _fail(f"ell_norm_gram {nm} {label}: max abs err {_maxabs(a, b):.3e} "
                  f"> 1e-5·max|{nm}|")
    record("ell_norm_gram", max(_maxabs(G, Gp), _maxabs(D, Dp)),
           cuda_ms(lambda: hk.ell_norm_gram(w, idx, cscale), reps_k),
           cuda_ms(lambda: hk.ell_norm_gram_plain(w, idx, cscale), reps_p))

    # K5
    W = torch.randn((s, K), generator=g, device=dev, dtype=torch.float32)
    got = hk.ell_norm_matmat(w, idx, cscale, W)
    torch.cuda.synchronize()
    ref = hk.ell_norm_matmat_plain(w, idx, cscale, W)
    _allclose(f"ell_norm_matmat {label}", got, ref, 1e-5, 1e-5)
    record("ell_norm_matmat", _maxabs(got, ref),
           cuda_ms(lambda: hk.ell_norm_matmat(w, idx, cscale, W), reps_k),
           cuda_ms(lambda: hk.ell_norm_matmat_plain(w, idx, cscale, W), reps_p))
    print(f"kernels vs plain, {label} shape (n={n}, s={s}, r={r}, K={K}), ms per call:")
    print("\n".join(rows), flush=True)


def fit(cfg: dict, fit_cfg, dev, seed: int):
    ds = torus_rings(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ft.fit_lae_logit_gp(torch.Generator(device=dev).manual_seed(seed), ds.x_train,
                              ds.y_train, ds.x_test, cfg=fit_cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_test = cfg["n"] - cfg["m"]
    for nm, arr in (("posterior_mean", res.posterior_mean), ("posterior_cov", res.posterior_cov)):
        if arr.shape != (n_test,) or not np.all(np.isfinite(arr)):
            _fail(f"{nm}: shape {arr.shape} or non-finite values")
    if res.y_test.shape != (n_test,) or not np.all(np.isin(res.y_test, (0.0, 1.0))):
        _fail("y_test is not a 0/1 label per test point")
    return res, float(np.mean(res.y_test != ds.y_test)), wall, ds


def large_fit(dev) -> None:
    """Phase 5; its tensors (the (n, m) cross-covariance) are freed on return."""
    big = SHAPES["large"]
    big_cfg = ft.FitConfig(graph=ft.GraphConfig(s=big["s"], r=big["r"], K=big["K"]), sigma=1e-3,
                           n_gibbs=50, gibbs_avg_sweeps=25, dtype=torch.float32,
                           solve_dtype=torch.float64)
    torch.cuda.reset_peak_memory_stats()
    res, err, wall, ds = fit(big, big_cfg, dev, seed=1)
    peak = torch.cuda.max_memory_allocated()
    X_all = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32,
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_spectrum(torch.Generator(device=dev).manual_seed(1), X_all, big_cfg.graph)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    print(f"n=1e6 fit: err {err:.6f}  t {float(res.pars['t']):.6g}  wall {wall:.3f} s  "
          f"build_spectrum alone {spec_s:.3f} s  peak memory {peak / 2**30:.2f} GiB", flush=True)
    if err > ERR_GATE:
        _fail(f"n=1e6 test error {err} > {ERR_GATE}")


def feature_major(ds, dev) -> torch.Tensor:
    """The (d, n) float32 cloud [train; test] on the card."""
    X = np.concatenate([ds.x_train, ds.x_test]).T.astype(np.float32)
    return torch.as_tensor(X, device=dev).contiguous()


def random_anchors(Xt, s: int, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return Xt[:, torch.randperm(Xt.shape[1], generator=g, device=dev)[:s]].T.contiguous()


def _same_subspaces(Vg, Vr, values, rows, gap=1e-3) -> float:
    """Largest |P_got − P_ref| over the spectral projectors P = V_c·V_cᵀ (on a
    row sample) of each cluster of eigenvalues closer than gap·λ₁: up to
    sign for a separated eigenvalue, up to rotation inside a near-degenerate
    cluster (the torus rings give eigenvalues within 1e-6 of each other)."""
    K = values.shape[0]
    lam = values.double().cpu()
    cuts = [0] + [k for k in range(1, K) if float(lam[k - 1] - lam[k]) > gap * float(lam[0])]
    worst = 0.0
    for a, b in zip(cuts, cuts[1:] + [K]):
        Pg = Vg[rows, a:b].double() @ Vg[rows, a:b].double().T
        Pr = Vr[rows, a:b].double() @ Vr[rows, a:b].double().T
        worst = max(worst, _maxabs(Pg, Pr) / float(torch.max(torch.abs(Pr))))
    return worst


def check_kernels_t(Xt7, dev, results: dict) -> None:
    """K6–K8 against their plain versions at the n=1e7 chunked shape, on a
    graph from K1 + K2 over the torus cloud; then the chunked spectrum
    against the point-major one on an n=1e6 graph."""
    cfg = SHAPES["huge"]
    n, s, r, K, chunk = Xt7.shape[1], cfg["s"], cfg["r"], cfg["K"], cfg["chunk"]
    U = random_anchors(Xt7, s, dev, seed=7)
    idx, w = col.build_graph_colmajor(Xt7, U, r, chunk=chunk)
    nch, _, c = w.shape
    n_pad = nch * c - n
    if float(torch.max(torch.abs(col.point_major(w, nch * c)[n:]))) != 0.0:
        _fail("build_graph_colmajor left a nonzero weight on a pad point")
    counts = torch.bincount(col.point_major(idx, n)[:, 0].long(), minlength=s).to(torch.float32)
    rows = [f"kernels vs plain, chunked shape (nch={nch}, r={r}, c={c}, s={s}, K={K}; "
            f"{n_pad} pad points), ms per call:"]

    def record(name, err, ms, plain_ms, note=""):
        results[name] = dict(max_abs_err=err, ms_huge=ms, plain_ms_huge=plain_ms)
        rows.append(f"  huge  {name:18s} kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
                    f"max_abs_err {err:.3e}{note}")

    # K6 and K7 sum 3.1e7 and 9.2e7 terms with float atomics; the float32
    # plain versions (index_add_) are atomic sums too, and their own rounding
    # nears the 1e-5·max gate at this length.  So both kernels are held
    # against the plain versions run in float64 on the same inputs, and the
    # float32 plain versions' own error is printed beside them.
    w64 = w.double()

    got = hk.ell_colsum_t(w, idx, s)
    torch.cuda.synchronize()
    ref = hk.ell_colsum_t_plain(w64, idx, s)
    err, err32 = _maxabs(got, ref), _maxabs(hk.ell_colsum_t_plain(w, idx, s), ref)
    if err > 1e-5 * float(torch.max(torch.abs(ref))):
        _fail(f"ell_colsum_t: max abs err {err:.3e} > 1e-5·max|C| (f64 plain)")
    record("ell_colsum_t", err, cuda_ms(lambda: hk.ell_colsum_t(w, idx, s), 10),
           cuda_ms(lambda: hk.ell_colsum_t_plain(w, idx, s), 3),
           f"  (f32 plain {err32:.3e}, of max|C| {float(torch.max(ref)):.4g})")
    cscale = (1.0 / (got + EPS) * counts).contiguous()

    G, D = hk.ell_norm_gram_t(w, idx, cscale)
    torch.cuda.synchronize()
    Gp, Dp = hk.ell_norm_gram_t_plain(w64, idx, cscale.double())
    for nm, a, b in (("G", G, Gp), ("D", D, Dp)):
        if _maxabs(a, b) > 1e-5 * float(torch.max(torch.abs(b))):
            _fail(f"ell_norm_gram_t {nm}: max abs err {_maxabs(a, b):.3e} > 1e-5·max|{nm}| "
                  f"(f64 plain)")
    G32, D32 = hk.ell_norm_gram_t_plain(w, idx, cscale)
    record("ell_norm_gram_t", max(_maxabs(G, Gp), _maxabs(D, Dp)),
           cuda_ms(lambda: hk.ell_norm_gram_t(w, idx, cscale), 10),
           cuda_ms(lambda: hk.ell_norm_gram_t_plain(w, idx, cscale), 3),
           f"  (f32 plain {max(_maxabs(G32, Gp), _maxabs(D32, Dp)):.3e}, of max|G| "
           f"{float(torch.max(torch.abs(Gp))):.4g}, max|D| {float(torch.max(torch.abs(Dp))):.4g})")
    del Gp, Dp, G32, D32, w64

    g = torch.Generator(device=dev).manual_seed(8)
    W = torch.randn((s, K), generator=g, device=dev, dtype=torch.float32)
    got = hk.ell_norm_matmat_t(w, idx, cscale, W)
    torch.cuda.synchronize()
    ref = hk.ell_norm_matmat_t_plain(w, idx, cscale, W)
    _allclose("ell_norm_matmat_t", got, ref, 1e-5, 1e-5)
    if float(torch.max(torch.abs(got[n:]))) != 0.0:
        _fail("ell_norm_matmat_t: a pad row is not zero")
    err = _maxabs(got, ref)
    del got, ref
    record("ell_norm_matmat_t", err, cuda_ms(lambda: hk.ell_norm_matmat_t(w, idx, cscale, W), 10),
           cuda_ms(lambda: hk.ell_norm_matmat_t_plain(w, idx, cscale, W), 3))
    del idx, w
    print("\n".join(rows), flush=True)

    # the chunked spectrum (K6–K8) vs the point-major one (K3–K5), one graph
    big = SHAPES["large"]
    Xt6 = feature_major(torus_rings(n=big["n"], m_train=big["m"], seed=big["seed"]), dev)
    n6, K6 = Xt6.shape[1], big["K"]
    U6 = random_anchors(Xt6, big["s"], dev, seed=9)
    counts6 = col.cluster_sizes_colmajor(Xt6, U6, chunk=chunk)
    idx6, w6 = col.build_graph_colmajor(Xt6, U6, big["r"], chunk=chunk)
    cn = LaplacianType.CLUSTER_NORMALIZED
    got = col.spectrum_fused_colmajor(idx6, w6, big["s"], K6, cn, True, n6, counts6)
    ref = spectrum_fused(col.point_major(w6, n6).contiguous(),
                         col.point_major(idx6, n6).contiguous(), big["s"], K6, cn, True, counts6)
    torch.cuda.synchronize()
    _allclose("chunked vs point-major eigenvalues", got.values, ref.values, 1e-4, 0.0)
    sample = torch.randperm(n6, generator=torch.Generator(device=dev).manual_seed(10),
                            device=dev)[:4096]
    sub_err = _same_subspaces(got.vectors, ref.vectors, ref.values, sample)
    print(f"chunked (K6–K8) vs point-major (K3–K5) spectrum, n=1e6 ({idx6.shape[0]} chunks): "
          f"eigenvalues max abs err {_maxabs(got.values, ref.values):.3e}, eigenvector "
          f"projectors max rel err {sub_err:.3e}", flush=True)
    if sub_err > 1e-2:
        _fail(f"chunked vs point-major eigenvectors: projector rel err {sub_err:.3e} > 1e-2")


def huge_fit(Xt, ds, dev, seed: int) -> dict:
    """The n=1e7 fit of the huge-n path, stage by stage, with a sync after
    each stage: k-means anchors on a 2^17-column sample, full-n cluster
    sizes, heat_kernel_spectrum_colmajor (cluster-normalized), _train_gpc on
    the train rows cast to float64, and the O(n·K) predict tail."""
    cfg = SHAPES["huge"]
    n, m, s, K = Xt.shape[1], cfg["m"], cfg["s"], cfg["K"]
    fit_cfg = ft.FitConfig(graph=ft.GraphConfig(s=s, r=cfg["r"], K=K), sigma=1e-3, n_gibbs=50,
                           gibbs_avg_sweeps=25, dtype=torch.float32, solve_dtype=torch.float64)
    g = fit_cfg.graph
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    U = stage("anchors", lambda: col.kmeans_anchors_colmajor(gen, Xt, s, n_sample=1 << 17))
    counts = stage("cluster_sizes", lambda: col.cluster_sizes_colmajor(Xt, U, cfg["chunk"]))
    eig = stage("graph+spectrum", lambda: col.heat_kernel_spectrum_colmajor(
        Xt, U, g.r, K, g.gl, g.root, cluster_sizes=counts, chunk=cfg["chunk"]))
    Y = torch.as_tensor(ds.y_train, dtype=torch.float32, device=dev)
    N = torch.ones((m,), dtype=torch.float32, device=dev)
    scfg, eig_m, (Ys, Ns) = _solve_cast(fit_cfg, EigenPair(eig.values, eig.vectors[:m]), Y, N)
    res = stage("train", lambda: _train_gpc(eig_m, Ys, Ns, slice(0, m), K, scfg))
    labels, probs, mean, var = stage("predict_tail", lambda: _gpc_lowrank_tail(
        gen, eig, Ys, Ns, torch.arange(m, device=dev), K, scfg, res.x, 1, cfg["chunk"]))
    for nm, arr in (("labels", labels), ("probs", probs), ("mean", mean), ("var", var)):
        if arr.shape != (n,) or not bool(torch.all(torch.isfinite(arr))):
            _fail(f"n=1e7 {nm}: shape {tuple(arr.shape)} or non-finite values")
    if not bool(torch.all((labels == 0) | (labels == 1))) or not bool(torch.all(var > 0)):
        _fail("n=1e7: labels not 0/1 or a posterior variance not positive")
    y_test = torch.as_tensor(ds.y_test, dtype=labels.dtype, device=dev)
    err = float(torch.mean((labels[m:] != y_test).double()))
    return dict(err=err, t=float(res.x), wall=sum(times.values()), times=times, anchors=U,
                counts=counts)


def huge_phase(dev, results: dict) -> dict:
    """Phases 6 and 7 on one n=1e7 torus cloud; returns the launches of the
    first n=1e7 fit."""
    cfg = SHAPES["huge"]
    t0 = time.perf_counter()
    ds7 = torus_rings(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"])
    Xt7 = feature_major(ds7, dev)
    print(f"n=1e7 torus cloud: {time.perf_counter() - t0:.2f} s on the host", flush=True)

    check_kernels_t(Xt7, dev, results)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    fits = [huge_fit(Xt7, ds7, dev, seed=40)]
    launches = dict(hk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    fits.append(huge_fit(Xt7, ds7, dev, seed=41))
    for label, f in zip(("first", "warm"), fits):
        stages = "  ".join(f"{k} {v:.3f}" for k, v in f["times"].items())
        print(f"n=1e7 fit ({label} draw): err {f['err']:.6f}  t {f['t']:.6g}  "
              f"wall {f['wall']:.3f} s  [{stages}]", flush=True)
    # the graph and the spectrum tail apart, on the warm draw's anchors
    last = fits[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, w = col.build_graph_colmajor(Xt7, last["anchors"], cfg["r"], chunk=cfg["chunk"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    col.spectrum_fused_colmajor(idx, w, cfg["s"], cfg["K"], LaplacianType.CLUSTER_NORMALIZED,
                                True, Xt7.shape[1], last["counts"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"n=1e7 graph alone {t1 - t0:.3f} s, spectrum tail (K6, K7, eigh, K8) alone "
          f"{t2 - t1:.3f} s; peak memory of the first fit {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    for label, f in zip(("first", "warm"), fits):
        if f["err"] > ERR_GATE:
            _fail(f"n=1e7 test error {f['err']} > {ERR_GATE} ({label} anchor draw)")
    missing = [k for k in HUGE_PATH if launches[k] == 0]
    if missing:
        _fail(f"the n=1e7 fit launched no {missing} kernel")
    return launches


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}", flush=True)
    pin_full_precision()
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}", flush=True)
    ptxas = (lib.parent / "ptxas.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas))
    print(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers a thread, "
          f"{spills} bytes of spill stores in all", flush=True)

    # 3. kernels vs plain versions
    results: dict = {}
    for label in ("torus", "large"):
        check_kernels(label, SHAPES[label], dev, results)

    # 4. torus fit: the main path, through the entry point a user calls
    tor = SHAPES["torus"]
    tor_cfg = ft.FitConfig(graph=ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"]), sigma=1e-3,
                           dtype=torch.float32, solve_dtype=torch.float64)
    hk.reset_launches()
    res, err, wall, _ = fit(tor, tor_cfg, dev, seed=0)
    launches = dict(hk.LAUNCHES)
    print(f"torus fit (cold): err {err:.6f}  t {float(res.pars['t']):.6g}  wall {wall:.3f} s  "
          f"launches {launches}", flush=True)
    if err > ERR_GATE:
        _fail(f"torus test error {err} > {ERR_GATE}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        _fail(f"the torus fit launched no {missing} kernel")
    res, err2, wall2, _ = fit(tor, tor_cfg, dev, seed=0)
    print(f"torus fit (warm): err {err2:.6f}  wall {wall2:.3f} s", flush=True)
    if err2 > ERR_GATE:
        _fail(f"warm torus test error {err2} > {ERR_GATE}")

    # 5. the n=1e6 fit
    large_fit(dev)
    torch.cuda.empty_cache()

    # 6. and 7. the huge-n path: K6–K8, then the n=1e7 fit
    launches.update({k: v for k, v in huge_phase(dev, results).items() if k.endswith("_t")})

    # K1–K5: launches of the torus fit, times at the n=1e6 shape; K6–K8:
    # launches of the first n=1e7 fit, times at the n=1e7 shape
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        shape = "huge" if name.endswith("_t") else "large"
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r[f"ms_{shape}"], plain_ms=r[f"plain_ms_{shape}"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
