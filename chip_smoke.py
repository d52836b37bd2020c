#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flgp_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit if it fails:

1. the card: name and power limit from nvidia-smi; a CUDA device is required
   (there is no CPU path) and TF32 is switched off;
2. build: nvcc compiles the kernels K1–K5 from flgp_tpu_torch/csrc for sm_90a;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   main path gives them: the torus config (n=4800, d=2, s=600, r=3, K=100)
   and the large config (n=1e6, d=2, s=1024, r=3, K=128), with both times;
4. the torus fit through ``fit_lae_logit_gp`` (error ≤ 0.03; all five
   kernels must be launched by it), then a second, warm fit for its time;
5. the n=1e6 fit (error ≤ 0.03), its wall time, build_spectrum's time alone
   and the peak device memory.

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
from flgp_tpu_torch.config import EPS, pin_full_precision  # noqa: E402
from flgp_tpu_torch.datasets import torus_rings  # noqa: E402
from flgp_tpu_torch.fit.spectral import build_spectrum  # noqa: E402
from flgp_tpu_torch.ops import _build  # noqa: E402
from flgp_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from flgp_tpu_torch.ops.knn import knn_plain  # noqa: E402
from flgp_tpu_torch.ops.lae import lae_weights_plain  # noqa: E402

# name -> (CUDA source, TPU kernel it replaces: the pallas_call line)
KERNELS = {
    "knn": ("flgp_tpu_torch/csrc/knn.cu", "flgp_tpu/ops/pallas_kernels.py:99"),
    "lae_weights": ("flgp_tpu_torch/csrc/lae.cu", "flgp_tpu/ops/pallas_kernels.py:259"),
    "ell_colsum": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:361"),
    "ell_norm_gram": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:430"),
    "ell_norm_matmat": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:493"),
}
SHAPES = {  # the two configurations of the main path
    "torus": dict(n=4800, m=100, seed=1234, s=600, r=3, K=100),
    "large": dict(n=1_000_000, m=1000, seed=3, s=1024, r=3, K=128),
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
    for label, shp in SHAPES.items():
        check_kernels(label, shp, dev, results)

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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        _fail(f"the torus fit launched no {missing} kernel")
    res, err2, wall2, _ = fit(tor, tor_cfg, dev, seed=0)
    print(f"torus fit (warm): err {err2:.6f}  wall {wall2:.3f} s", flush=True)
    if err2 > ERR_GATE:
        _fail(f"warm torus test error {err2} > {ERR_GATE}")

    # 5. the n=1e6 fit
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

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms_large"], plain_ms=r["plain_ms_large"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
