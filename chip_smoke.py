#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flgp_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --sass build/flgp_tpu_torch/<hash>/libflgp_kernels.so

(the second only counts K2's instructions in a library already built).
Phases, each of which ends the script with a non-zero exit if it fails:

1. the card: name and power limit from nvidia-smi; a CUDA device is required
   (there is no CPU path) and TF32 is switched off;
2. build: nvcc compiles the kernels K1–K9 and ``ell_sym_matmat`` from
   flgp_tpu_torch/csrc for sm_90a (one nvcc process per source, all at once);
   the instructions one FISTA step of K2 issues at r=3 are counted from the
   library's SASS (``cuobjdump``), for both arithmetic variants;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   main path gives them: the torus config (n=4800, d=2, s=600, r=3, K=100)
   and the large config (n=1e6, d=2, s=1024, r=3, K=128), with both times;
   K2 in the exact variant the fits launch (held to the plain version at
   2e-4; it is equal bit for bit) and, reported only, in its fused
   multiply-add variant with the differences of its weights and of the
   reconstructions zᵀU from the plain version's;
   K1 and K2 also at the n=1e7 path's launch shape of K1 (one 65,536-point
   chunk against 1,024 anchors; K1 r=3 and r=1), where most of K1's
   launches happen; K3 and K4, whose sums are exact, against the float64
   plain versions, K3 also against its own arithmetic in PyTorch
   (``_colsum_fixed_plain``) bit for bit, both against themselves over five
   launches, K4 with its kept and spilled pair additions and, as its
   yardstick, ``torch.sparse.mm`` of the normalized graph's CSR transpose
   and CSR;
4. the torus fit through ``fit_lae_logit_gp`` (error ≤ 0.03; all five
   kernels must be launched by it), then a second, warm fit for its time;
5. the n=1e6 fit (error ≤ 0.03), its wall time, build_spectrum's time alone
   and the peak device memory; then the port's subsampler twice from one
   seed, two fits on the first draw's anchors from one generator seed (both
   learned t's printed) and two ``spectrum_fused`` calls on that graph,
   which must give the same eigenvalues and vectors bit for bit;
6. K2's feature-major entry (one launch over the whole n=1e7 cloud on the
   chunked layout) vs its plain version, with the per-chunk composition it
   replaced beside it; the chunked feature-major kernels K6–K8 vs their
   plain versions at the n=1e7 shape (153 chunks of 65536 points, r=3,
   s=1024, K=128, pads in the last chunk), K6 and K7 as K3 and K4 are held
   (five launches, K6 bit for bit against ``_colsum_fixed_plain``, K7 with
   ``torch.sparse.mm`` beside it), K7 with the share of its pair additions
   that stayed in shared memory and, as a yardstick, with its table forced
   down to two slots (nearly every addition a global atomic, the same bits);
   and the chunked spectrum (K6–K8) vs the point-major one (K3–K5) on one
   n=1e6 graph;
7. the n=1e7 fit of the huge-n path (k-means anchors on a column sample,
   full-n cluster sizes, chunked graph, fused K6–K8 spectrum tail, training,
   O(n·K) predict tail) on two anchor draws (error ≤ 0.03 on each; K1, K2
   and K6–K8 must be launched by it, K2 once), with stage times and peak
   memory;
8. K1 as the GLGP graph calls it (self-kNN, s = n = 1e5, d = 3, r = 8) vs
   its plain version: differing rows near-ties only, d² within 1e-5, every
   point its own nearest neighbour at d² ≈ 0; then
   K9 ``ell_matmat`` vs its plain version at the shape the SE torus fit
   launches it at (spectrum_from_Z: n = 4800, s = 600, r = 3, K = 100; the
   kernels line takes K9's numbers from this one) and, as side rows that no
   fit launches, at n = 1e6, s = 1024, r = 3, K = 128, at the LOBPCG block's
   shape (n = s = 1e5, r = 8, K = 384, the only one its slab body serves)
   and at the torus GLGP shape (n = s = 4800, r = 48, K = 300), with the
   times of ``torch.sparse.mm`` on the same matrix as CSR
   and of the operator's transposed half (``EllMatrix.rmatmat``); then the
   symmetric operator product ``ell_sym_matmat`` (both halves, one launch)
   vs its plain version at the first and the last of those shapes, with the
   time to build the transpose's CSR structure apart and, as yardsticks,
   ``torch.sparse.mm`` on the symmetrized CSR and the composition it
   replaced (K9 + ``rmatmat`` + an add);
9. the sparse GLGP spectrum of a Gaussian cloud (n = 1e5, d = 3, r = 8,
   K = 128, 60 LOBPCG iterations, float32): wall time, largest residual, 61
   ``ell_sym_matmat`` launches, eigenvalues against the same solve through
   the plain operator from the same start block; then the device time of
   each piece of one LOBPCG iteration at that shape and at the torus GLGP
   fit's;
10. fits through the entry points, f32 graph and f64 tail, cold and warm:
    ``fit_gl_logit_gp`` (sparse LOBPCG; ``ell_sym_matmat`` must be launched)
    and ``fit_se_logit_gp`` (K9 must be) on the torus, ``fit_lae_regression_gp``,
    ``fit_se_regression_gp`` and ``fit_nystrom_regression_gp`` on the spiral.

Beside each kernel's time stand its bound (the least time the card could
take: compulsory bytes at 3.35 TB/s or operations at the 67 TFLOP/s float32
peak, whichever is larger, from this run's shapes and data) and, where one
PyTorch call computes the same function, that call's time (``index_add_``,
``torch.sparse.mm``; of two CSR matrices for Ĝ); the port never calls those
on a fit's path.

The line before the last is one JSON object with the kernels' launches,
errors, times and bounds; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
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
from flgp_tpu_torch.datasets import spiral, torus_rings  # noqa: E402
from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc  # noqa: E402
from flgp_tpu_torch.fit.spectral import build_spectrum  # noqa: E402
from flgp_tpu_torch.fit.streaming import _gpc_lowrank_tail  # noqa: E402
from flgp_tpu_torch.ops import _build  # noqa: E402
from flgp_tpu_torch.ops import colmajor as col  # noqa: E402
from flgp_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from flgp_tpu_torch.ops.kmeans import subsample  # noqa: E402
from flgp_tpu_torch.ops.knn import knn, knn_plain  # noqa: E402
from flgp_tpu_torch.ops.lae import lae_weights, lae_weights_plain  # noqa: E402
from flgp_tpu_torch.ops.lobpcg import _chol_qr, lobpcg_standard  # noqa: E402
from flgp_tpu_torch.ops.sparse_graph import (  # noqa: E402
    SymCoo, glgp_operator, sym_structure, symmetrize_knn)
from flgp_tpu_torch.ops.spectrum import spectrum_fused  # noqa: E402
from flgp_tpu_torch.types import EigenPair, EllMatrix  # noqa: E402

# name -> (CUDA source, TPU kernel it replaces: the pallas_call line)
KERNELS = {
    "knn": ("flgp_tpu_torch/csrc/knn.cu", "flgp_tpu/ops/pallas_kernels.py:99"),
    "lae_weights": ("flgp_tpu_torch/csrc/lae.cu", "flgp_tpu/ops/pallas_kernels.py:259"),
    "ell_colsum": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:361"),
    "ell_norm_gram": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:430"),
    "ell_norm_matmat": ("flgp_tpu_torch/csrc/ell.cu", "flgp_tpu/ops/pallas_kernels.py:493"),
    "ell_colsum_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:550"),
    "ell_norm_gram_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:626"),
    "ell_norm_matmat_t": ("flgp_tpu_torch/csrc/ell_t.cu", "flgp_tpu/ops/pallas_kernels.py:689"),
    "ell_matmat": ("flgp_tpu_torch/csrc/ell_matmat.cu", "flgp_tpu/ops/pallas_kernels.py:740"),
    # K9's gather over a graph and its transpose: the operator product the
    # reference sums over its edge list in plain XLA
    "ell_sym_matmat": ("flgp_tpu_torch/csrc/ell_matmat.cu", "flgp_tpu/ops/sparse_graph.py:27"),
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
# the sparse GLGP spectrum's shape (a Gaussian cloud) and the README-size fits
LOBPCG = dict(n=100_000, d=3, r=8, K=128, iters=60)
SPIRAL = dict(n=4000, m=200, s=500, r=3, K=100)
RMSE_GATES = {"fit_lae_regression_gp": 0.60, "fit_se_regression_gp": 0.61,
              "fit_nystrom_regression_gp": 2.5}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def work(name: str, n: int, r: int, s: int, K: int = 0, d: int = 0, distinct=None) -> dict:
    """Compulsory bytes (each input read once, each output written once) and
    float32 operations of one call of a kernel, from its shapes; for the
    chunked kernels n counts the pad points too (they are stored and read).
    K9 reads only the ``distinct`` rows of W that the graph names; the
    symmetric product reads the graph as ELL and the ``distinct`` entries of
    its transpose that the CSR holds (a value and a source each, n + 1 row
    starts) and names every row of X."""
    graph = 8 * n * r                                   # f32 values + i32 indices
    if name == "knn":           # d²: 2d for the dot product, 2 to add the norms
        return dict(bytes=4 * (n * d + s * d) + 8 * n * r, flops=n * s * (2 * d + 2))
    if name == "lae_weights":
        # the algorithm's count, fixed: every add, multiply, divide, min/max,
        # compare and sqrt of FISTA as lae_weights_plain writes it is one
        # operation, whatever a kernel's body does with them (a table for the
        # momentum, a fused multiply-add), so that every design of K2 stands
        # against the same bound.  Set-up: G and b (2d−1)(r²+r), the step
        # bound L 2r²+2.  One of the 150 FISTA steps: momentum 3r+2, gradient
        # step 2r²+2r, simplex projection (sorting network r(r−1), running
        # sums r−1, ρ 4r, θ 2, clip 2r), next d 6
        step = 3 * r * r + 11 * r + 9
        return dict(bytes=4 * (n * d + s * d) + 8 * n * r,
                    flops=n * ((2 * d - 1) * (r * r + r) + 2 * r * r + 2 + 150 * step))
    if name.startswith("ell_colsum"):
        return dict(bytes=graph + 4 * s, flops=n * r)
    if name.startswith("ell_norm_gram"):
        return dict(bytes=graph + 4 * s + 4 * s * s + 4 * s, flops=n * (2 * r * r + 4 * r))
    if name.startswith("ell_norm_matmat"):
        return dict(bytes=graph + 4 * s + 4 * s * K + 4 * n * K, flops=n * (2 * r * K + 4 * r))
    if name == "ell_matmat":
        return dict(bytes=graph + 4 * K * (s if distinct is None else distinct) + 4 * n * K,
                    flops=2 * n * r * K)
    if name == "ell_sym_matmat":
        return dict(bytes=graph + 8 * distinct + 4 * (n + 1) + 4 * n * K + 4 * n * K,
                    flops=2 * (n * r + distinct) * K)
    raise KeyError(name)


def bound(w: dict) -> tuple:
    """(least ms the card could take, which of the two terms sets it)."""
    by_bytes, by_ops = w["bytes"] / HBM_BYTES_PER_S, w["flops"] / F32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def ell_to_csr(values: torch.Tensor, indices: torch.Tensor, s: int) -> torch.Tensor:
    """The (n, s) matrix of an (n, r) ELL graph as CSR, columns sorted
    within each row; the yardstick ``torch.sparse.mm`` multiplies this."""
    n, r = values.shape
    cols, order = torch.sort(indices.long(), dim=1)
    crow = torch.arange(0, n * r + 1, r, dtype=torch.int64, device=values.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), torch.gather(values, 1, order).reshape(-1),
                                   size=(n, s))


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
    """Mean device time of fn over reps launches, after one warm-up call.
    A long matrix product is queued first, so the timed launches wait behind
    it and then run back to back: the host's time to issue a launch (tens of
    microseconds through a wrapper) stays out of a short kernel's number."""
    fn()
    torch.cuda.synchronize()
    busy = torch.ones((6144, 6144), dtype=torch.float32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy @ busy
    del busy                      # freed for the allocator once the product has run
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


def same_bits(fn, first, launches: int = 4) -> bool:
    """Whether ``launches`` more calls of fn give the bits of ``first`` (a
    tensor or a tuple whose leading entries are compared)."""
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(launches):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        if not all(torch.equal(a, b) for a, b in zip(out, first)):
            return False
    return True


def gram_library(values, idx, s: int, ref, reps: int) -> tuple:
    """The yardstick of K4 and K7: ``torch.sparse.mm(Znᵀ, Zn)``, CSR × CSR
    of the normalized (n, r) graph, both built outside the timed call.
    Returns (ms or None, a note with its difference from ``ref`` or the
    error that refused it)."""
    n, r = values.shape
    rows = torch.arange(n, device=values.device).repeat_interleave(r)
    coo = torch.sparse_coo_tensor(torch.stack([rows, idx.reshape(-1).long()]), values.reshape(-1),
                                  size=(n, s)).coalesce()
    A, At = coo.to_sparse_csr(), coo.t().coalesce().to_sparse_csr()
    del rows, coo
    try:
        err = _maxabs(torch.sparse.mm(At, A).to_dense(), ref)
        ms = cuda_ms(lambda: torch.sparse.mm(At, A), reps)
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch.sparse.mm(Znᵀ, Zn): none, refused ({str(e).splitlines()[0][:200]})"
    return ms, f"torch.sparse.mm(Znᵀ, Zn) (CSR × CSR) vs f64 plain: max abs diff {err:.3e}"


def sass_fista_step(lib: Path, r: int = 3) -> dict:
    """Instructions one FISTA step of K2 issues, per arithmetic variant,
    counted from the library's SASS: the largest loop (a backward branch and
    everything back to its target) of each ``lae_kernel<r, ·>`` instance,
    divided by the steps the compiler unrolled into it (a step has r² FMNMX:
    the sorting network's r(r−1) and the clip's r).  A report, not a check:
    {"not counted": reason} where the disassembler is missing or its output
    is not understood."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"not counted": repr(e)}
    if out.returncode != 0:
        return {"not counted": f"cuobjdump: {out.stderr.strip()[-300:]}"}
    found = {}
    for chunk in out.stdout.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        m = re.search(rf"lae_kernelILi{r}E(Lb([01])E)?", name)
        if not m:
            continue
        ins, labels, pending = [], {}, []     # a branch names an address or a label
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_\w+):", line)
            m_ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                             r"\s*([^;]*);", line)
            if lab:
                pending.append(lab.group(1))
            elif m_ins:
                addr = int(m_ins.group(1), 16)
                labels.update({name_: addr for name_ in pending})
                pending = []
                ins.append((addr, m_ins.group(2), m_ins.group(3)))
        loops = []
        for addr, op, arg in ins:
            if not op.startswith("BRA"):
                continue
            t = re.search(r"0x([0-9a-f]+)", arg)
            lab = re.search(r"\.L_\w+", arg)
            target = int(t.group(1), 16) if t else labels.get(lab.group(0)) if lab else None
            if target is not None and target <= addr:
                loops.append([o for a, o, _ in ins if target <= a <= addr])
        if not loops:
            return {"not counted": f"no loop found in the SASS of {name}"}
        body = max(loops, key=len)
        steps = sum(o.startswith("FMNMX") for o in body) / (r * r)
        variant = {None: "exact", "0": "exact", "1": "fused"}[m.group(2)]
        found[variant] = dict(loop=len(body), steps=steps, per_step=len(body) / max(steps, 1e-9),
                              ops=dict(Counter(o.split(".")[0] for o in body).most_common()))
    return found or {"not counted": f"no lae_kernel<{r}> instance in the SASS of {lib.name}"}


def print_sass(lib: Path) -> None:
    for variant, c in sass_fista_step(lib).items():
        if variant == "not counted":
            print(f"  SASS, lae_kernel<r=3>: not counted ({c})", flush=True)
        else:
            print(f"  SASS, lae_kernel<r=3> {variant}: {c['per_step']:.1f} instructions a FISTA "
                  f"step ({c['loop']} in the loop, {c['steps']:g} steps unrolled into it): "
                  f"{c['ops']}", flush=True)


def lae_differences(U, idx, got, ref) -> tuple:
    """Max abs difference of two sets of LAE weights on point-major arrays,
    and of the reconstructions zᵀU_i they give."""
    Ui = U[idx.long()]
    recon = lambda z: torch.einsum("nr,nrd->nd", z.double(), Ui.double())  # noqa: E731
    return _maxabs(got, ref), _maxabs(recon(got), recon(ref))


def check_lae(label: str, X, U, idx, reps: int, results: dict, key: str) -> tuple:
    """K2's point-major entry against its plain version: the exact variant
    (the one the fits launch) held to 2e-4 and to the simplex; the fused
    variant reported beside it and held to nothing.  Returns (kernel's
    weights, plain version's weights, kernel ms)."""
    got = hk.lae_weights(X, U, idx)
    torch.cuda.synchronize()
    ref = lae_weights_plain(X, U, idx)
    _allclose(f"lae_weights {label}", got, ref, 0.0, 2e-4)
    if float(torch.max(torch.abs(got.sum(1) - 1.0))) > 1e-5 or float(got.min()) < 0.0:
        _fail(f"lae_weights {label}: rows off the simplex")
    ms = cuda_ms(lambda: hk.lae_weights(X, U, idx), reps)
    fused = hk._lae_weights(X, U, idx, 150, fused=True)
    fused_ms = cuda_ms(lambda: hk._lae_weights(X, U, idx, 150, fused=True), reps)
    dw, dr = lae_differences(U, idx, fused, ref)
    ew, er = lae_differences(U, idx, got, ref)
    off = float(torch.max(torch.abs(fused.sum(1) - 1.0)))
    print(f"  {label:5s} lae_weights variants (n={X.shape[0]}): exact {ms:.4f} ms, max abs diff "
          f"from plain {ew:.3e} (weights) {er:.3e} (reconstructions zᵀU); fused {fused_ms:.4f} ms, "
          f"{dw:.3e} (weights; the gate would be 2e-4) {dr:.3e} (reconstructions), rows off the "
          f"simplex by at most {off:.3e}", flush=True)
    results.setdefault("lae_fused", {})[key] = dict(ms=fused_ms, dw=dw, dr=dr)
    return got, ref, ms


def fused_over_draws(X, s: int, r: int, draws: int = 6) -> None:
    """How far the fused variant's weights lie from the plain version's on
    further anchor draws from the same cloud (reported only)."""
    worst = []
    for seed in range(draws):
        g = torch.Generator(device=X.device).manual_seed(100 + seed)
        U = X[torch.randperm(X.shape[0], generator=g, device=X.device)[:s]].contiguous()
        idx = knn_plain(X, U, r).indices
        worst.append(_maxabs(hk._lae_weights(X, U, idx, 150, fused=True),
                             lae_weights_plain(X, U, idx)))
    print(f"        lae_weights fused variant, {draws} more anchor draws (n={X.shape[0]}, s={s}): "
          f"max abs diff of the weights from plain " + ", ".join(f"{w:.3e}" for w in worst),
          flush=True)


def check_knn(label: str, X, U, r: int):
    """K1 against its plain version on the same inputs: rows may differ on
    near-ties only, and none may at d = 2, where the kernel's d² is the
    plain version's bit for bit; d² within 1e-5."""
    n = X.shape[0]
    got = hk.knn(X, U, r)
    torch.cuda.synchronize()
    ref = knn_plain(X, U, r)
    differ = torch.any(got.indices != ref.indices, dim=1)
    n_differ = int(differ.sum())
    # a differing row must be a near-tie: same sorted d² within 1e-5·(|x|²+|u|²)
    x2 = torch.sum(X * X, dim=1)
    u2max = float(torch.max(torch.sum(U * U, dim=1)))
    gap = torch.abs(got.sqdists[differ] - ref.sqdists[differ])
    n_far = int(torch.sum(torch.any(gap > 1e-5 * (x2[differ][:, None] + u2max), dim=1)))
    print(f"  {label:5s} knn r={r}: {n_differ} of {n} rows differ, {n_far} of them "
          f"not near-ties", flush=True)
    if X.shape[1] == 2 and n_differ:
        _fail(f"knn r={r} {label}: indices differ on {n_differ} of {n} rows at d = 2")
    if n_differ > 1e-4 * n:
        _fail(f"knn r={r} {label}: indices differ on {n_differ} of {n} rows (> 0.01%)")
    if n_far:
        _fail(f"knn r={r} {label}: {n_far} differing rows are not near-ties")
    _allclose(f"knn d² r={r} {label}", got.sqdists, ref.sqdists, 1e-5, 1e-5)
    return got, ref


def check_knn_chunk(dev, results: dict) -> None:
    """K1 at the launch shape of the n=1e7 path: one 65,536-point chunk of
    the torus cloud against s = 1024 anchors, r = 3 (the graph) and r = 1
    (the cluster sizes), 153 launches each in that fit."""
    cfg = SHAPES["huge"]
    n, s = cfg["chunk"], cfg["s"]
    ds = torus_rings(n=n + cfg["m"], m_train=cfg["m"], seed=cfg["seed"])
    X = torch.as_tensor(ds.x_test, dtype=torch.float32, device=dev).contiguous()
    g = torch.Generator(device=dev).manual_seed(17)
    U = X[torch.randperm(n, generator=g, device=dev)[:s]].contiguous()
    ent = results["knn"]
    for r in (cfg["r"], 1):
        got, ref = check_knn("chunk", X, U, r)
        ms = cuda_ms(lambda: hk.knn(X, U, r), 50)
        plain_ms = cuda_ms(lambda: knn_plain(X, U, r), 5)
        w = work("knn", n=n, r=r, s=s, d=X.shape[1])
        ent["max_abs_err"] = max(ent["max_abs_err"], _maxabs(got.sqdists, ref.sqdists))
        ent.update({f"ms_chunk_r{r}": ms, f"plain_ms_chunk_r{r}": plain_ms, f"work_chunk_r{r}": w})
        print(f"  chunk knn r={r} (n={n}, s={s}, d={X.shape[1]}): kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.4f} ms  bound {bound(w)[0]:.4f} ms ({bound(w)[1]})", flush=True)
    check_lae_chunk(X, U, cfg["r"], results)


def check_lae_chunk(X, U, r: int, results: dict) -> None:
    """K2's point-major entry at the same chunk shape (65,536 points, s =
    1024, d = 2, r = 3): what one launch of the per-chunk composition costs,
    which the n=1e7 path made 153 times before it took the feature-major
    entry once."""
    n, s = X.shape[0], U.shape[0]
    idx = knn_plain(X, U, r).indices
    got, ref, ms = check_lae("chunk", X, U, idx, 50, results, "chunk")
    plain_ms = cuda_ms(lambda: lae_weights_plain(X, U, idx), 3)
    w = work("lae_weights", n=n, r=r, s=s, d=X.shape[1])
    ent = results["lae_weights"]
    ent["max_abs_err"] = max(ent["max_abs_err"], _maxabs(got, ref))
    ent.update(ms_chunk=ms, plain_ms_chunk=plain_ms, work_chunk=w)
    print(f"  chunk lae_weights (n={n}, s={s}, d={X.shape[1]}, r={r}): kernel {ms:9.4f} ms  plain "
          f"{plain_ms:9.4f} ms  bound {bound(w)[0]:.4f} ms ({bound(w)[1]})  max_abs_err "
          f"{_maxabs(got, ref):.3e}", flush=True)


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

    d = X.shape[1]

    def record(name, err, ms, plain_ms, library_ms=None):
        ent = results.setdefault(name, dict(max_abs_err=0.0))
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        ent[f"ms_{label}"], ent[f"plain_ms_{label}"] = ms, plain_ms
        ent[f"library_ms_{label}"] = library_ms
        ent[f"work_{label}"] = work(name, n=n, r=r, s=s, K=K, d=d)
        b_ms, b_by = bound(ent[f"work_{label}"])
        lib = "" if library_ms is None else f"  library {library_ms:9.4f} ms"
        rows.append(f"  {label:5s} {name:16s} kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
                    f"bound {b_ms:.4f} ms ({b_by}){lib}  max_abs_err {err:.3e}")

    # K1 at the graph's r and at k-means‖'s r = 1 over the candidate set
    for rr, UU in ((r, U), (1, Uc)):
        got, ref = check_knn(label, X, UU, rr)
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
    got, ref, ms = check_lae(label, X, U, idx, reps_k, results, label)
    if label == "large":
        fused_over_draws(X, s, r)
    record("lae_weights", _maxabs(got, ref), ms,
           cuda_ms(lambda: lae_weights_plain(X, U, idx), reps_p))
    w = ref

    # K3: exact sums, so held to the float64 plain version, to its own
    # arithmetic (_colsum_fixed_plain) bit for bit and to itself from launch
    # to launch
    got = hk.ell_colsum(w, idx, s)
    torch.cuda.synchronize()
    ref = hk.ell_colsum_plain(w.double(), idx, s)
    err = _maxabs(got, ref)
    if err > 1e-5 * float(torch.max(torch.abs(ref))):
        _fail(f"ell_colsum {label}: max abs err {err:.3e} > 1e-5·max|C| (f64 plain)")
    if not torch.equal(got, hk._colsum_fixed_plain(w, idx, s)):
        _fail(f"ell_colsum {label}: C is not _colsum_fixed_plain's bit for bit")
    if not same_bits(lambda: hk.ell_colsum(w, idx, s), got):
        _fail(f"ell_colsum {label}: C changed bits over five launches")
    flat_i, flat_w = idx.reshape(-1).long(), w.reshape(-1)
    record("ell_colsum", err, cuda_ms(lambda: hk.ell_colsum(w, idx, s), reps_k),
           cuda_ms(lambda: hk.ell_colsum_plain(w, idx, s), reps_p),
           cuda_ms(lambda: w.new_zeros((s,)).index_add_(0, flat_i, flat_w), reps_k))
    rows.append(f"  {label:5s} ell_colsum: max|C| {float(ref.max()):.4g}, equal to "
                f"_colsum_fixed_plain bit for bit, the same bits over five launches")

    # K4, with the cluster-normalized column scale of the main path
    counts = torch.bincount(idx[:, 0].long(), minlength=s).to(torch.float32)
    cscale = (1.0 / (got + EPS) * counts).contiguous()
    G, D, stats = hk._ell_norm_gram(w, idx, cscale, EPS, table_slots=0)
    torch.cuda.synchronize()
    kept, spilled = (int(x) for x in stats)
    Gp, Dp = hk.ell_norm_gram_plain(w.double(), idx, cscale.double())
    for nm, a, b in (("G", G, Gp), ("D", D, Dp)):
        if _maxabs(a, b) > 1e-5 * float(torch.max(torch.abs(b))):
            _fail(f"ell_norm_gram {nm} {label}: max abs err {_maxabs(a, b):.3e} "
                  f"> 1e-5·max|{nm}| (f64 plain)")
    if not same_bits(lambda: hk.ell_norm_gram(w, idx, cscale), (G, D)):
        _fail(f"ell_norm_gram {label}: Ĝ or D changed bits over five launches")
    Zn = hk._normalized(w, idx, cscale, EPS).values
    lib_ms, lib_note = gram_library(Zn, idx, s, Gp, reps_k)
    del Zn
    record("ell_norm_gram", max(_maxabs(G, Gp), _maxabs(D, Dp)),
           cuda_ms(lambda: hk.ell_norm_gram(w, idx, cscale), reps_k),
           cuda_ms(lambda: hk.ell_norm_gram_plain(w, idx, cscale), reps_p), lib_ms)
    rows.append(f"  {label:5s} ell_norm_gram: {kept} of {kept + spilled} pair additions "
                f"({kept / max(kept + spilled, 1):.6f}) stayed in shared memory, {spilled} went "
                f"to the global cells; max|Ĝ| {float(Gp.abs().max()):.4g}, max|D| "
                f"{float(Dp.abs().max()):.4g} (half an ulp of float32 there: "
                f"{float(torch.finfo(torch.float32).eps) * float(Dp.abs().max()) / 2:.3e}); Ĝ and D "
                f"the same bits over five launches; {lib_note}")
    del Gp, Dp

    # K5
    W = torch.randn((s, K), generator=g, device=dev, dtype=torch.float32)
    got = hk.ell_norm_matmat(w, idx, cscale, W)
    torch.cuda.synchronize()
    ref = hk.ell_norm_matmat_plain(w, idx, cscale, W)
    _allclose(f"ell_norm_matmat {label}", got, ref, 1e-5, 1e-5)
    csr = ell_to_csr(hk._normalized(w, idx, cscale, EPS).values, idx, s)
    lib_err = _maxabs(torch.sparse.mm(csr, W), ref)
    record("ell_norm_matmat", _maxabs(got, ref),
           cuda_ms(lambda: hk.ell_norm_matmat(w, idx, cscale, W), reps_k),
           cuda_ms(lambda: hk.ell_norm_matmat_plain(w, idx, cscale, W), reps_p),
           cuda_ms(lambda: torch.sparse.mm(csr, W), reps_k))
    rows.append(f"  {label:5s} torch.sparse.mm (CSR of the normalized graph) vs plain: "
                f"max abs diff {lib_err:.3e}")
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
    del res
    same_anchors_fits(X_all, ds, big_cfg, dev)


def same_anchors_fits(X_all, ds, cfg, dev) -> None:
    """Whether the learned t at n=1e6 is a deterministic function of the
    anchors: the port's subsampler twice from one seed (are the anchors
    themselves the same?), then two fits on the first draw's anchors from
    one generator seed, and two ``spectrum_fused`` calls on that draw's
    graph.  Fails if the two spectra differ in any bit; t is reported."""
    g = cfg.graph
    subs = [subsample(torch.Generator(device=dev).manual_seed(2), X_all, g.s, g.subsample,
                      g.nstart, g.kmeans_iters) for _ in range(2)]
    anchors_same = all(torch.equal(a, b) for a, b in zip(subs[0], subs[1]))
    sub = subs[0]
    fits = [ft.fit_lae_logit_gp(torch.Generator(device=dev).manual_seed(5), ds.x_train, ds.y_train,
                                ds.x_test, cfg=cfg, anchors=(sub.centers, sub.counts), device=dev)
            for _ in range(2)]
    idx = knn(X_all, sub.centers, g.r).indices
    w = lae_weights(X_all, sub.centers, idx)
    spectra, tail_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spectra.append(spectrum_fused(w, idx, g.s, g.resolved_K(), g.gl, g.root, sub.counts))
        torch.cuda.synchronize()
        tail_s.append(time.perf_counter() - t0)
    same = torch.equal(spectra[0].values, spectra[1].values) and torch.equal(
        spectra[0].vectors, spectra[1].vectors)
    fit_same = torch.equal(fits[0].eigenpair.values, fits[1].eigenpair.values) and torch.equal(
        fits[0].eigenpair.vectors, fits[1].eigenpair.vectors)
    errs = [float(np.mean(f.y_test != ds.y_test)) for f in fits]
    ts = [float(f.pars["t"]) for f in fits]
    print(f"n=1e6, two fits on one anchor set from one generator seed: t {ts[0]!r} and {ts[1]!r} "
          f"({'equal' if ts[0] == ts[1] else 'differ'}), err {errs[0]:.6f} and {errs[1]:.6f}, "
          f"the fits' spectra {'identical' if fit_same else 'differ'}, posterior means "
          f"{'identical' if np.array_equal(fits[0].posterior_mean, fits[1].posterior_mean) else 'differ'}; "
          f"two spectrum_fused calls on that graph (K3, K4, eigh, K5: {tail_s[0]:.4f} s, "
          f"{tail_s[1]:.4f} s): eigenvalues and vectors {'identical' if same else 'differ'} (max "
          f"abs diff of the eigenvalues {_maxabs(spectra[0].values, spectra[1].values):.3e}); "
          f"the subsampler twice from one seed: anchors {'identical' if anchors_same else 'differ'} "
          f"(max abs diff of the centers {_maxabs(subs[0].centers, subs[1].centers):.3e})",
          flush=True)
    if not (same and fit_same):
        _fail("n=1e6: two spectra of one graph differ")
    if max(errs) > ERR_GATE:
        _fail(f"n=1e6 test error {max(errs)} > {ERR_GATE} (fits on one anchor set)")


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


def check_lae_t(Xt, U, idx, w, results: dict) -> None:
    """K2's feature-major entry, one launch over the whole chunked cloud
    (``w`` is what it gave ``build_graph_colmajor``), against its plain
    version, held to 2e-4, the simplex and exact zeros on the pads; beside
    it the fused variant (reported only) and the per-chunk composition the
    entry replaced: a row-major copy of the chunk's columns, a launch of the
    point-major entry and a transpose of its weights, for every chunk."""
    n = Xt.shape[1]
    nch, r, c = idx.shape
    ref = hk.lae_weights_t_plain(Xt, U, idx)
    _allclose("lae_weights_t", w, ref, 0.0, 2e-4)
    flat, flat_ref = col.point_major(w, n), col.point_major(ref, n)
    if float(torch.max(torch.abs(flat.sum(1) - 1.0))) > 1e-5 or float(flat.min()) < 0.0:
        _fail("lae_weights_t: rows off the simplex")
    ms = cuda_ms(lambda: hk.lae_weights_t(Xt, U, idx), 10)
    fused = hk._lae_weights_t(Xt, U, idx, 150, fused=True)
    fused_ms = cuda_ms(lambda: hk._lae_weights_t(Xt, U, idx, 150, fused=True), 10)
    if float(torch.max(torch.abs(col.point_major(fused, nch * c)[n:]))) != 0.0:
        _fail("lae_weights_t (fused): a nonzero weight on a pad point")
    flat_idx = col.point_major(idx, n)
    ew, er = lae_differences(U, flat_idx, flat, flat_ref)
    dw, dr = lae_differences(U, flat_idx, col.point_major(fused, n), flat_ref)
    del fused, ref, flat_ref

    def per_chunk():
        out = torch.zeros_like(w)
        for i in range(nch):
            lo, hi = i * c, min((i + 1) * c, n)
            wc = hk.lae_weights(Xt[:, lo:hi].T.contiguous(), U,
                                idx[i, :, :hi - lo].T.contiguous())
            out[i, :, :hi - lo] = wc.T
        return out

    if not torch.equal(per_chunk(), w):
        _fail("lae_weights_t differs from the point-major entry run chunk by chunk")
    chunks_ms = cuda_ms(per_chunk, 3)
    wk = work("lae_weights", n=n, r=r, s=U.shape[0], d=Xt.shape[0])
    ent = results["lae_weights"]
    ent["max_abs_err"] = max(ent["max_abs_err"], ew)
    ent.update(ms_huge=ms, work_huge=wk, ms_huge_chunks=chunks_ms)
    results["lae_fused"]["huge"] = dict(ms=fused_ms, dw=dw, dr=dr)
    print(f"lae_weights_t, one launch over n={n} ({nch} chunks of {c}, d={Xt.shape[0]}, r={r}): "
          f"kernel {ms:.4f} ms  bound {bound(wk)[0]:.4f} ms ({bound(wk)[1]})  max abs diff from "
          f"plain {ew:.3e} (weights) {er:.3e} (reconstructions zᵀU); the per-chunk composition it "
          f"replaced ({nch} copies, launches and transposes) {chunks_ms:.4f} ms, equal bit for "
          f"bit; fused variant {fused_ms:.4f} ms, {dw:.3e} (weights; the gate would be 2e-4) "
          f"{dr:.3e} (reconstructions)", flush=True)


def check_kernels_t(Xt7, dev, results: dict) -> None:
    """K2's feature-major entry and K6–K8 against their plain versions at the
    n=1e7 chunked shape, on a graph from K1 + K2 over the torus cloud; then
    the chunked spectrum against the point-major one on an n=1e6 graph."""
    cfg = SHAPES["huge"]
    n, s, r, K, chunk = Xt7.shape[1], cfg["s"], cfg["r"], cfg["K"], cfg["chunk"]
    U = random_anchors(Xt7, s, dev, seed=7)
    idx, w = col.build_graph_colmajor(Xt7, U, r, chunk=chunk)
    nch, _, c = w.shape
    n_pad = nch * c - n
    if float(torch.max(torch.abs(col.point_major(w, nch * c)[n:]))) != 0.0:
        _fail("build_graph_colmajor left a nonzero weight on a pad point")
    check_lae_t(Xt7, U, idx, w, results)
    counts = torch.bincount(col.point_major(idx, n)[:, 0].long(), minlength=s).to(torch.float32)
    rows = [f"kernels vs plain, chunked shape (nch={nch}, r={r}, c={c}, s={s}, K={K}; "
            f"{n_pad} pad points), ms per call:"]

    def record(name, err, ms, plain_ms, note="", library_ms=None):
        results[name] = dict(max_abs_err=err, ms_huge=ms, plain_ms_huge=plain_ms,
                             library_ms_huge=library_ms,
                             work_huge=work(name, n=nch * c, r=r, s=s, K=K))
        b_ms, b_by = bound(results[name]["work_huge"])
        lib = "" if library_ms is None else f"  library {library_ms:9.4f} ms"
        rows.append(f"  huge  {name:18s} kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
                    f"bound {b_ms:.4f} ms ({b_by}){lib}  max_abs_err {err:.3e}{note}")

    # K6 and K7 sum 3.1e7 and 9.2e7 terms exactly (fixed point); the float32
    # plain versions (index_add_) are float atomic sums, whose own rounding
    # nears the 1e-5·max gate at this length.  So both kernels are held
    # against the plain versions run in float64 on the same inputs, the
    # float32 plain versions' own error printed beside them, K6 to
    # _colsum_fixed_plain bit for bit, and both to themselves over five
    # launches.
    w64 = w.double()

    got = hk.ell_colsum_t(w, idx, s)
    torch.cuda.synchronize()
    ref = hk.ell_colsum_t_plain(w64, idx, s)
    err, err32 = _maxabs(got, ref), _maxabs(hk.ell_colsum_t_plain(w, idx, s), ref)
    if err > 1e-5 * float(torch.max(torch.abs(ref))):
        _fail(f"ell_colsum_t: max abs err {err:.3e} > 1e-5·max|C| (f64 plain)")
    if not torch.equal(got, hk._colsum_fixed_plain(w, idx, s)):
        _fail("ell_colsum_t: C is not _colsum_fixed_plain's bit for bit")
    if not same_bits(lambda: hk.ell_colsum_t(w, idx, s), got):
        _fail("ell_colsum_t: C changed bits over five launches")
    flat_i, flat_w = idx.reshape(-1).long(), w.reshape(-1)
    record("ell_colsum_t", err, cuda_ms(lambda: hk.ell_colsum_t(w, idx, s), 10),
           cuda_ms(lambda: hk.ell_colsum_t_plain(w, idx, s), 3),
           f"  (f32 plain {err32:.3e}, of max|C| {float(torch.max(ref)):.4g}; equal to "
           f"_colsum_fixed_plain bit for bit, the same bits over five launches)",
           library_ms=cuda_ms(lambda: w.new_zeros((s,)).index_add_(0, flat_i, flat_w), 10))
    del flat_i, flat_w
    cscale = (1.0 / (got + EPS) * counts).contiguous()

    G, D, stats = hk._ell_norm_gram_t(w, idx, cscale, EPS, table_slots=0)
    torch.cuda.synchronize()
    kept, spilled = (int(x) for x in stats)
    Gp, Dp = hk.ell_norm_gram_t_plain(w64, idx, cscale.double())
    for nm, a, b in (("G", G, Gp), ("D", D, Dp)):
        if _maxabs(a, b) > 1e-5 * float(torch.max(torch.abs(b))):
            _fail(f"ell_norm_gram_t {nm}: max abs err {_maxabs(a, b):.3e} > 1e-5·max|{nm}| "
                  f"(f64 plain)")
    if not same_bits(lambda: hk.ell_norm_gram_t(w, idx, cscale), (G, D)):
        _fail("ell_norm_gram_t: Ĝ or D changed bits over five launches")
    G32, D32 = hk.ell_norm_gram_t_plain(w, idx, cscale)
    err32 = max(_maxabs(G32, Gp), _maxabs(D32, Dp))
    del G32, D32
    lib_ms, lib_note = gram_library(col.point_major(hk._normalized_t(w, idx, cscale, EPS), nch * c),
                                    col.point_major(idx, nch * c), s, Gp, 3)
    record("ell_norm_gram_t", max(_maxabs(G, Gp), _maxabs(D, Dp)),
           cuda_ms(lambda: hk.ell_norm_gram_t(w, idx, cscale), 10),
           cuda_ms(lambda: hk.ell_norm_gram_t_plain(w, idx, cscale), 3),
           f"  (f32 plain {err32:.3e}, of max|G| {float(torch.max(torch.abs(Gp))):.4g}, max|D| "
           f"{float(torch.max(torch.abs(Dp))):.4g}; the same bits over five launches; "
           f"{lib_note})", library_ms=lib_ms)
    # the same kernel with a table of two slots: nearly every pair a global atomic
    G2, D2, stats2 = hk._ell_norm_gram_t(w, idx, cscale, EPS, table_slots=2)
    if not (torch.equal(G2, G) and torch.equal(D2, D)):
        _fail("ell_norm_gram_t: a two-slot table changed the bits of Ĝ or D")
    rows.append(f"  huge  ell_norm_gram_t: {kept} of {kept + spilled} pair additions "
                f"({kept / max(kept + spilled, 1):.6f}) stayed in shared memory, "
                f"{int(torch.count_nonzero(Gp))} of {s * s} cells of G nonzero; with a table of "
                f"two slots ({int(stats2[0])} kept) "
                f"{cuda_ms(lambda: hk._ell_norm_gram_t(w, idx, cscale, EPS, 2), 5):9.4f} ms")
    del Gp, Dp, G2, D2, w64

    g = torch.Generator(device=dev).manual_seed(8)
    W = torch.randn((s, K), generator=g, device=dev, dtype=torch.float32)
    got = hk.ell_norm_matmat_t(w, idx, cscale, W)
    torch.cuda.synchronize()
    ref = hk.ell_norm_matmat_t_plain(w, idx, cscale, W)
    _allclose("ell_norm_matmat_t", got, ref, 1e-5, 1e-5)
    if float(torch.max(torch.abs(got[n:]))) != 0.0:
        _fail("ell_norm_matmat_t: a pad row is not zero")
    err = _maxabs(got, ref)
    del got
    csr = ell_to_csr(col.point_major(hk._normalized_t(w, idx, cscale, EPS), nch * c),
                     col.point_major(idx, nch * c), s)
    lib_err = _maxabs(torch.sparse.mm(csr, W), ref)
    del ref
    record("ell_norm_matmat_t", err, cuda_ms(lambda: hk.ell_norm_matmat_t(w, idx, cscale, W), 10),
           cuda_ms(lambda: hk.ell_norm_matmat_t_plain(w, idx, cscale, W), 3),
           f"  (torch.sparse.mm vs plain: max abs diff {lib_err:.3e})",
           library_ms=cuda_ms(lambda: torch.sparse.mm(csr, W), 10))
    del idx, w, csr
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
    if launches["lae_weights"] != 1:
        _fail(f"the n=1e7 fit launched lae_weights {launches['lae_weights']} times, not once")
    return launches


def check_self_knn(X: torch.Tensor, r: int, results: dict):
    """K1 as the GLGP graph calls it, anchors = the points themselves (s = n),
    against its plain version: rows may differ only on near-ties, d² within
    1e-5, and each point's nearest neighbour is the point itself at d² ≈ 0
    unless another point lies within the expanded form's rounding of it."""
    n, d = X.shape
    got = hk.knn(X, X, r)
    torch.cuda.synchronize()
    ref = knn_plain(X, X, r)
    x2 = torch.sum(X * X, dim=1)
    differ = torch.any(got.indices != ref.indices, dim=1)
    gap = torch.abs(got.sqdists[differ] - ref.sqdists[differ])
    n_far = int(torch.sum(torch.any(gap > 2e-5 * x2.max(), dim=1)))
    me = torch.arange(n, device=X.device, dtype=got.indices.dtype)
    not_self = got.indices[:, 0] != me
    # a point that is not its own nearest neighbour must sit in its own list
    # at a d² within rounding of the first (a twin closer than f32 resolves)
    twin_ok = torch.any(got.indices[not_self] == me[not_self, None], dim=1) & (
        got.sqdists[not_self, min(1, r - 1)] <= 2e-5 * x2[not_self])
    ms = cuda_ms(lambda: hk.knn(X, X, r), 5)
    plain_ms = cuda_ms(lambda: knn_plain(X, X, r), 2)
    ent = results["knn"]
    ent["max_abs_err"] = max(ent["max_abs_err"], _maxabs(got.sqdists, ref.sqdists))
    ent.update(ms_lobpcg=ms, plain_ms_lobpcg=plain_ms,
               work_lobpcg=work("knn", n=n, r=r, s=n, d=d))
    print(f"self-kNN (K1, s = n = {n}, d = {d}, r = {r}) vs plain: {int(differ.sum())} rows "
          f"differ (largest d² gap on them {float(gap.max()) if gap.numel() else 0.0:.3e}), "
          f"{n_far} of them not near-ties; {int(not_self.sum())} points are not their "
          f"own nearest neighbour; self d² in [{float(got.sqdists[:, 0].min()):.3e}, "
          f"{float(got.sqdists[:, 0].max()):.3e}]; max_abs_err "
          f"{_maxabs(got.sqdists, ref.sqdists):.3e}; kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
          f"bound {bound(ent['work_lobpcg'])[0]:.4f} ms ({bound(ent['work_lobpcg'])[1]})",
          flush=True)
    # 1e10 pairs at d = 3: the kernel's fmaf chain and the plain version's
    # matmul round x·u differently, so more rows than at s = 1024 swap two
    # neighbours whose d² agree to the last bits; up to 0.1% may, near-ties all
    if int(differ.sum()) > 1e-3 * n or n_far:
        _fail(f"self-kNN: {int(differ.sum())} of {n} rows differ, {n_far} not near-ties")
    _allclose("self-kNN d²", got.sqdists, ref.sqdists, 1e-5, 1e-5)
    if int(not_self.sum()) > 1e-4 * n or not bool(torch.all(twin_ok)):
        _fail(f"self-kNN: {int(not_self.sum())} points are not their own nearest neighbour")
    if float(torch.max(torch.abs(got.sqdists[:, 0]))) > 2e-5 * float(x2.max()):
        _fail("self-kNN: a point's distance to itself is not ≈ 0")


def gaussian_graph(dev, seed: int, results=None):
    """The doubly-normalized sparse GLGP operator of a Gaussian cloud at the
    LOBPCG shape: self-kNN (K1), weights exp(−d²/d̄), glgp_operator.  With
    ``results``, the self-kNN is first held against its plain version."""
    n, d, r = LOBPCG["n"], LOBPCG["d"], LOBPCG["r"]
    X = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(seed), device=dev,
                    dtype=torch.float32)
    if results is not None:
        check_self_knn(X, r, results)
    res = knn(X, X, r)
    vals = torch.exp(-res.sqdists / torch.mean(res.sqdists))
    return glgp_operator(symmetrize_knn(res.indices, vals, n))[0]


def sym_csr(op) -> torch.Tensor:
    """Z + Zᵀ of a SymCoo as one coalesced CSR matrix: what the yardstick
    ``torch.sparse.mm`` multiplies."""
    coo = torch.sparse_coo_tensor(torch.stack([op.rows.long(), op.cols.long()]), op.vals,
                                  size=(op.n, op.n)).coalesce()
    return coo.to_sparse_csr()


def check_ell_sym_matmat(dev, g, cases: dict, results: dict) -> None:
    """``ell_sym_matmat`` against its plain version on the operators of
    phase 8, on the arrays ``SymCoo.matvec`` hands it (mutual edges folded
    into the forward weights, the rest of the transpose as CSR), with the
    structure's build time apart and, as yardsticks only, ``torch.sparse.mm``
    on the symmetrized CSR and the composition the kernel replaced (K9,
    ``rmatmat``'s ``index_add_`` and an add)."""
    rows = ["ell_sym_matmat vs plain, ms per call:"]
    ent = results.setdefault("ell_sym_matmat", dict(max_abs_err=0.0))
    for label, (op, K) in cases.items():
        n, r = op.values.shape
        idx = op.indices.contiguous()
        Z = EllMatrix(op.values, idx, n)
        build_ms = []           # the first call also loads torch's sort kernels
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            structure = sym_structure(idx, n)
            torch.cuda.synchronize()
            build_ms.append(1e3 * (time.perf_counter() - t0))
        op = SymCoo(idx, op.values, n, structure)
        vals, tr, vt = op.kernel_arrays()
        kept = int(tr.ptr[-1])
        X = torch.randn((n, K), generator=g, device=dev, dtype=torch.float32)
        got = hk.ell_sym_matmat(vals, idx, tr.ptr, tr.src, vt, X)
        torch.cuda.synchronize()
        ref = hk.ell_sym_matmat_plain(vals, idx, tr.ptr, tr.src, vt, X)
        # the kernel sums a row's terms in one chain, the plain version in
        # two halves (one of them with atomics): 1e-5 relative + absolute;
        # the same against the operator's plain composition, nothing folded
        _allclose(f"ell_sym_matmat {label}", got, ref, 1e-5, 1e-5)
        _allclose(f"ell_sym_matmat {label} vs gather + scatter-add", got,
                  Z.matmat_plain(X) + Z.rmatmat(X), 1e-5, 1e-5)
        _allclose(f"SymCoo.matvec {label}", op.matvec(X), got, 0.0, 0.0)
        err = _maxabs(got, ref)
        csr = sym_csr(op)
        lib_err = _maxabs(torch.sparse.mm(csr, X), ref)
        del got, ref
        ms = cuda_ms(lambda: hk.ell_sym_matmat(vals, idx, tr.ptr, tr.src, vt, X), 20)
        plain_ms = cuda_ms(lambda: hk.ell_sym_matmat_plain(vals, idx, tr.ptr, tr.src, vt, X), 3)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, X), 10)
        old_ms = cuda_ms(lambda: Z.matmat(X) + Z.rmatmat(X), 5)

        # the per-operator preparation of the kernel's values
        vt_ms = cuda_ms(lambda: SymCoo(idx, op.values, n, structure).kernel_arrays(), 20)
        w = work("ell_sym_matmat", n=n, r=r, s=n, K=K, distinct=kept)
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        ent.update({f"ms_{label}": ms, f"plain_ms_{label}": plain_ms,
                    f"library_ms_{label}": lib_ms, f"work_{label}": w})
        rows.append(f"  {label:8s} (n={n}, r={r}, K={K}; {n * r - kept} of {n * r} edges mutual, "
                    f"{kept} transposed entries kept) kernel {ms:9.4f} ms  plain {plain_ms:9.4f} "
                    f"ms  torch.sparse.mm (symmetrized CSR, coalesced: {csr.values().numel()} "
                    f"entries for the kernel's {n * r + kept}) {lib_ms:9.4f} ms  bound "
                    f"{bound(w)[0]:.4f} ms ({bound(w)[1]})  the composition it replaced (K9 + "
                    f"rmatmat + add) {old_ms:9.4f} ms  max_abs_err {err:.3e}  sparse.mm vs plain "
                    f"{lib_err:.3e}; transpose structure, once per graph: {build_ms[0]:.3f} ms "
                    f"the first call, {build_ms[1]:.3f} ms the second (host clock), values "
                    f"folded and permuted once per operator: {vt_ms:.4f} ms")
        del csr, X
    print("\n".join(rows), flush=True)


def check_ell_matmat(dev, results: dict):
    """Phase 8: the self-kNN (K1) that builds the LOBPCG-shape graph against
    its plain version, then K9 against its plain version, with the library
    call and the operator's transposed half beside it, then the symmetric
    operator product.  The first K9 shape is the one the SE torus fit
    launches it at (``se_spectrum_at`` -> ``spectrum_from_Z``); no fit
    launches it at the others.  Returns the LOBPCG-shape operator and a
    torus-GLGP-shaped one (n = 4800, r = 48)."""
    g = torch.Generator(device=dev).manual_seed(11)
    op = gaussian_graph(dev, seed=12, results=results)
    big = SHAPES["large"]
    ds = torus_rings(n=big["n"], m_train=big["m"], seed=big["seed"])
    X6 = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32, device=dev)
    U6 = X6[torch.randperm(X6.shape[0], generator=g, device=dev)[:big["s"]]].contiguous()
    res6 = hk.knn(X6, U6, big["r"])
    tor = SHAPES["torus"]
    dt = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    Xs = torch.as_tensor(np.concatenate([dt.x_train, dt.x_test]), dtype=torch.float32, device=dev)
    Us = Xs[torch.randperm(Xs.shape[0], generator=g, device=dev)[:tor["s"]]].contiguous()
    res_s = hk.knn(Xs, Us, tor["r"])
    Xt = torch.randn((tor["n"], 2), generator=g, device=dev, dtype=torch.float32)
    rest = knn_plain(Xt, Xt, 48)
    op_t = glgp_operator(symmetrize_knn(
        rest.indices, torch.exp(-rest.sqdists / torch.mean(rest.sqdists)), tor["n"]))[0]
    cases = {   # label: (values, indices, s, K)
        "se-torus": (torch.exp(-res_s.sqdists / torch.mean(res_s.sqdists)), res_s.indices,
                     tor["s"], tor["K"]),
        "lobpcg": (op.values.contiguous(), op.indices.contiguous(), LOBPCG["n"], 3 * LOBPCG["K"]),
        "large": (torch.exp(-res6.sqdists / torch.mean(res6.sqdists)), res6.indices, big["s"],
                  big["K"]),
        "gl-torus": (op_t.values.contiguous(), op_t.indices.contiguous(), tor["n"], 3 * tor["K"]),
    }
    rows = ["ell_matmat (K9) vs plain, ms per call:"]
    ent = results.setdefault("ell_matmat", dict(max_abs_err=0.0))
    for label, (vals, idx, s, K) in cases.items():
        n, r = vals.shape
        W = torch.randn((s, K), generator=g, device=dev, dtype=torch.float32)
        got = hk.ell_matmat(vals, idx, W)
        torch.cuda.synchronize()
        ref = hk.ell_matmat_plain(vals, idx, W)
        _allclose(f"ell_matmat {label}", got, ref, 1e-5, 1e-5)
        err = _maxabs(got, ref)
        csr = ell_to_csr(vals, idx, s)
        lib_err = _maxabs(torch.sparse.mm(csr, W), ref)
        del got, ref
        Z = EllMatrix(vals, idx, s)
        M = torch.randn((n, K), generator=g, device=dev, dtype=torch.float32)
        ms = cuda_ms(lambda: hk.ell_matmat(vals, idx, W), 20)
        plain_ms = cuda_ms(lambda: hk.ell_matmat_plain(vals, idx, W), 3)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, W), 10)
        t_ms = cuda_ms(lambda: Z.rmatmat(M), 5)
        w = work("ell_matmat", n=n, r=r, s=s, K=K, distinct=int(torch.unique(idx).numel()))
        no_reuse = 1e3 * (8 * n * r + 4 * K * n * r + 4 * n * K) / HBM_BYTES_PER_S
        # the other of K9's two bodies at this shape: the slab kernel where W
        # fits in the L2 (forced), one slab where it does not (no L2 reuse)
        other_ms = cuda_ms(lambda: hk._ell_matmat(vals, idx, W, K), 20)
        _allclose(f"ell_matmat {label}, one slab of {K} columns", hk._ell_matmat(vals, idx, W, K),
                  hk.ell_matmat(vals, idx, W), 0.0, 0.0)
        ent["max_abs_err"] = max(ent["max_abs_err"], err)
        ent.update({f"ms_{label}": ms, f"plain_ms_{label}": plain_ms,
                    f"library_ms_{label}": lib_ms, f"work_{label}": w})
        rows.append(f"  {label:8s} (n={n}, s={s}, r={r}, K={K}) kernel {ms:9.4f} ms  plain "
                    f"{plain_ms:9.4f} ms  torch.sparse.mm {lib_ms:9.4f} ms  bound "
                    f"{bound(w)[0]:.4f} ms ({bound(w)[1]}; {no_reuse:.4f} ms with no reuse of "
                    f"gathered rows)  transposed half (rmatmat, index_add_) {t_ms:9.4f} ms  "
                    f"max_abs_err {err:.3e}  sparse.mm vs plain {lib_err:.3e}; the slab kernel "
                    f"with one slab of {K} columns {other_ms:9.4f} ms")
        del csr, W, M
    print("\n".join(rows), flush=True)
    check_ell_sym_matmat(dev, g, {"lobpcg": (op, 3 * LOBPCG["K"]), "gl-torus": (op_t, 3 * tor["K"])},
                         results)
    return op, op_t


def lobpcg_iteration(dev, op, K: int, label: str) -> None:
    """Device time of the pieces of one LOBPCG iteration on a (n, 3K) search
    block, each timed alone (CUDA events; the host's launch overhead between
    the pieces is not in these numbers)."""
    n = op.n
    g = torch.Generator(device=dev).manual_seed(31)
    S = _chol_qr(torch.randn((n, 3 * K), generator=g, device=dev, dtype=torch.float32))[0]
    AS = op.matvec(S)
    H = S.T @ AS
    H = 0.5 * (H + H.T)
    C = torch.linalg.eigh(H)[1][:, :K].contiguous()
    X = S[:, :K].contiguous()
    parts = {
        "Cholesky-QR (Gram, Cholesky, triangular solve; twice)": lambda: _chol_qr(S),
        "operator (ell_sym_matmat, both halves in one launch)": lambda: op.matvec(S),
        "H = S'AS": lambda: S.T @ AS,
        f"eigh ({3 * K}, {3 * K})": lambda: torch.linalg.eigh(H),
        "X = S C, AX = AS C, P = X - X0 (X0' X)": lambda: (S @ C, AS @ C, X - X @ (X.T @ X)),
    }
    ms = {k: cuda_ms(fn, 5) for k, fn in parts.items()}
    print(f"one LOBPCG iteration, {label} (n={n}, r={op.values.shape[1]}, block {3 * K}), device "
          f"ms: " + "; ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; sum {sum(ms.values()):.3f}", flush=True)


def lobpcg_spectrum(dev, op) -> None:
    """Phase 9: the sparse GLGP spectrum at n = 1e5 through the kernel
    operator (timed from the point cloud on, on a second cloud), and on the
    first cloud against the same solve through the plain operator."""
    n, K, iters = LOBPCG["n"], LOBPCG["K"], LOBPCG["iters"]
    X0 = torch.randn((n, K), generator=torch.Generator(device=dev).manual_seed(21), device=dev,
                     dtype=torch.float32)
    hk.reset_launches()
    got = lobpcg_standard(op.matvec, X0, iters=iters)
    torch.cuda.synchronize()
    n_launch = hk.LAUNCHES["ell_sym_matmat"]
    Z = EllMatrix(op.values, op.indices, n)
    ref = lobpcg_standard(lambda S: Z.matmat_plain(S) + Z.rmatmat(S), X0, iters=iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = lobpcg_standard(gaussian_graph(dev, seed=22).matvec, X0, iters=iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    diff = torch.abs(got.eigenvalues.double() - ref.eigenvalues.double())
    lead = K // 4
    print(f"sparse GLGP spectrum, Gaussian cloud n={n}, r={LOBPCG['r']}, K={K}, {iters} LOBPCG "
          f"iterations, f32: wall {wall:.3f} s (self-kNN, operator and solve; second cloud), "
          f"max residual {float(got.residual_norms.max()):.3e} (timed cloud "
          f"{float(timed.residual_norms.max()):.3e}), leading {lead} residuals at most "
          f"{float(got.residual_norms[:lead].max()):.3e}, ell_sym_matmat launches {n_launch}; "
          f"eigenvalues {float(got.eigenvalues[0]):.6f} .. {float(got.eigenvalues[-1]):.6f}; "
          f"kernel vs plain operator from the same X0: leading {lead} eigenvalues max abs diff "
          f"{float(diff[:lead].max()):.3e}, all {K} {float(diff.max()):.3e}", flush=True)
    if n_launch != iters + 1:
        _fail(f"the LOBPCG solve launched ell_sym_matmat {n_launch} times, expected {iters + 1}")
    for nm, r in (("kernel", got), ("plain", ref), ("timed", timed)):
        if not bool(torch.all(torch.isfinite(r.eigenvalues) & torch.isfinite(r.residual_norms))):
            _fail(f"sparse GLGP spectrum ({nm} operator): non-finite eigenvalues or residuals")
    # The two solves sum a row's terms in different orders (one fmaf chain vs
    # an einsum plus a scatter with float atomics, whose order changes from
    # run to run), so after 60 Rayleigh-Ritz steps only the converged
    # leading pairs must agree: 1e-4 absolute on eigenvalues ≤ 1, a
    # thousand float32 roundings.
    if float(diff[:lead].max()) > 1e-4:
        _fail(f"kernel vs plain operator: leading eigenvalues differ by {float(diff[:lead].max())}")


def entry_fit(name: str, ds, cfg, dev, seed: int, cold_and_warm: bool = True) -> dict:
    """One driver through its entry point, on the card by default (no
    ``device=`` argument), cold then warm; launches are the cold fit's."""
    out = {}
    for label in ("cold", "warm") if cold_and_warm else ("cold",):
        hk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = getattr(ft, name)(torch.Generator(device=dev).manual_seed(seed), ds.x_train,
                                ds.y_train, ds.x_test, cfg=cfg)
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        if label == "cold":
            out["launches"] = {k: v for k, v in hk.LAUNCHES.items() if v}
    n_test = ds.x_test.shape[0]
    for nm in ("y_test", "posterior_mean", "posterior_cov"):
        arr = getattr(res, nm)
        if arr.shape != (n_test,) or not np.all(np.isfinite(arr)):
            _fail(f"{name} {nm}: shape {arr.shape} or non-finite values")
    if res.eigenpair.vectors.device.type != "cuda":
        _fail(f"{name} ran on {res.eigenpair.vectors.device}, not on the card")
    out["res"] = res
    if name.endswith("logit_gp"):
        out["score"] = float(np.mean(res.y_test != ds.y_test))
    else:
        out["score"] = float(np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)))
    return out


def _report_fit(name: str, what: str, f: dict) -> None:
    pars = {k: float(v) if np.ndim(v) == 0 else f"({np.size(v)},)" for k, v in f["res"].pars.items()}
    metrics = "" if f["res"].metrics is None else f"  metrics {f['res'].metrics}"
    warm = f"  warm {f['warm_s']:.3f} s" if "warm_s" in f else ""
    print(f"{name} ({what}): {'err' if name.endswith('logit_gp') else 'rmse'} {f['score']:.6f}  "
          f"cold {f['cold_s']:.3f} s{warm}  pars {pars}{metrics}  launches {f['launches']}",
          flush=True)


def grid_fits(dev) -> dict:
    """Phase 10; returns the ``ell_sym_matmat`` launches of the GLGP
    sparse-LOBPCG fit and the ``ell_matmat`` launches of the SE fit."""
    tor = SHAPES["torus"]
    ds = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    graph = ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"])
    f32 = dict(dtype=torch.float32, solve_dtype=torch.float64)

    gl_cfg = ft.FitConfig(graph=graph, sigma=1e-3, gl_sparse=True, gl_solver="lobpcg", **f32)
    gl = entry_fit("fit_gl_logit_gp", ds, gl_cfg, dev, seed=0)
    _report_fit("fit_gl_logit_gp", "torus, sparse LOBPCG, r=48, 10 bandwidths x 80 iterations", gl)
    resid = gl["res"].metrics["gl_eigensolve_max_residual"]
    if gl["launches"].get("ell_sym_matmat", 0) == 0 or not np.isfinite(resid):
        _fail(f"fit_gl_logit_gp: ell_sym_matmat launches {gl['launches']}, residual {resid}")
    gate = ERR_GATE
    if gl["score"] > ERR_GATE:
        # GLGP on this data is honestly worse than the anchor-graph kernels:
        # hold the card's f32 fit to the port's own float64 plain run
        # (float64 reaches no kernel) on the same card, plus 0.01
        f64 = entry_fit("fit_gl_logit_gp", ds, ft.FitConfig(
            graph=graph, sigma=1e-3, gl_sparse=True, gl_solver="lobpcg", dtype=torch.float64),
            dev, seed=0, cold_and_warm=False)
        _report_fit("fit_gl_logit_gp", "the same in float64, plain versions only", f64)
        gate = f64["score"] + 0.01
    print(f"fit_gl_logit_gp gate: err {gl['score']:.6f} <= {gate:.6f}", flush=True)
    if gl["score"] > gate:
        _fail(f"fit_gl_logit_gp torus test error {gl['score']} > {gate}")

    se = entry_fit("fit_se_logit_gp", ds, ft.FitConfig(graph=graph, sigma=1e-3, **f32), dev, seed=0)
    _report_fit("fit_se_logit_gp", "torus, 10 bandwidths", se)
    if se["score"] > ERR_GATE:
        _fail(f"fit_se_logit_gp torus test error {se['score']} > {ERR_GATE}")
    if se["launches"].get("ell_matmat", 0) == 0:
        _fail(f"fit_se_logit_gp launched no ell_matmat kernel: {se['launches']}")

    sp = spiral(n=SPIRAL["n"], m_train=SPIRAL["m"])
    for name, rmse_gate in RMSE_GATES.items():
        rcond = 1e-3 if "nystrom" in name else 0.0
        cfg = ft.FitConfig(graph=ft.GraphConfig(s=SPIRAL["s"], r=SPIRAL["r"], K=SPIRAL["K"],
                                                nystrom_rcond=rcond), sigma=1e-5, **f32)
        f = entry_fit(name, sp, cfg, dev, seed=0)
        _report_fit(name, "spiral n=4000, m=200", f)
        if not f["score"] <= rmse_gate:
            _fail(f"{name} spiral rmse {f['score']} > {rmse_gate}")
    return {"ell_sym_matmat": gl["launches"]["ell_sym_matmat"],
            "ell_matmat": se["launches"]["ell_matmat"]}


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
    print_sass(lib)

    # 3. kernels vs plain versions
    results: dict = {}
    for label in ("torus", "large"):
        check_kernels(label, SHAPES[label], dev, results)
    check_knn_chunk(dev, results)

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
    torch.cuda.empty_cache()

    # 8. and 9. K9 and the sparse GLGP spectrum it serves
    op, op_torus = check_ell_matmat(dev, results)
    lobpcg_spectrum(dev, op)
    lobpcg_iteration(dev, op, LOBPCG["K"], "Gaussian cloud")
    lobpcg_iteration(dev, op_torus, SHAPES["torus"]["K"], "torus GLGP shape")
    del op, op_torus
    torch.cuda.empty_cache()

    # 10. the bandwidth-grid and regression drivers through their entry points
    launches.update(grid_fits(dev))

    # K1–K5: launches of the torus fit, times at the n=1e6 shape; K6–K8:
    # launches of the first n=1e7 fit, times at the n=1e7 shape; K9: launches
    # of the SE torus fit, times at the shape that fit launches it at;
    # ell_sym_matmat: launches of the sparse-LOBPCG GLGP fit, times at the
    # LOBPCG block's shape
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        shape = ("huge" if name.endswith("_t") else
                 "se-torus" if name == "ell_matmat" else
                 "lobpcg" if name == "ell_sym_matmat" else "large")
        bound_ms, bound_by = bound(r[f"work_{shape}"])
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"],
                            ms=r[f"ms_{shape}"], plain_ms=r[f"plain_ms_{shape}"],
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=r[f"library_ms_{shape}"]))
    ratios = sorted(((k["ms"] / k["bound_ms"], k["name"]) for k in kernels), reverse=True)
    print("kernel ms over bound ms: " + ", ".join(f"{nm} {x:.1f}x" for x, nm in ratios),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sass":
        print_sass(Path(sys.argv[2]))      # K2's step count of any build of the library
    else:
        main()
