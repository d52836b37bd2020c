#!/usr/bin/env python3
"""Smoke test of the PyTorch port (flgp_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --sass build/flgp_tpu_torch/<hash>/libflgp_kernels.so
    python3 chip_smoke.py --subsample-times
    python3 chip_smoke.py --sampling
    python3 chip_smoke.py --streaming

(the second only counts K2's instructions in a library already built; the
third only times the n=1e6 subsample stage, four calls from one seed, with
the package beside the script: a copy of the script in another tree of the
repo times that tree's subsampler; the fourth builds, fits the torus and
the multiclass LAE model of phase 11, then runs phases 12–15 alone; the
fifth builds, fits the torus, draws the n=1e7 path's anchors once and runs
a reference HMC on the torus posterior, then phases 16–17 alone).
Phases, each of which ends the script with a non-zero exit if it fails:

1. the card: name and power limit from nvidia-smi; a CUDA device is required
   (there is no CPU path) and TF32 is switched off;
2. build: nvcc compiles the kernels K1–K9 and ``ell_sym_matmat`` from
   flgp_tpu_torch/csrc for sm_90a (one nvcc process per source, all at once);
   the instructions one FISTA step of K2 issues at r=3 are counted from the
   library's SASS (``cuobjdump``), for both arithmetic variants;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   main path gives them: the torus config (n=4800, d=2, s=600, r=3, K=100)
   and the large config (n=1e6, d=2, s=1024, r=3, K=128), with both times
   (K1 also beside its two-call library yardstick, ``knn_library``);
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
   seed, timed, which must return the same anchors bit for bit, two fits on
   the first draw's anchors from one generator seed (both learned t's
   printed) and two ``spectrum_fused`` calls on that graph, which must give
   the same eigenvalues and vectors bit for bit;
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
    ``fit_se_regression_gp`` and ``fit_nystrom_regression_gp`` on the spiral;
11. multiclass and the extras: K1–K5 vs their plain versions at the
    multiclass shape (``mnist_like``: n = 7e4, d = 16, s = 600, r = 3,
    K = 100; K1's differing rows near-ties only, at most 0.1% of them;
    side rows, the kernels line keeps its shapes); K1's tiled body (every d
    but 2 and 3) against the old run-time-d body forced by ``legacy``, the
    same indices and d² bit for bit, at the shapes of that fit, of its
    k-means‖ rounds, of the grid drivers, of a streamed chunk and of the
    anchor split at d = 16 and at (n = 7e4, s = 600, r = 3) for d = 64, 256
    and 784, timed beside the plain version, the two-call library yardstick
    (``knn_library``) and the bound; the BASELINE multiclass
    fit through ``fit_lae_logit_mult_gp`` (f32 graph, f64 tail, sigma 1e-3,
    50 sweeps, ten classes) cold and warm from one generator seed, which
    must give the same t, labels and posterior means bit for bit, must
    launch K1–K5 and must reach the same fit's error in float64 on the card
    (plain versions only) + 0.01; the fit stage by stage, its peak memory,
    and its device activities (``torch.profiler``) beside the binary torus
    fit's; ``fit_se_logit_mult_gp`` (K9 must be launched),
    ``fit_nystrom_logit_mult_gp`` and ``fit_gl_logit_mult_gp`` (sparse
    LOBPCG; ``ell_sym_matmat`` must be launched) at n = 5000, s = 500, each
    held to its float64 run + 0.01; ``heat_kernel_covariance`` on the torus
    (t = 1, (4800, 100), K1–K5 launched) and ``lae_eigenmap`` (s = 600,
    r = 3, ten dimensions: eigenvalues sorted in [0, 2]);
12. the posterior-sampling path: the torus fit again from phase 4's seed
    (K1–K5 must be launched, the spectrum must be phase 4's bit for bit),
    its whitened GPC posterior (``make_whitened``, K = 100; ``GpcLogPost``,
    dim 101, float32), whose analytic gradient must agree with autograd to
    1e-4 of max|grad| and whose TF32 variant must agree with float32 to 1e-2
    relative and leave ``allow_tf32`` off; then ``run_hmc`` (16 chains, 256
    warmup, 512 draws, 16 leapfrog steps), ``run_nuts`` (16 chains, 128
    warmup, 64 draws, max_depth 8), ``run_chees`` (128 chains, 512 warmup,
    64 draws) and ``run_chees_fixed`` (4096 chains, 128 draws), each with its
    warmup and sampling walls, chain-gradients a second, min-ESS a second
    and accept beside the card; split-R̂ < 1.1 for HMC and ChEES; the three
    samplers' means of f at the train points within 6 Monte Carlo errors +
    0.05 and their median variance ratios in (0.6, 1.6); train error of
    sign(mean f) ≤ 0.03; NUTS's host syncs and lockstep leapfrog steps a
    transition; device activities a leapfrog step and device busy share of
    one HMC transition (``torch.profiler``); ``run_hmc_checkpointed`` (three
    segments) and a run resumed from a copy of its first two, which must be
    the same bits;
13. the t-hyperposterior at the BASELINE multiclass configuration, on phase
    11's n = 7e4 spectrum (its fit launched K1–K5) with its 500 one-hot train
    labels: ``mult_t_posterior`` (64 particles, 5 random-walk mutations,
    Newton cap 25, two stages a run) and the same whole ladder from one seed,
    which must be the same bits, then ``mult_t_quadrature`` (256 points,
    two passes); the SMC t-means within 1.0 quadrature sd on every class and
    0.5 on average, the coarse weight below 0.5, finite evidence; walls,
    Newton solves and host syncs a target evaluation, peak memory; then
    ``gpc_t_posterior`` (64 particles) on phase 4's torus spectrum, its
    t-mean within 1.5 in log of the ``gpc_nlp_objective`` grid optimum;
14. SVI on phase 12's torus posterior: ``fit_svi`` (8000 steps) and
    ``fit_svi_lowrank`` (rank 5, 8000 steps), n_mc 8, lr 0.02, held to phase 12's HMC
    draws: mean-field's means within 1.0 reference sd at every coordinate
    and its median sd ratio in (0.6, 1.6), both families finite; the
    low-rank family's numbers, the ELBOs and the low-rank gain reported (F5);
15. the README goldens on the reference's own data: ``torus_rings_r``
    through ``fit_lae_logit_gp`` (err ≤ 0.015, K1–K5 launched) and
    ``fit_se_logit_gp`` (err ≤ 0.005, K1 and K9), float32 graph and
    float64 tail; ``spiral_r`` on ``spiral_r_anchors`` through the LAE and SE
    regression drivers in float64 with the plain versions (|rmse − 0.4582| <
    8e-3, |rmse − 0.5032| < 1.5e-3) and with the float32 graph and the
    kernels (the float64 rmse + 0.01); ``fit_lae_logit_gp(report=...)``
    from phase 4's seed under ``profiler_trace``, which must give phase 4's
    outputs bit for bit and leave a trace file; and
    ``fit_se_regression_gp_resumable`` on the spiral, stopped after 4 of 10
    bandwidths and resumed, the same bits as the run that was not stopped;
16. the out-of-core fits: the n=1e7 torus written to a FLGP0001 file
    (``native.write_matrix``) and one pass of its chunk reads timed (the read
    rate); ``streamed_build_spectrum`` on phase 7's warm anchors must be the
    in-memory row-major ``build_spectrum``'s bits, values and vectors; the
    graph pass alone overlapped (two pinned buffers, the copies queued behind
    the chunk before), serial, with side-stream copies read inline or by a
    reader thread (yardsticks) and in memory, the graphs the same bits, then
    overlapped and serial from a cold file; then
    ``fit_lae_logit_gp_streamed`` from the file with its own subsampler
    (reservoir sample, k-means, 1-NN count pass), f32 graph and f64 tail,
    stage by stage: err ≤ 0.03, t finite, outputs (n,) and finite, K1
    launched 2 × 153 times plus k-means' own, K2 153 times, three passes of
    153 reads and none longer than a chunk, peak memory; then
    ``fit_lae_regression_gp_streamed`` on the spiral (rmse ≤ 0.60) and
    ``fit_lae_logit_mult_gp_streamed`` on ``mnist_like`` (err ≤ 0.03), each
    from a file in chunks;
17. the multi-device layer at world size 1: ``init_distributed`` from the
    FLGP_* environment on localhost (NCCL; an all_reduce on the card leaves
    its tensor), ``sharded_spectrum_from_ell_fn`` on phase 16's graph and
    ``sharded_spectrum_fn`` on X, each the single-device spectrum's bits;
    the sharded GPR NMLL (relative 1e-8) and prediction on the spiral and
    the sharded Laplace tail at phase 4's t (rtol 1e-5) against their
    single-process versions; chain-sharded HMC, NUTS and ChEES (16 chains)
    on phase 12's posterior, f's means within phase 12's Monte Carlo bound
    of its HMC run; ``sharded_smc_fn`` the bits of ``run_smc`` (4096
    particles, one generator); the process group destroyed at the end.

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
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
from flgp_tpu_torch import native  # noqa: E402
from flgp_tpu_torch.fit import streaming  # noqa: E402
from flgp_tpu_torch.fit.drivers import _solve_cast, _train_gpc  # noqa: E402
from flgp_tpu_torch.fit.spectral import build_spectrum  # noqa: E402
from flgp_tpu_torch.fit.streaming import _gpc_lowrank_tail  # noqa: E402
from flgp_tpu_torch.inference import chees, hmc, nuts, resume  # noqa: E402
from flgp_tpu_torch.inference.diagnostics import ess, split_rhat  # noqa: E402
from flgp_tpu_torch.models.latent import (  # noqa: E402
    GpcLogPost, latent_f, logpost_with_precision, make_whitened)
from flgp_tpu_torch.ops import _build  # noqa: E402
from flgp_tpu_torch.ops import colmajor as col  # noqa: E402
from flgp_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from flgp_tpu_torch.ops.kmeans import SubsampleResult, subsample  # noqa: E402
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
# the BASELINE multiclass configuration (n = 7e4, ten classes, d = 16) and the
# grid drivers' smaller depth
MNIST = dict(n=70_000, m=500, seed=0, s=600, r=3, K=100)
MNIST_GRID = dict(n=5000, m=500, seed=0, s=500, r=3, K=100)
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


def check_knn(label: str, X, U, r: int, max_share: float = 1e-4):
    """K1 against its plain version on the same inputs: rows may differ on
    near-ties only (at most ``max_share`` of them), and none may at d = 2,
    where the kernel's d² is the plain version's bit for bit; d² within
    1e-5."""
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
    if n_differ > max_share * n:
        _fail(f"knn r={r} {label}: indices differ on {n_differ} of {n} rows (> {max_share:.2%})")
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


# K1's tiled body (every d but 2 and 3) at the shapes the multiclass path
# launches it at and at the widths of real data: (what, n, s, d, r)
KNN_WIDTHS = (
    ("multiclass graph", 70_000, 600, 16, 3),
    ("k-means‖ round", 70_000, 300, 16, 1),        # four a fit, B = ceil(2s/4) candidates
    ("k-means‖ candidates", 70_000, 1201, 16, 1),  # one a fit, 1 + 4B
    ("grid drivers' graph", 5000, 500, 16, 3),
    ("streamed chunk", 16_384, 600, 16, 3),
    ("anchor split", 3000, 700, 16, 3),
    ("anchor split", 3000, 700, 17, 16),
    ("anchor split", 3000, 700, 5, 9),
    ("d=64", 70_000, 600, 64, 3),
    ("d=256", 70_000, 600, 256, 3),
    ("d=784 (MNIST's width)", 70_000, 600, 784, 3),
)


def knn_library(X, U, r: int):
    """The two-call yardstick of K1: one float32 product with |u|² folded in
    (``torch.addmm``, TF32 off) and one ``torch.topk``, then |x|² added to
    the r values.  Timed only; the port never calls it."""
    vals, idx = torch.topk(torch.addmm(torch.sum(U * U, dim=1), X, U.T, alpha=-2.0), r, dim=1,
                           largest=False)
    return vals + torch.sum(X * X, dim=1, keepdim=True), idx


def knn_widths(X16, dev) -> None:
    """K1's tiled body against the old run-time-d body (``_knn(legacy=
    True)``) at KNN_WIDTHS: the same indices and d² bit for bit (else the
    script fails), and the times of both, of the plain version and of the
    library yardstick (and of its product alone, the card's float32 GEMM
    rate) beside the bound.  d = 16 on phase 11's points (the first n of
    them), the other widths on ``mnist_like`` at that width."""
    from flgp_tpu_torch.datasets import mnist_like

    g = torch.Generator(device=dev).manual_seed(11)
    print("K1's tiled body (every d but 2 and 3) vs the old run-time-d body, ms a call:",
          flush=True)
    for what, n, s, d, r in KNN_WIDTHS:
        X = X16[:n] if d == 16 else cloud(mnist_like(n=n, d=d, m_train=min(500, n // 2), seed=0),
                                          dev)
        U = X[torch.randperm(n, generator=g, device=dev)[:s]].contiguous()
        got = hk.knn(X, U, r)
        old = hk._knn(X, U, r, 0, legacy=True)
        torch.cuda.synchronize()
        if not (torch.equal(got.indices, old.indices) and torch.equal(got.sqdists, old.sqdists)):
            _fail(f"knn {what} (n={n}, s={s}, d={d}, r={r}): the tiled body's indices or d² "
                  f"are not the old body's")
        ref = knn_plain(X, U, r)
        slow = d >= 784
        ms = cuda_ms(lambda: hk.knn(X, U, r), 20)
        old_ms = cuda_ms(lambda: hk._knn(X, U, r, 0, legacy=True), 2 if slow else 5)
        plain_ms = cuda_ms(lambda: knn_plain(X, U, r), 2 if slow else 3)
        lib_ms = cuda_ms(lambda: knn_library(X, U, r), 10)
        mm_ms = cuda_ms(lambda: X @ U.T, 10)
        b_ms, b_by = bound(work("knn", n=n, r=r, s=s, d=d))
        print(f"  {what:22s} n={n} s={s} d={d} r={r} split={hk.knn_anchor_split(n, s)}: tiled "
              f"{ms:9.4f}  old {old_ms:9.4f}  plain {plain_ms:9.4f}  library {lib_ms:9.4f} "
              f"(addmm + topk, two calls; X @ U.T alone {mm_ms:.4f}, "
              f"{2e-9 * n * s * d / mm_ms:.1f} TFLOP/s)  bound {b_ms:.4f} ({b_by}), tiled/bound "
              f"{ms / b_ms:.1f}x, {2e-9 * n * s * d / ms:.1f} TFLOP/s of x·u; the old body's "
              f"bits; max_abs_err vs plain {_maxabs(got.sqdists, ref.sqdists):.3e}", flush=True)
        del X, U, got, old, ref
    torch.cuda.empty_cache()


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


def cloud(ds, dev) -> torch.Tensor:
    """The (n, d) float32 points [train; test] of a split on the card."""
    return torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32,
                           device=dev).contiguous()


def check_kernels(label: str, X, cfg: dict, dev, results: dict, max_share: float = 1e-4) -> None:
    """Each kernel against its plain version on the same device inputs: the
    points X at the config's s, r and K (K1's differing rows at most
    ``max_share``)."""
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
        got, ref = check_knn(label, X, UU, rr, max_share)
        if rr == r:
            record("knn", _maxabs(got.sqdists, ref.sqdists),
                   cuda_ms(lambda: hk.knn(X, U, r), reps_k),
                   cuda_ms(lambda: knn_plain(X, U, r), reps_p))
            rows.append(f"  {label:5s} knn two-call library yardstick (addmm + topk, not in the "
                        f"kernels line): {cuda_ms(lambda: knn_library(X, U, r), reps_k):9.4f} ms")
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
    print(f"kernels vs plain, {label} shape (n={n}, d={d}, s={s}, r={r}, K={K}), ms per call:")
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


def timed_subsamples(X_all, g, dev, calls: int, seed: int = 2) -> tuple:
    """The subsample stage (k-means‖ seeding + Lloyd) ``calls`` times from one
    generator seed: (results, host seconds of each call, synchronized)."""
    subs, times = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        subs.append(subsample(torch.Generator(device=dev).manual_seed(seed), X_all, g.s,
                              g.subsample, g.nstart, g.kmeans_iters))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return subs, times


def same_anchors_fits(X_all, ds, cfg, dev) -> None:
    """Whether one seed gives one fit at n=1e6: the port's subsampler twice
    from one seed must return the same anchors bit for bit (its cluster sums
    add in an order fixed by the data), two fits on the first draw's anchors
    from one generator seed, and two ``spectrum_fused`` calls on that draw's
    graph, must give the same spectra bit for bit; t is reported."""
    g = cfg.graph
    subs, sub_s = timed_subsamples(X_all, g, dev, 2)
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
          f"the subsampler twice from one seed ({sub_s[0]:.3f} s, {sub_s[1]:.3f} s): anchors "
          f"{'identical' if anchors_same else 'differ'} (max abs diff of the centers "
          f"{_maxabs(subs[0].centers, subs[1].centers):.3e})", flush=True)
    if not (same and fit_same):
        _fail("n=1e6: two spectra of one graph differ")
    if not anchors_same:
        _fail("n=1e6: the subsampler twice from one seed returned anchors that differ")
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


def huge_phase(dev, results: dict) -> tuple:
    """Phases 6 and 7 on one n=1e7 torus cloud; returns the launches of the
    first n=1e7 fit, the cloud and the warm draw's anchors and sizes."""
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
    return launches, dict(ds=ds7, anchors=last["anchors"], counts=last["counts"])


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
    ``device=`` argument), cold then warm from the same generator seed;
    launches are the cold fit's, ``first`` its result.  A multiclass driver's
    moments are (n_test, J)."""
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
            out["first"] = res
    n_test = ds.x_test.shape[0]
    moments = (n_test, int(np.max(ds.y_train)) + 1) if "_mult_" in name else (n_test,)
    for nm, shape in (("y_test", (n_test,)), ("posterior_mean", moments),
                      ("posterior_cov", moments)):
        arr = getattr(res, nm)
        if arr.shape != shape or not np.all(np.isfinite(arr)):
            _fail(f"{name} {nm}: shape {arr.shape} or non-finite values")
    if res.eigenpair.vectors.device.type != "cuda":
        _fail(f"{name} ran on {res.eigenpair.vectors.device}, not on the card")
    out["res"] = res
    if "_logit_" in name:
        out["score"] = float(np.mean(res.y_test != ds.y_test))
    else:
        out["score"] = float(np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)))
    return out


def _report_fit(name: str, what: str, f: dict) -> None:
    pars = {k: float(v) if np.ndim(v) == 0 else [float(f"{x:.6g}") for x in np.ravel(v)]
            for k, v in f["res"].pars.items()}
    metrics = "" if f["res"].metrics is None else f"  metrics {f['res'].metrics}"
    warm = f"  warm {f['warm_s']:.3f} s" if "warm_s" in f else ""
    print(f"{name} ({what}): {'err' if '_logit_' in name else 'rmse'} {f['score']:.6f}  "
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


def mult_cfg(shape: dict, dtype, **kw):
    """The BASELINE multiclass configuration (sigma 1e-3, 50 sweeps, the last
    25 averaged) at a shape; float32 takes the float64 solve tail."""
    return ft.FitConfig(graph=ft.GraphConfig(s=shape["s"], r=shape["r"], K=shape["K"]),
                        sigma=1e-3, n_gibbs=50, gibbs_avg_sweeps=25, dtype=dtype,
                        solve_dtype=torch.float64 if dtype == torch.float32 else None, **kw)


def mult_stages(ds, cfg, dev, seed: int) -> dict:
    """The LAE multiclass fit stage by stage, as ``fit_lae_logit_mult_gp``
    runs it (the same generator draws in the same order), with a sync after
    each stage: host seconds per stage, the learned t and the labels."""
    from flgp_tpu_torch.fit import multiclass as mc

    g, times = cfg.graph, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    gen = torch.Generator(device=dev).manual_seed(seed)
    X_all = cloud(ds, dev)
    m, n = len(ds.y_train), X_all.shape[0]
    K = min(g.resolved_K(), g.s, n)
    Y = torch.as_tensor(ds.y_train, dtype=cfg.dtype, device=dev)
    aug = mc.one_hot_labels(Y, int(torch.max(Y)) + 1)
    sub = stage("subsample", lambda: subsample(gen, X_all, g.s, g.subsample, g.nstart,
                                               g.kmeans_iters))
    centers = sub.centers.contiguous()

    def graph():
        idx = knn(X_all, centers, g.r).indices
        return idx, lae_weights(X_all, centers, idx)

    idx, w = stage("graph", graph)
    eig = stage("spectrum", lambda: spectrum_fused(w, idx, g.s, g.resolved_K(), g.gl, g.root,
                                                   sub.counts))
    scfg, seig, (aug_s,) = _solve_cast(cfg, eig, aug)
    res = stage("train", lambda: mc._train_mult(seig, aug_s, m, K, scfg))
    labels, _ = stage("predict", lambda: mc._predict_mult(gen, seig, aug_s, res.x, m, n, K, scfg))
    stage("posterior", lambda: mc._posterior_mult(seig, aug_s, res.x, m, n, K, scfg.sigma))
    return dict(times=times, t=res.x.cpu().numpy(), y_test=labels[m:].cpu().numpy())


def device_activities(fn) -> int:
    """Device activities (kernels, copies, memsets) that ``fn`` queues,
    counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def gated_mult_fit(name: str, what: str, ds, shape: dict, dev, cold_and_warm: bool = False,
                   **kw) -> dict:
    """A multiclass driver with the float32 graph and float64 tail, held to
    the same fit in float64 on the card (plain versions only) + 0.01."""
    f = entry_fit(name, ds, mult_cfg(shape, torch.float32, **kw), dev, seed=0,
                  cold_and_warm=cold_and_warm)
    _report_fit(name, what, f)
    f64 = entry_fit(name, ds, mult_cfg(shape, torch.float64, **kw), dev, seed=0,
                    cold_and_warm=False)
    _report_fit(name, "the same in float64, plain versions only", f64)
    gate = f64["score"] + 0.01
    print(f"{name} gate: err {f['score']:.6f} <= {gate:.6f}", flush=True)
    if f["score"] > gate:
        _fail(f"{name} test error {f['score']} > {gate} (float64 + 0.01)")
    if not np.all(np.isfinite(f["res"].pars["t"])) or np.shape(f["res"].pars["t"]) != (
            int(np.max(ds.y_train)) + 1,):
        _fail(f"{name}: pars['t'] {f['res'].pars['t']} is not finite and one a class")
    return f


def multiclass_phase(dev, results: dict) -> dict:
    """Phase 11: K1–K5 at the multiclass shape, the BASELINE multiclass fit
    (n = 7e4, d = 16, ten classes) through ``fit_lae_logit_mult_gp`` cold and
    warm from one seed (the same bits), stage by stage, its device
    activities beside the binary torus fit's, the grid drivers at n = 5000,
    and the extras.  Returns the LAE fit's launches, its spectrum and the
    dataset."""
    from flgp_tpu_torch.datasets import mnist_like

    cfg = MNIST
    ds = mnist_like(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"])
    X = cloud(ds, dev)
    # at d = 16 K1's fmaf chain and the plain version's GEMM of depth 16 round
    # x·u differently: near-ties may swap, up to 0.1% of rows, as for self-kNN
    check_kernels("mnist", X, cfg, dev, results, max_share=1e-3)
    knn_widths(X, dev)
    del X
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    lae = gated_mult_fit("fit_lae_logit_mult_gp", "mnist_like n=70000, d=16, J=10, s=600",
                         ds, cfg, dev, cold_and_warm=True)
    peak = torch.cuda.max_memory_allocated()
    first, warm = lae["first"], lae["res"]
    same = (np.array_equal(first.pars["t"], warm.pars["t"])
            and np.array_equal(first.y_test, warm.y_test)
            and np.array_equal(first.posterior_mean, warm.posterior_mean))
    print(f"fit_lae_logit_mult_gp twice from one generator seed: t, labels and posterior means "
          f"{'the same bits' if same else 'differ'}; peak memory {peak / 2**30:.2f} GiB "
          f"(cold and warm fit and the float64 one)", flush=True)
    if not same:
        _fail("fit_lae_logit_mult_gp: two fits from one seed differ (t or labels)")
    missing = [k for k in MAIN_PATH if lae["launches"].get(k, 0) == 0]
    if missing:
        _fail(f"fit_lae_logit_mult_gp launched no {missing} kernel")
    if lae["res"].eigenpair.vectors.device.type != "cuda":
        _fail("fit_lae_logit_mult_gp: the eigenpair is not on the card")

    f32 = mult_cfg(cfg, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    st = mult_stages(ds, f32, dev, seed=0)
    peak1 = torch.cuda.max_memory_allocated()
    same = np.array_equal(st["t"], first.pars["t"]) and np.array_equal(st["y_test"], first.y_test)
    print("fit_lae_logit_mult_gp stage by stage (s): " + "  ".join(
        f"{k} {v:.3f}" for k, v in st["times"].items()) + f"  sum {sum(st['times'].values()):.3f};"
          f" t and labels {'the entry point' + chr(39) + 's bits' if same else 'differ'}; peak "
          f"memory of this one fit {peak1 / 2**30:.2f} GiB", flush=True)
    tor = SHAPES["torus"]
    tds = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    tor_cfg = ft.FitConfig(graph=ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"]), sigma=1e-3,
                           dtype=torch.float32, solve_dtype=torch.float64)
    acts = {label: device_activities(lambda: getattr(ft, nm)(
        torch.Generator(device=dev).manual_seed(0), d.x_train, d.y_train, d.x_test, cfg=c))
        for label, nm, d, c in (("multiclass n=7e4", "fit_lae_logit_mult_gp", ds, f32),
                                ("binary torus", "fit_lae_logit_gp", tds, tor_cfg))}
    print(f"device activities a fit (torch.profiler: kernels, copies, memsets): {acts}",
          flush=True)

    ds5 = mnist_like(n=MNIST_GRID["n"], m_train=MNIST_GRID["m"], seed=MNIST_GRID["seed"])
    what = "mnist_like n=5000, d=16, J=10, s=500, 10 bandwidths"
    se = gated_mult_fit("fit_se_logit_mult_gp", what, ds5, MNIST_GRID, dev)
    if se["launches"].get("ell_matmat", 0) == 0:
        _fail(f"fit_se_logit_mult_gp launched no ell_matmat kernel: {se['launches']}")
    gated_mult_fit("fit_nystrom_logit_mult_gp", what, ds5, MNIST_GRID, dev)
    gl = gated_mult_fit("fit_gl_logit_mult_gp", what + ", sparse LOBPCG", ds5, MNIST_GRID, dev,
                        gl_sparse=True, gl_solver="lobpcg")
    if gl["launches"].get("ell_sym_matmat", 0) == 0:
        _fail(f"fit_gl_logit_mult_gp launched no ell_sym_matmat kernel: {gl['launches']}")

    extras(dev)
    return lae["launches"], first.eigenpair, ds


def extras(dev) -> None:
    """``heat_kernel_covariance`` (torus, t = 1) and ``lae_eigenmap`` (torus,
    s = 600, r = 3, ten dimensions) on float32 points, through the entry
    points."""
    tor = SHAPES["torus"]
    ds = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    hk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = ft.heat_kernel_covariance(torch.Generator(device=dev).manual_seed(0),
                                  ds.x_train.astype(np.float32), ds.x_test.astype(np.float32), 1.0,
                                  ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"]))
    torch.cuda.synchronize()
    hk_s, hk_launches = time.perf_counter() - t0, {k: v for k, v in hk.LAUNCHES.items() if v}
    sym = _maxabs(H[:tor["m"]], H[:tor["m"]].T)
    print(f"heat_kernel_covariance (torus, t=1): shape {tuple(H.shape)}, {hk_s:.3f} s, "
          f"max|H[:m] - H[:m]ᵀ| {sym:.3e}, launches {hk_launches}", flush=True)
    if tuple(H.shape) != (tor["n"], tor["m"]) or not bool(torch.all(torch.isfinite(H))):
        _fail(f"heat_kernel_covariance: shape {tuple(H.shape)} or non-finite values")
    missing = [k for k in MAIN_PATH if hk_launches.get(k, 0) == 0]
    if missing:
        _fail(f"heat_kernel_covariance launched no {missing} kernel")
    hk.reset_launches()
    vals, vecs = ft.lae_eigenmap(torch.Generator(device=dev).manual_seed(0),
                                 cloud(ds, dev), tor["s"], tor["r"], 10)
    torch.cuda.synchronize()
    v = vals.double().cpu().numpy()
    print(f"lae_eigenmap (torus, s=600, r=3, 10 dimensions): eigenvalues {np.array2string(v, precision=6)}, "
          f"vectors {tuple(vecs.shape)}, launches {({k: x for k, x in hk.LAUNCHES.items() if x})}",
          flush=True)
    # 1 − σ, σ ≤ 1 up to the float32 rounding of the (s, s) Gram's eigenvalues
    if not (np.all(np.diff(v) >= 0) and v[0] >= -1e-4 and v[-1] <= 2.0) or vecs.shape != (
            tor["n"], 10):
        _fail("lae_eigenmap: eigenvalues not sorted in [0, 2] or vectors of the wrong shape")


# phase 12: the posterior-sampling path on the torus GPC posterior
SAMPLERS = dict(hmc=dict(chains=16, n_warmup=256, n_samples=512, n_leapfrog=16),
                nuts=dict(chains=16, n_warmup=128, n_samples=64, max_depth=8),
                chees=dict(chains=128, n_warmup=512, n_samples=64, max_steps=256),
                chees_fixed=dict(chains=4096, n_samples=128),
                resume=dict(chains=16, n_warmup=64, n_samples=192, segment=64, n_leapfrog=16))
RHAT_GATE = 1.1


class CountedPost:
    """The posterior with a count of the chain-gradients it evaluates
    (rows of x a ``value_and_grad`` call gets); nothing on the device."""

    def __init__(self, post):
        self.post, self.device, self.rows = post, post.device, 0

    def __call__(self, x):
        return self.post(x)

    def value_and_grad(self, x):
        self.rows += x.shape[0]
        return self.post.value_and_grad(x)


def _synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def timed_sampler(run, counted: CountedPost) -> dict:
    """``run(on_warmup_end)`` with its warmup and sampling walls and
    chain-gradient counts apart."""
    marks = {}

    def warmup_end():
        marks["t"], marks["rows"] = _synced(), counted.rows

    counted.rows = 0
    t0 = _synced()
    out = run(warmup_end)
    t1 = _synced()
    return dict(out=out, warm_s=marks["t"] - t0, samp_s=t1 - marks["t"],
                warm_rows=marks["rows"], samp_rows=counted.rows - marks["rows"])


def f_moments(gp, samples: torch.Tensor) -> dict:
    """Mean, variance and Monte Carlo error of f at the train points over the
    draws (n, C, dim) of x = [u, log t]."""
    K = gp.V.shape[1]
    f = latent_f(gp, samples[..., :K], torch.exp(samples[..., K])).double().cpu().numpy()
    flat = f.reshape(-1, f.shape[-1])
    mean, var = flat.mean(0), flat.var(0)
    return dict(mean=mean, var=var, mc=np.sqrt(var / np.maximum(ess(f), 10.0)))


def one_transition_profile(post, state, step, inv_mass, n_leapfrog: int, dev) -> tuple:
    """(device activities per leapfrog step, device busy share) of one HMC
    transition: the activities and their summed device time from
    ``torch.profiler``, over the wall of the same transition unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(9)
    for _ in range(3):
        hmc.hmc_kernel(post, g, state, step, inv_mass, n_leapfrog)
    t0 = _synced()
    hmc.hmc_kernel(post, g, state, step, inv_mass, n_leapfrog)
    wall = _synced() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hmc.hmc_kernel(post, g, state, step, inv_mass, n_leapfrog)
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in acts)
    return len(acts) / n_leapfrog, busy_us * 1e-6 / wall, wall, busy_us * 1e-6


def _report_sampler(name: str, what: str, t: dict, samples, accept, step, card: str) -> None:
    min_ess = float(np.min(ess(samples)))
    total = t["warm_s"] + t["samp_s"]
    print(f"{name} ({what}): warmup {t['warm_s']:.3f} s, sampling {t['samp_s']:.3f} s; "
          f"chain-gradients/s {(t['warm_rows'] + t['samp_rows']) / total:.4g} "
          f"(sampling alone {t['samp_rows'] / t['samp_s']:.4g}); min-ESS {min_ess:.1f}, "
          f"min-ESS/s {min_ess / total:.4g} with warmup, {min_ess / t['samp_s']:.4g} sampling "
          f"alone; accept {float(accept.float().mean()):.4f}; step "
          f"{float(step.float().mean()):.4g} (chains {float(step.min()):.4g}–"
          f"{float(step.max()):.4g}) [{card}]", flush=True)


def _gate_rhat(name: str, samples, gate: bool = True) -> None:
    """Print split-R̂ of the draws and, if ``gate``, fail at RHAT_GATE."""
    rhat = split_rhat(samples.double()).cpu().numpy()
    worst = int(np.argmax(rhat))
    print(f"  {name} split-R̂: max {rhat[worst]:.4f} (coordinate {worst}), median "
          f"{float(np.median(rhat)):.4f}", flush=True)
    if gate and not np.all(rhat < RHAT_GATE):
        _fail(f"{name}: split-R̂ {rhat[worst]:.4f} >= {RHAT_GATE} at coordinate {worst}")


def sampling_phase(dev, torus_eig: EigenPair, card: str) -> dict:
    """Phase 12: the torus fit again from phase 4's seed (K1–K5 launched, the
    same spectrum bit for bit), its whitened GPC posterior (K = 100, dim 101,
    float32), the analytic gradient against autograd and the TF32 variant
    against full float32, then HMC, NUTS, ChEES (adaptive, then fixed at 4096
    chains) and checkpointed HMC with a resumed run, each timed beside the
    card; R̂, agreement of f's moments at the train points across the three
    samplers, train error and bit-exact resume are gates.  Returns the
    posterior, the HMC draws and the fit's launches for phase 14."""
    tor = SHAPES["torus"]
    m, K = tor["m"], tor["K"]
    hk.reset_launches()
    res, err, wall, ds = fit(tor, torus_fit_cfg(), dev, seed=0)
    launches = {k: hk.LAUNCHES[k] for k in MAIN_PATH}
    same = (torch.equal(res.eigenpair.values, torus_eig.values)
            and torch.equal(res.eigenpair.vectors, torus_eig.vectors))
    print(f"sampling path: torus fit err {err:.6f}, {wall:.3f} s, launches {launches}, spectrum "
          f"{'the same bits as phase 4' if same else 'DIFFERS from phase 4'}", flush=True)
    if any(v == 0 for v in launches.values()):
        _fail(f"the sampling path's fit launched no {[k for k, v in launches.items() if not v]}")
    if not same:
        _fail("the torus fit from phase 4's seed gave another spectrum")

    gp = make_whitened(res.eigenpair, torch.arange(m), K, 1e-3)
    Y = torch.as_tensor(ds.y_train, dtype=torch.float32, device=dev)
    post = GpcLogPost(gp, Y, torch.ones((m,), dtype=torch.float32, device=dev), 1e-2, 10.0, 2.0)
    counted = CountedPost(post)
    x0 = 0.1 * torch.randn((SAMPLERS["chees"]["chains"], post.dim), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    # the analytic gradient against autograd, and the TF32 variant
    lp, grad = post.value_and_grad(x0)
    xg = x0.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(post(xg).sum(), xg)
    g_err = float(torch.max(torch.abs(grad - auto)) / torch.max(torch.abs(auto)))
    lp_tf, grad_tf = logpost_with_precision(post, "tf32").value_and_grad(x0)
    tf_err = float(torch.max(torch.abs(lp_tf - lp) / torch.abs(lp)))
    flag = torch.backends.cuda.matmul.allow_tf32
    print(f"GpcLogPost (m={m}, dim={post.dim}, {x0.shape[0]} points, float32): analytic gradient "
          f"vs autograd max abs diff / max|grad| {g_err:.3e} (gate 1e-4); TF32 values vs full "
          f"float32 max relative diff {tf_err:.3e} (gate 1e-2); allow_tf32 after: {flag}",
          flush=True)
    if not g_err <= 1e-4:
        _fail(f"analytic gradient differs from autograd by {g_err:.3e} of max|grad|")
    if not tf_err <= 1e-2:
        _fail(f"the TF32 density differs from float32 by {tf_err:.3e} relative")
    if flag:
        _fail("allow_tf32 is still on after the TF32 density")
    wide = 0.1 * torch.randn((SAMPLERS["chees_fixed"]["chains"], post.dim), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(3))
    vg_ms = {name: cuda_ms(lambda p=p: p.value_and_grad(wide), 50)
             for name, p in (("float32", post), ("tf32", logpost_with_precision(post, "tf32")))}
    print(f"  value_and_grad at {wide.shape[0]} chains: float32 {vg_ms['float32']:.4f} ms, "
          f"TF32 {vg_ms['tf32']:.4f} ms [{card}]", flush=True)

    moments = {}
    # HMC
    c = SAMPLERS["hmc"]
    t = timed_sampler(lambda end: hmc.run_hmc(
        torch.Generator(device=dev).manual_seed(2), counted, x0[:c["chains"]], n_warmup=c["n_warmup"],
        n_samples=c["n_samples"], n_leapfrog=c["n_leapfrog"], on_warmup_end=end), counted)
    run = t["out"]
    _report_sampler("run_hmc", f"{c['chains']} chains, {c['n_warmup']} warmup, "
                    f"{c['n_samples']} draws, {c['n_leapfrog']} leapfrog steps", t, run.samples,
                    run.accept_prob, run.step, card)
    _gate_rhat("run_hmc", run.samples)
    hmc_draws = run.samples
    moments["hmc"] = f_moments(gp, run.samples)
    per_step, busy, one_wall, one_busy = one_transition_profile(
        post, hmc.init_state(post, run.samples[-1]), run.step, run.inv_mass, c["n_leapfrog"], dev)
    print(f"  one HMC transition ({c['n_leapfrog']} leapfrog steps, {c['chains']} chains): "
          f"{one_wall * 1e3:.3f} ms wall, {one_busy * 1e3:.3f} ms of device activity, busy share "
          f"{busy:.4f}; {per_step:.1f} device activities a leapfrog step [{card}]", flush=True)

    # NUTS
    c = SAMPLERS["nuts"]
    nuts.reset_stats()
    at_end = {}

    def nuts_run(end):
        def mark():
            at_end.update(nuts.STATS)
            end()

        return nuts.run_nuts(torch.Generator(device=dev).manual_seed(4), counted, x0[:c["chains"]],
                             n_warmup=c["n_warmup"], n_samples=c["n_samples"],
                             max_depth=c["max_depth"], on_warmup_end=mark)

    t = timed_sampler(nuts_run, counted)
    run = t["out"]
    _report_sampler("run_nuts", f"{c['chains']} chains, {c['n_warmup']} warmup, "
                    f"{c['n_samples']} draws, max_depth {c['max_depth']}", t, run.samples,
                    run.accept_stat, run.step, card)
    samp = {k: nuts.STATS[k] - at_end.get(k, 0) for k in ("transitions", "host_syncs",
                                                            "lockstep_leaves")}
    own = float(run.n_leapfrog.double().mean())
    print(f"  NUTS sampling: per transition {samp['host_syncs'] / samp['transitions']:.2f} host "
          f"syncs, {samp['lockstep_leaves'] / samp['transitions']:.2f} lockstep leapfrog steps, "
          f"{own:.2f} of a chain's own (max {int(run.n_leapfrog.max())}); the whole run "
          f"{nuts.STATS['host_syncs']} syncs over {nuts.STATS['transitions']} transitions",
          flush=True)
    moments["nuts"] = f_moments(gp, run.samples)

    # ChEES, adaptive then fixed at many chains
    c = SAMPLERS["chees"]
    t = timed_sampler(lambda end: chees.run_chees(
        torch.Generator(device=dev).manual_seed(5), counted, x0, n_warmup=c["n_warmup"],
        n_samples=c["n_samples"], max_steps=c["max_steps"], on_warmup_end=end), counted)
    run = t["out"]
    _report_sampler("run_chees", f"{c['chains']} chains, {c['n_warmup']} warmup, "
                    f"{c['n_samples']} draws, max_steps {c['max_steps']}", t, run.samples,
                    run.accept_prob, run.step.reshape(1), card)
    print(f"  ChEES adapted: step {float(run.step):.4g}, trajectory length "
          f"{float(run.traj_len):.4g}, {run.n_leapfrog_total} leapfrog steps in sampling",
          flush=True)
    _gate_rhat("run_chees", run.samples)
    cf = SAMPLERS["chees_fixed"]
    x_wide = run.samples[-1].repeat(cf["chains"] // c["chains"], 1)
    counted.rows = 0
    t0 = _synced()
    fixed = chees.run_chees_fixed(torch.Generator(device=dev).manual_seed(6), counted, x_wide,
                                  run.step, run.traj_len, run.inv_mass, n_samples=cf["n_samples"],
                                  max_steps=c["max_steps"])
    fixed_s = _synced() - t0
    fixed_ess = float(np.min(ess(fixed.samples)))
    print(f"run_chees_fixed ({cf['chains']} chains, {cf['n_samples']} draws): {fixed_s:.3f} s, "
          f"{fixed.n_leapfrog_total} leapfrog steps, chain-gradients/s "
          f"{counted.rows / fixed_s:.4g}, min-ESS {fixed_ess:.1f}, min-ESS/s "
          f"{fixed_ess / fixed_s:.4g}; accept {float(fixed.accept_prob.mean()):.4f} [{card}]",
          flush=True)
    _gate_rhat("run_chees_fixed", fixed.samples)
    moments["chees"] = f_moments(gp, fixed.samples)
    del fixed, x_wide

    # one posterior: f's moments agree across the samplers, and the labels
    y = ds.y_train
    for name, mo in moments.items():
        train_err = float(np.mean((mo["mean"] > 0) != (y > 0.5)))
        print(f"  {name}: train error of sign(mean f) {train_err:.4f} (gate 0.03)", flush=True)
        if train_err > 0.03:
            _fail(f"{name}: train error {train_err} > 0.03")
    names = list(moments)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            A, B = moments[a], moments[b]
            tol = 6.0 * np.sqrt(A["mc"] ** 2 + B["mc"] ** 2) + 0.05
            gap = np.abs(A["mean"] - B["mean"])
            ratio = float(np.median(A["var"] / B["var"]))
            print(f"  {a} vs {b}: max |mean f gap| {gap.max():.4f}, max gap / bound "
                  f"{float(np.max(gap / tol)):.3f}; median variance ratio {ratio:.4f} "
                  f"(gate (0.6, 1.6))", flush=True)
            if not np.all(gap < tol):
                _fail(f"{a} and {b}: mean f differs beyond 6 MC errors + 0.05 at "
                      f"{int(np.sum(gap >= tol))} train points")
            if not 0.6 < ratio < 1.6:
                _fail(f"{a} and {b}: median variance ratio {ratio}")

    # checkpointed HMC, then a run resumed from a copy of its first segments
    c = SAMPLERS["resume"]
    kw = dict(n_warmup=c["n_warmup"], n_samples=c["n_samples"], segment=c["segment"],
              n_leapfrog=c["n_leapfrog"])
    with tempfile.TemporaryDirectory(prefix="flgp_phase12_") as tmp:
        t0 = _synced()
        full = resume.run_hmc_checkpointed(7, post, x0[:c["chains"]], f"{tmp}/full", **kw)
        full_s = _synced() - t0
        keep = c["n_samples"] // c["segment"] - 1
        for i in range(keep):
            for name in (f"seg_{i}", f"phase_{i}"):
                shutil.copytree(f"{tmp}/full/{name}", f"{tmp}/resumed/{name}")
        t0 = _synced()
        again = resume.run_hmc_checkpointed(7, post, x0[:c["chains"]], f"{tmp}/resumed", **kw)
        again_s = _synced() - t0
    same = all(torch.equal(a, b) for a, b in zip(full, again))
    print(f"run_hmc_checkpointed ({c['chains']} chains, {c['n_warmup']} warmup, "
          f"{c['n_samples'] // c['segment']} segments of {c['segment']}): {full_s:.3f} s; resumed "
          f"after {keep} segments: {again_s:.3f} s, draws, accepts, steps and masses "
          f"{'the same bits' if same else 'DIFFER'}; accept {float(full.accept_prob.mean()):.4f} "
          f"[{card}]", flush=True)
    if not same:
        _fail("the resumed checkpointed HMC run differs from the uninterrupted one")
    _gate_rhat("run_hmc_checkpointed", full.samples, gate=False)
    return dict(post=post, gp=gp, hmc_draws=hmc_draws, hmc_moments=moments["hmc"],
                launches=launches, y_train=ds.y_train)


# phase 13: the t-hyperposterior at BASELINE config 3
SMC_BUDGET = dict(n_particles=64, n_mutation_steps=5, newton_max_iter=25, stages_per_dispatch=2)


def _counted_run(fn):
    """``fn()`` with its wall, its Newton solves and host syncs (``gpc.STATS``)
    and the peak device memory it reached."""
    from flgp_tpu_torch.models import gpc as gpc_mod

    gpc_mod.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = _synced()
    out = fn()
    wall = _synced() - t0
    return out, dict(wall=wall, solves=gpc_mod.STATS["solves"], syncs=gpc_mod.STATS["host_syncs"],
                     peak=torch.cuda.max_memory_allocated())


def _counts_line(c: dict) -> str:
    return (f"{c['wall']:.3f} s, {c['solves']} Newton solves (target evaluations), "
            f"{c['syncs'] / max(c['solves'], 1):.2f} Newton rounds (host syncs) each, peak memory "
            f"{c['peak'] / 2**30:.3f} GiB")


def target_evaluation_profile(eig: EigenPair, aug, idx, K: int, sigma: float,
                              theta: torch.Tensor) -> tuple:
    """(wall, device activity time, device activities, host syncs) of one
    target evaluation of ``mult_t_posterior`` at the particles ``theta``:
    the batched Newton solve over its particles × classes lanes, warm, then
    once under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from flgp_tpu_torch.inference.hyperparam import _phi
    from flgp_tpu_torch.models import gpc as gpc_mod

    V, lam = eig.vectors[idx, :K], eig.laplacian_eigenvalues(K)
    Yt, Nv = aug.T.contiguous(), torch.ones(aug.shape[0], dtype=aug.dtype, device=aug.device)

    def solve():
        return gpc_mod.gpc_marginal_log_likelihood_lowrank(
            _phi(V, lam, torch.exp(theta)), Yt, Nv, sigma, 1e-5, SMC_BUDGET["newton_max_iter"])

    solve()
    gpc_mod.reset_stats()
    t0 = _synced()
    solve()
    wall = _synced() - t0
    syncs = gpc_mod.STATS["host_syncs"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sum(e.time_range.elapsed_us() for e in acts) * 1e-6, len(acts), syncs


def hyperposterior_phase(dev, mnist_eig: EigenPair, mnist_ds, mnist_launches: dict,
                         torus_eig: EigenPair, torus_launches: dict, card: str) -> None:
    """Phase 13: ``mult_t_posterior`` (64 particles, 5 mutations, Newton cap
    25, two stages a run) on phase 11's n = 7e4 spectrum, held to
    ``mult_t_quadrature`` (the reference's gate: 1.0 quadrature sd on every
    class, 0.5 on average), the whole ladder from the same seed the same
    bits; then ``gpc_t_posterior`` on phase 4's torus spectrum near the
    ``gpc_nlp_objective`` grid optimum."""
    from flgp_tpu_torch.fit.multiclass import one_hot_labels
    from flgp_tpu_torch.inference import hyperparam
    from flgp_tpu_torch.models.gpc import gpc_nlp_objective

    m, K, sigma = MNIST["m"], MNIST["K"], 1e-3
    print(f"t-hyperposterior on phase 11's spectrum (mnist_like n={MNIST['n']}, K={K}, "
          f"{mnist_eig.vectors.dtype}; its fit launched {mnist_launches})", flush=True)
    Y = torch.as_tensor(mnist_ds.y_train, dtype=mnist_eig.vectors.dtype, device=dev)
    aug = one_hot_labels(Y, int(torch.max(Y)) + 1)
    idx = torch.arange(m, device=dev)
    kw = {k: v for k, v in SMC_BUDGET.items() if k != "stages_per_dispatch"}
    runs = {}
    for label, spd in (("chunked", SMC_BUDGET["stages_per_dispatch"]), ("whole", None)):
        runs[label] = _counted_run(lambda spd=spd: hyperparam.mult_t_posterior(
            torch.Generator(device=dev).manual_seed(7), mnist_eig, aug, idx, K, sigma,
            stages_per_dispatch=spd, device=dev, **kw))
    post, c = runs["chunked"]
    whole = runs["whole"][0]
    print(f"mult_t_posterior ({SMC_BUDGET['n_particles']} particles, "
          f"{SMC_BUDGET['n_mutation_steps']} mutations, Newton cap {SMC_BUDGET['newton_max_iter']},"
          f" {SMC_BUDGET['stages_per_dispatch']} stages a run): {post.smc.n_stages} stages, "
          f"{_counts_line(c)}; the whole ladder {runs['whole'][1]['wall']:.3f} s [{card}]",
          flush=True)
    same = (post.smc.n_stages == whole.smc.n_stages
            and torch.equal(post.smc.particles, whole.smc.particles)
            and torch.equal(post.smc.temperatures, whole.smc.temperatures)
            and torch.equal(post.log_evidence, whole.log_evidence))
    print(f"  chunked and whole ladder from one seed: particles, temperatures, stages and log "
          f"evidence {'the same bits' if same else 'DIFFER'}", flush=True)
    if not same:
        _fail("mult_t_posterior: the chunked and the whole ladder differ")
    wall, busy, n_acts, syncs = target_evaluation_profile(mnist_eig, aug, idx, K, sigma,
                                                          post.smc.particles)
    print(f"  one target evaluation ({post.smc.particles.shape[0]} particles x {aug.shape[1]} "
          f"classes as Newton lanes, {syncs} host syncs): {wall * 1e3:.3f} ms wall, "
          f"{busy * 1e3:.3f} ms of device activity, busy share {busy / wall:.4f}; "
          f"{n_acts / max(syncs - 1, 1):.1f} device activities a Newton round [{card}]",
          flush=True)
    quad, cq = _counted_run(lambda: hyperparam.mult_t_quadrature(
        mnist_eig, aug, idx, K, sigma, newton_max_iter=SMC_BUDGET["newton_max_iter"],
        device=dev))
    err = (torch.abs(post.t_mean - quad.t_mean) / quad.t_sd).double().cpu().numpy()
    print(f"mult_t_quadrature (256 grid points x {aug.shape[1]} classes, two passes): "
          f"{_counts_line(cq)} [{card}]", flush=True)
    print(f"  t-mean SMC {np.round(post.t_mean.double().cpu().numpy(), 4).tolist()}", flush=True)
    print(f"  t-mean quadrature {np.round(quad.t_mean.double().cpu().numpy(), 4).tolist()}, "
          f"t-sd {np.round(quad.t_sd.double().cpu().numpy(), 4).tolist()}", flush=True)
    print(f"  |SMC − quadrature| / quadrature sd: max {err.max():.4f} (gate 1.0), mean "
          f"{err.mean():.4f} (gate 0.5); coarse max weight {float(quad.coarse_max_weight):.4f} "
          f"(gate 0.5); log evidence SMC {float(post.log_evidence):.4f}, quadrature "
          f"{float(quad.log_evidence):.4f}", flush=True)
    if not float(quad.coarse_max_weight) < 0.5:
        _fail(f"quadrature coarse max weight {float(quad.coarse_max_weight)} >= 0.5")
    if not (err.max() < 1.0 and err.mean() < 0.5):
        _fail(f"SMC t-means off the quadrature: max {err.max()}, mean {err.mean()} sd")
    if not (np.isfinite(float(post.log_evidence)) and np.isfinite(float(quad.log_evidence))):
        _fail("non-finite log evidence")

    tor = SHAPES["torus"]
    ds = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    mt, Kt = tor["m"], tor["K"]
    Yt = torch.as_tensor(ds.y_train, dtype=torus_eig.vectors.dtype, device=dev)
    tpost, ct = _counted_run(lambda: hyperparam.gpc_t_posterior(
        torch.Generator(device=dev).manual_seed(8), torus_eig, Yt, torch.arange(mt, device=dev),
        Kt, sigma, n_particles=64, device=dev))
    # the reference test's grid, exp(linspace(−2, 5, 60)), ends at t = 148, below the
    # torus fit's t (~4e3): the grid here spans the same spacing out to e^10
    ts = torch.exp(torch.linspace(-2, 10, 103, dtype=torus_eig.vectors.dtype, device=dev))
    objs = gpc_nlp_objective(torus_eig, Yt, torch.ones_like(Yt), torch.arange(mt, device=dev),
                             Kt, ts, sigma)
    t_star = float(ts[int(torch.argmin(objs))])
    gap = abs(float(np.log(float(tpost.t_mean))) - np.log(t_star))
    print(f"gpc_t_posterior (torus spectrum of phase 4, whose fit launched {torus_launches}; 64 "
          f"particles): {tpost.smc.n_stages} stages, {_counts_line(ct)}; t-mean "
          f"{float(tpost.t_mean):.5g}, sd {float(tpost.t_sd):.4g}, grid optimum {t_star:.5g}, "
          f"|log gap| {gap:.4f} (gate 1.5) [{card}]", flush=True)
    if not (gap < 1.5 and np.isfinite(float(tpost.log_evidence))):
        _fail(f"gpc_t_posterior: log t-mean {gap} from the grid optimum, or non-finite evidence")


# phase 14: SVI on the torus posterior of phase 12: mean-field at the JAX
# package's budget (bench.py:bench_svi, 8000 steps) and the low-rank family at
# the same 8000 (the JAX package runs 16000): both families arrive between
# steps 6000 and 8000 on the card's stream and stay flat (the ELBO by step is
# printed), and equal steps are what comparing the two asks for
SVI = dict(mf_steps=8000, lr_steps=8000, rank=5, n_mc=8, lr=0.02)


def svi_phase(dev, sampling: dict, card: str) -> None:
    """Phase 14: ``fit_svi`` and ``fit_svi_lowrank`` on phase 12's torus GPC
    posterior, held to phase 12's HMC draws (16 × 512, split-R̂ < 1.1):
    mean-field within 1.0 reference sd at every coordinate and its median sd
    ratio in (0.6, 1.6); the low-rank family's numbers (F5) reported."""
    from flgp_tpu_torch.inference.svi import fit_svi, fit_svi_lowrank

    post = sampling["post"]
    S = sampling["hmc_draws"].double().reshape(-1, post.dim).cpu().numpy()
    mu_ref, sd_ref = S.mean(0), S.std(0)
    print(f"SVI on phase 12's torus posterior (dim {post.dim}; the fit launched "
          f"{sampling['launches']}); reference moments from {S.shape[0]} HMC draws", flush=True)
    fits = {}
    for name, fn, steps, kw in (("mean-field", fit_svi, SVI["mf_steps"], {}),
                                ("low-rank", fit_svi_lowrank, SVI["lr_steps"],
                                 {"rank": SVI["rank"]})):
        t0 = _synced()
        res = fn(torch.Generator(device=dev).manual_seed(21), post, post.dim, steps=steps,
                 n_mc=SVI["n_mc"], lr=SVI["lr"], device=dev, **kw)
        wall = _synced() - t0
        q = res.posterior
        mu = q.mu.double().cpu().numpy()
        sd = np.sqrt(torch.diagonal(q.covariance()).double().cpu().numpy())
        trace = res.elbo_trace.double().cpu().numpy()
        tail = trace[-50:]
        f = dict(wall=wall, steps=steps, err=np.abs(mu - mu_ref) / sd_ref,
                 ratio=float(np.median(sd / sd_ref)), elbo=float(tail.mean()),
                 elbo_sd=float(tail.std()), finite=bool(np.all(np.isfinite(mu))
                                                        and np.all(np.isfinite(sd))
                                                        and np.all(np.isfinite(tail))))
        fits[name] = f
        print(f"  {name} ({steps} steps, n_mc {SVI['n_mc']}, lr {SVI['lr']}): {wall:.3f} s, "
              f"{steps / wall:.1f} steps/s; max |mu − mu_ref| / sd_ref {f['err'].max():.4f}, "
              f"mean {f['err'].mean():.4f}; median sd ratio {f['ratio']:.4f}; ELBO (mean of the "
              f"last 50) {f['elbo']:.4f}, their sd {f['elbo_sd']:.4f}; ELBO by step "
              + ", ".join(f"{i}: {trace[i - 50:i].mean():.2f}" for i in range(2000, steps + 1, 2000))
              + f" [{card}]", flush=True)
    mf, lr = fits["mean-field"], fits["low-rank"]
    print(f"  low-rank ELBO gain over mean-field {lr['elbo'] - mf['elbo']:.4f} (Monte Carlo "
          f"sd of each mean ~{np.hypot(mf['elbo_sd'], lr['elbo_sd']) / np.sqrt(50):.4f}); "
          f"F5 reported, not gated", flush=True)
    if not (mf["finite"] and lr["finite"]):
        _fail("an SVI family has non-finite parameters or ELBO")
    if not (mf["err"].max() <= 1.0 and 0.6 < mf["ratio"] < 1.6):
        _fail(f"mean-field SVI: max mean error {mf['err'].max()} sd, median sd ratio "
              f"{mf['ratio']}")


# phase 15: the goldens on the reference's own data, the instrumented fit and
# the resumable grid
GOLDEN_TORUS = {"fit_lae_logit_gp": 0.015, "fit_se_logit_gp": 0.005}
GOLDEN_SPIRAL = {"fit_lae_regression_gp": (0.4582, 8e-3, "lae", MAIN_PATH),
                 "fit_se_regression_gp": (0.5032, 1.5e-3, "se", ("knn", "ell_matmat"))}


def _launched(name: str, launches: dict, need) -> None:
    missing = [k for k in need if launches.get(k, 0) == 0]
    if missing:
        _fail(f"{name} launched no {missing} kernel: {launches}")


def golden_phase(dev, phase4, card: str) -> None:
    """Phase 15: the README goldens on the R-stream data (torus) and on the
    R session's anchors (spiral; float64 with the plain versions, then the
    float32 graph with the kernels), ``fit_lae_logit_gp(report=...)`` under
    ``profiler_trace`` against phase 4's outputs bit for bit, and the
    resumable SE grid stopped after 4 of 10 points and resumed."""
    from flgp_tpu_torch.datasets import spiral_r, spiral_r_anchors, torus_rings_r
    from flgp_tpu_torch.fit.resumable import fit_se_regression_gp_resumable
    from flgp_tpu_torch.utils.metrics import MetricsReport, profiler_trace

    tor = SHAPES["torus"]
    graph = ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"])
    tds = torus_rings_r()
    for name, gate in GOLDEN_TORUS.items():
        f = entry_fit(name, tds, torus_fit_cfg(), dev, seed=0, cold_and_warm=False)
        _report_fit(name, "torus_rings_r, f32 graph, f64 tail", f)
        _launched(name, f["launches"], MAIN_PATH if "_lae_" in name else ("knn", "ell_matmat"))
        print(f"  golden gate: err {f['score']:.6f} <= {gate}", flush=True)
        if f["score"] > gate:
            _fail(f"{name} on torus_rings_r: err {f['score']} > {gate}")

    t0 = time.perf_counter()
    sds, anchors = spiral_r(), spiral_r_anchors()
    print(f"spiral_r and spiral_r_anchors (the R session replayed on the host): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sp = SPIRAL
    for name, (golden, tol, key, need) in GOLDEN_SPIRAL.items():
        scores = {}
        for dtype in (torch.float64, torch.float32):
            cfg = ft.FitConfig(graph=ft.GraphConfig(s=sp["s"], r=sp["r"], K=sp["K"]),
                               sigma=1e-5, dtype=dtype,
                               solve_dtype=torch.float64 if dtype == torch.float32 else None)
            hk.reset_launches()
            t0 = _synced()
            res = getattr(ft, name)(torch.Generator(device=dev).manual_seed(0), sds.x_train,
                                    sds.y_train, sds.x_test, cfg=cfg, anchors=anchors[key],
                                    device=dev)
            wall = _synced() - t0
            launches = {k: v for k, v in hk.LAUNCHES.items() if v}
            scores[dtype] = float(np.sqrt(np.mean((res.y_test - sds.y_test) ** 2)))
            what = ("float64, plain versions" if dtype == torch.float64
                    else "float32 graph, float64 tail")
            print(f"{name} (spiral_r on the R session's anchors, {what}): rmse "
                  f"{scores[dtype]:.6f}, {wall:.3f} s, launches {launches} [{card}]", flush=True)
            if dtype == torch.float64:
                if launches:
                    _fail(f"{name} in float64 launched kernels: {launches}")
                if not abs(scores[dtype] - golden) < tol:
                    _fail(f"{name}: float64 rmse {scores[dtype]} not within {tol} of {golden}")
            else:
                _launched(name, launches, need)
        gate = scores[torch.float64] + 0.01
        print(f"  golden gates: float64 |rmse − {golden}| {abs(scores[torch.float64] - golden):.6f}"
              f" < {tol}; float32 rmse {scores[torch.float32]:.6f} <= {gate:.6f}", flush=True)
        if scores[torch.float32] > gate:
            _fail(f"{name}: float32 rmse {scores[torch.float32]} > {gate}")

    # the instrumented torus fit from phase 4's seed, under a profiler trace
    ds = torus_rings(n=tor["n"], m_train=tor["m"], seed=tor["seed"])
    report = MetricsReport()
    hk.reset_launches()
    with tempfile.TemporaryDirectory(prefix="flgp_phase15_") as tmp:
        with profiler_trace(tmp):
            res = ft.fit_lae_logit_gp(torch.Generator(device=dev).manual_seed(0), ds.x_train,
                                      ds.y_train, ds.x_test, cfg=torus_fit_cfg(), report=report,
                                      device=dev)
        traces = [p for p in Path(tmp).iterdir() if p.suffix == ".json" and p.stat().st_size]
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    same = (all(np.array_equal(getattr(res, nm), getattr(phase4, nm)) for nm in
                ("y_train", "y_test", "posterior_mean", "posterior_cov"))
            and np.array_equal(res.pars["t"], phase4.pars["t"]) and res.obj == phase4.obj
            and torch.equal(res.eigenpair.vectors, phase4.eigenpair.vectors))
    print(f"fit_lae_logit_gp(report=MetricsReport()) from phase 4's seed under profiler_trace: "
          f"outputs {'the same bits as phase 4' if same else 'DIFFER from phase 4'}; launches "
          f"{launches}; {len(traces)} trace file(s)", flush=True)
    print("  stages (s): " + "  ".join(f"{s.name} {s.wall_s:.4f}" for s in report.stages)
          + f"; metrics {res.metrics} [{card}]", flush=True)
    _launched("the instrumented fit", launches, MAIN_PATH)
    if not same:
        _fail("fit_lae_logit_gp(report=...) differs from the plain fit of phase 4")
    if not traces:
        _fail("profiler_trace left no trace file")

    # the resumable SE grid, stopped after 4 of 10 points and resumed
    spd = spiral(n=sp["n"], m_train=sp["m"], seed=1234)
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=sp["s"], r=sp["r"], K=sp["K"]), sigma=1e-5,
                       dtype=torch.float32, solve_dtype=torch.float64)
    with tempfile.TemporaryDirectory(prefix="flgp_phase15_") as tmp:
        walls = {}
        for label in ("full", "resumed"):
            if label == "resumed":
                for i in range(4):
                    shutil.copytree(f"{tmp}/full/a2_{i}", f"{tmp}/resumed/a2_{i}")
            hk.reset_launches()
            t0 = _synced()
            out = fit_se_regression_gp_resumable(torch.Generator(device=dev).manual_seed(0),
                                                 spd.x_train, spd.y_train, spd.x_test,
                                                 f"{tmp}/{label}", cfg, device=dev)
            walls[label] = (_synced() - t0, {k: v for k, v in hk.LAUNCHES.items() if v})
            if label == "full":
                full = out
    same = (all(np.array_equal(getattr(out, nm), getattr(full, nm)) for nm in
                ("y_train", "y_test", "posterior_mean", "posterior_cov"))
            and all(np.array_equal(out.pars[k], full.pars[k]) for k in full.pars)
            and out.obj == full.obj)
    rmse = float(np.sqrt(np.mean((full.y_test - spd.y_test) ** 2)))
    print(f"fit_se_regression_gp_resumable (spiral, 10 bandwidths): {walls['full'][0]:.3f} s, "
          f"rmse {rmse:.6f}, a2 {float(full.pars['a2']):.4g}, launches {walls['full'][1]}; "
          f"stopped after 4 and resumed: {walls['resumed'][0]:.3f} s, outputs "
          f"{'the same bits' if same else 'DIFFER'} [{card}]", flush=True)
    _launched("fit_se_regression_gp_resumable", walls["full"][1], ("knn", "ell_matmat"))
    if not same:
        _fail("the resumed grid differs from the run that was not stopped")


# phase 16: the out-of-core fits, X read from a FLGP0001 file in row chunks
OOC_PASSES = ("count pass", "graph pass")      # the two _stream_chunks passes of a fit, in order
OOC_STAGES = {"reservoir_sample": "reservoir pass", "kmeans": "k-means",
              "spectrum_fused": "spectrum", "_train_gpc": "train", "_gpc_lowrank_tail": "tail"}


class RecordedFile(native.MatrixFile):
    """A MatrixFile that records every read as (start, count)."""

    def __init__(self, path):
        super().__init__(path)
        self.reads = []

    def read(self, start, count):
        self.reads.append((start, count))
        return super().read(start, count)

    def read_into(self, start, count, data_ptr):
        self.reads.append((start, count))
        return super().read_into(start, count, data_ptr)


class StageTimes:
    """Wraps the stage functions of ``fit.streaming`` for one fit with
    device-synced timers (and counts k-means' K1 launches); restores them on
    exit.  The wrapped functions compute what they computed."""

    def __init__(self):
        self.times, self.kmeans_knn = {}, 0

    def __enter__(self):
        self.saved = {name: getattr(streaming, name) for name in [*OOC_STAGES, "_stream_chunks"]}
        passes = iter(OOC_PASSES)
        for name, fn in self.saved.items():
            def timed(*a, _fn=fn, _name=name, **k):
                label = OOC_STAGES.get(_name) or next(passes)
                knn0, t0 = hk.LAUNCHES["knn"], _synced()
                out = _fn(*a, **k)
                self.times[label] = self.times.get(label, 0.0) + _synced() - t0
                if _name == "kmeans":
                    self.kmeans_knn += hk.LAUNCHES["knn"] - knn0
                return out
            setattr(streaming, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(streaming, name, fn)


def huge_fit_cfg():
    cfg = SHAPES["huge"]
    return ft.FitConfig(graph=ft.GraphConfig(s=cfg["s"], r=cfg["r"], K=cfg["K"]), sigma=1e-3,
                        n_gibbs=50, gibbs_avg_sweeps=25, dtype=torch.float32,
                        solve_dtype=torch.float64)


def _timed(fn):
    t0 = _synced()
    out = fn()
    return out, _synced() - t0


def side_stream_graph_pass(mat, U, g, chunk: int, thread: bool) -> tuple:
    """The n=1e7 graph pass with the copies on a side stream, a yardstick for
    ``fit.streaming``'s pipeline: two pinned and two device buffers, events
    ordering each copy before its chunk's K1 and each buffer's reuse after
    its last reader, ``madvise`` read-ahead of the next chunk, the reads
    inline or (``thread``) by a reader thread handing buffers over through
    queues.  Returns (values, indices)."""
    import queue
    import threading

    n, d = mat.shape
    host = [torch.empty((chunk, d), dtype=torch.float32, pin_memory=True) for _ in range(2)]
    dev = [torch.empty((chunk, d), dtype=torch.float32, device=U.device) for _ in range(2)]
    vals = torch.empty((n, g.r), dtype=torch.float32, device=U.device)
    idx = torch.empty((n, g.r), dtype=torch.int32, device=U.device)
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    filled, free = queue.Queue(), queue.Queue()
    for b in range(2):
        free.put((b, None))
    starts = range(0, n, chunk)

    def fill():
        lo = next(pending)
        b, copied = free.get()
        if copied is not None:
            copied.synchronize()
        mat.prefetch(lo + chunk, chunk)
        filled.put((lo, mat.read_into(lo, chunk, host[b].data_ptr()), b))

    pending = iter(starts)
    if thread:
        reader = threading.Thread(target=lambda: [fill() for _ in starts], daemon=True)
        reader.start()
    consumed = [None, None]
    for _ in starts:
        if not thread:
            fill()
        lo, rows, b = filled.get()
        with torch.cuda.stream(side):
            if consumed[b] is not None:
                side.wait_event(consumed[b])
            dev[b][:rows].copy_(host[b][:rows], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        free.put((b, copied))
        main.wait_event(copied)
        res = knn(dev[b][:rows], U, g.r)
        vals[lo:lo + rows] = lae_weights(dev[b][:rows], U, res.indices)
        idx[lo:lo + rows] = res.indices
        consumed[b] = torch.cuda.Event()
        consumed[b].record(main)
    if thread:
        reader.join()
    main.wait_stream(side)
    return vals, idx


def streamed_fit_phase(dev, huge: dict, tmp: str, card: str) -> dict:
    """Phase 16 at n = 1e7: the file, its read rate, the streamed spectrum
    against the in-memory one on the warm anchors (the same bits), the graph
    pass overlapped, serial and in memory, then ``fit_lae_logit_gp_streamed``
    from the file with its own subsampler, stage by stage."""
    cfg = SHAPES["huge"]
    n, m, chunk = cfg["n"], cfg["m"], cfg["chunk"]
    chunks = -(-n // chunk)
    ds = huge["ds"]
    X_all = np.concatenate([ds.x_train, ds.x_test]).astype(np.float32)
    path = f"{tmp}/torus_1e7.flgp"
    _, write_s = _timed(lambda: native.write_matrix(path, X_all))
    mat = RecordedFile(path)
    buf = torch.empty((chunk, X_all.shape[1]), dtype=torch.float32, pin_memory=True)
    t0 = time.perf_counter()
    for lo in range(0, n, chunk):
        mat.read_into(lo, chunk, buf.data_ptr())
    read_s = time.perf_counter() - t0
    print(f"n=1e7 file ({X_all.nbytes / 1e6:.1f} MB, float32): written in {write_s:.3f} s; one "
          f"pass of {chunks} chunk reads into pinned memory {read_s:.3f} s = "
          f"{X_all.nbytes / read_s / 1e9:.3f} GB/s [{card}]", flush=True)

    g = huge_fit_cfg().graph
    U = huge["anchors"].contiguous()
    sub = SubsampleResult(U, huge["counts"])
    X_dev = torch.as_tensor(X_all, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    mem, mem_s = _timed(lambda: build_spectrum(gen, X_dev, g, anchors=sub)[0])
    st, st_s = _timed(lambda: streaming.streamed_build_spectrum(gen, mat, g, chunk, anchors=sub,
                                                                   device=dev)[0])
    same = torch.equal(st.values, mem.values) and torch.equal(st.vectors, mem.vectors)
    print(f"n=1e7 streamed_build_spectrum on the warm anchors {st_s:.3f} s, in-memory "
          f"build_spectrum {mem_s:.3f} s: values and vectors "
          f"{'the same bits' if same else 'DIFFER'}", flush=True)
    if not same:
        _fail("the streamed n=1e7 spectrum is not the in-memory spectrum's bits")
    del mem

    # the graph pass alone, in turns after a warm-up of each: overlapped,
    # serial, fed by a reader thread, and the in-memory graph
    def in_memory():
        idx = knn(X_dev, U, g.r).indices
        return lae_weights(X_dev, U, idx), idx

    passes = {"overlapped": lambda: streaming.streamed_ell_graph(mat, U, g, chunk),
              "serial": lambda: streaming.streamed_ell_graph(mat, U, g, chunk, _overlap=False),
              "side stream": lambda: EllMatrix(*side_stream_graph_pass(mat, U, g, chunk, False),
                                               g.s),
              "side stream fed by a reader thread":
                  lambda: EllMatrix(*side_stream_graph_pass(mat, U, g, chunk, True), g.s),
              "in memory (X on the card, one K1 and one K2 launch)":
                  lambda: EllMatrix(*in_memory(), g.s)}
    graphs = {name: fn() for name, fn in passes.items()}
    times = {name: [] for name in passes}
    for name in [*passes, *reversed(passes)]:
        times[name].append(_timed(passes[name])[1])
    Z = graphs["overlapped"]
    same = all(torch.equal(Z.values, G.values) and torch.equal(Z.indices, G.indices)
               for G in graphs.values())
    print(f"n=1e7 graph pass ({chunks} chunks of {chunk}, two turns each): " + ", ".join(
        f"{name} {a:.4f}, {b:.4f} s" for name, (a, b) in times.items())
        + f"; the graphs {'the same bits' if same else 'DIFFER'} [{card}]", flush=True)
    if not same:
        _fail("the n=1e7 graphs of the passes and of the in-memory graph differ")
    del graphs

    # the same two passes from a cold file: its pages dropped from the page
    # cache before each turn (fsync, then POSIX_FADV_DONTNEED on a file no
    # mapping holds), and a cold read of every chunk for the disk's rate
    def cold(fn):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        with native.MatrixFile(path) as fresh:
            return _timed(lambda: fn(fresh))[1]

    def read_all(f):
        for lo in range(0, n, chunk):
            f.read_into(lo, chunk, buf.data_ptr())

    cold_passes = {"read": read_all,
                   "overlapped": lambda f: streaming.streamed_ell_graph(f, U, g, chunk),
                   "serial": lambda f: streaming.streamed_ell_graph(f, U, g, chunk, _overlap=False)}
    cold_s = {name: [] for name in cold_passes}
    for name in [*cold_passes, *reversed(cold_passes)]:
        cold_s[name].append(cold(cold_passes[name]))
    print(f"n=1e7 from a cold file (two turns each): chunk reads alone "
          f"{cold_s['read'][0]:.4f}, {cold_s['read'][1]:.4f} s = "
          f"{X_all.nbytes / min(cold_s['read']) / 1e9:.3f} GB/s at best; graph pass overlapped "
          f"{cold_s['overlapped'][0]:.4f}, {cold_s['overlapped'][1]:.4f} s, serial "
          f"{cold_s['serial'][0]:.4f}, {cold_s['serial'][1]:.4f} s [{card}]", flush=True)

    # the fit from the file, with its own subsampler
    mat.reads.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    hk.reset_launches()
    with StageTimes() as stages:
        res, fit_s = _timed(lambda: streaming.fit_lae_logit_gp_streamed(
            torch.Generator(device=dev).manual_seed(160), mat, ds.y_train, np.arange(m),
            cfg=huge_fit_cfg(), chunk_rows=chunk, device=dev))
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    t = float(res.pars["t"])
    for nm in ("labels", "probs", "post_mean", "post_var"):
        arr = getattr(res, nm)
        if arr.shape != (n,) or not bool(torch.all(torch.isfinite(arr))):
            _fail(f"fit_lae_logit_gp_streamed {nm}: shape {tuple(arr.shape)} or non-finite values")
    y_test = torch.as_tensor(ds.y_test, dtype=res.labels.dtype, device=dev)
    err = float(torch.mean((res.labels[m:] != y_test).double()))
    longest = max(c for _, c in mat.reads)
    print(f"fit_lae_logit_gp_streamed (n=1e7 from the file, chunk {chunk}): err {err:.6f}  t "
          f"{t:.6g}  wall {fit_s:.3f} s  [" + "  ".join(f"{k} {v:.3f}" for k, v in
                                                      stages.times.items())
          + f"]  peak memory {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} over the "
          f"{held / 2**30:.2f} held before)  launches {launches} (k-means "
          f"{stages.kmeans_knn} of the knn)  {len(mat.reads)} reads, the longest {longest} rows "
          f"[{card}]", flush=True)
    want_knn = 2 * chunks + stages.kmeans_knn
    if not (err <= ERR_GATE and np.isfinite(t)):
        _fail(f"n=1e7 streamed fit: err {err} (gate {ERR_GATE}), t {t}")
    if launches.get("knn") != want_knn or launches.get("lae_weights") != chunks:
        _fail(f"n=1e7 streamed fit launched {launches}: want knn {want_knn}, lae_weights {chunks}")
    if longest > chunk or len(mat.reads) != 3 * chunks:
        _fail(f"n=1e7 streamed fit read {len(mat.reads)} times, the longest {longest} rows")
    del res
    return dict(mat=mat, Z=Z, spectrum=st, sub=sub, X_dev=X_dev, g=g)


def streamed_entry_fits(dev, tmp: str, card: str) -> dict:
    """Phase 16 at the repo's shapes: the streamed GPR on the spiral and the
    streamed multiclass GPC on mnist_like, each from a file in chunks."""
    from flgp_tpu_torch.datasets import mnist_like

    out = {}
    sp = spiral(n=SPIRAL["n"], m_train=SPIRAL["m"])
    cfg = ft.FitConfig(graph=ft.GraphConfig(s=SPIRAL["s"], r=SPIRAL["r"], K=SPIRAL["K"]),
                       sigma=1e-5, dtype=torch.float32, solve_dtype=torch.float64)
    path = f"{tmp}/spiral.flgp"
    native.write_matrix(path, np.concatenate([sp.x_train, sp.x_test]).astype(np.float32))
    with native.MatrixFile(path) as mat:
        hk.reset_launches()
        (pred, pars), wall = _timed(lambda: streaming.fit_lae_regression_gp_streamed(
            torch.Generator(device=dev).manual_seed(0), mat, sp.y_train, np.arange(SPIRAL["m"]),
            cfg=cfg, chunk_rows=1024, device=dev))
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    rmse = float(np.sqrt(np.mean((pred[SPIRAL["m"]:].cpu().numpy() - sp.y_test) ** 2)))
    gate = RMSE_GATES["fit_lae_regression_gp"]
    print(f"fit_lae_regression_gp_streamed (spiral n=4000, m=200, chunks of 1024): rmse "
          f"{rmse:.6f} (gate {gate})  t {float(pars['t']):.6g}  noise {float(pars['noise']):.6g}  "
          f"{wall:.3f} s  launches {launches}", flush=True)
    if not (rmse <= gate and bool(torch.all(torch.isfinite(pred)))):
        _fail(f"fit_lae_regression_gp_streamed spiral rmse {rmse} > {gate}")
    out["spiral"] = dict(ds=sp, cfg=cfg, t=pars["t"], noise=pars["noise"])

    ds = mnist_like(n=MNIST["n"], m_train=MNIST["m"], seed=MNIST["seed"])
    path = f"{tmp}/mnist.flgp"
    native.write_matrix(path, np.concatenate([ds.x_train, ds.x_test]).astype(np.float32))
    with native.MatrixFile(path) as mat:
        hk.reset_launches()
        res, wall = _timed(lambda: streaming.fit_lae_logit_mult_gp_streamed(
            torch.Generator(device=dev).manual_seed(0), mat, ds.y_train, np.arange(MNIST["m"]),
            cfg=mult_cfg(MNIST, torch.float32), chunk_rows=1 << 14, device=dev))
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    err = float(np.mean(res.labels[MNIST["m"]:].cpu().numpy() != ds.y_test))
    print(f"fit_lae_logit_mult_gp_streamed (mnist_like n=70000, d=16, J=10, chunks of 16384): "
          f"err {err:.6f} (gate {ERR_GATE})  {wall:.3f} s  launches {launches}", flush=True)
    if not (err <= ERR_GATE and res.probs.shape == (10, MNIST["n"])
            and bool(torch.all(torch.isfinite(res.post_var)))):
        _fail(f"fit_lae_logit_mult_gp_streamed mnist err {err} or outputs")
    return out


# phase 17: the multi-device layer at world size 1 under NCCL
PARALLEL_SAMPLERS = dict(chains=16, hmc=(64, 128), nuts=(32, 16), chees=(256, 64))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multidevice_phase(dev, ooc: dict, fits: dict, phase4, sampling: dict, card: str) -> None:
    """Phase 17: ``init_distributed`` from FLGP_* on localhost (NCCL, world
    size 1), the sharded spectrum from phase 16's streamed graph and from X
    (the same bits as the streamed and the in-memory spectrum), the sharded
    GPR objective and prediction on the spiral and the sharded Laplace tail
    on the torus against their single-process versions, chain-sharded HMC,
    NUTS and ChEES on phase 12's posterior against its HMC moments, and
    particle-sharded SMC against ``run_smc``, bit for bit."""
    import torch.distributed as dist

    from flgp_tpu_torch.inference.smc import run_smc
    from flgp_tpu_torch.models import gpr as gpr_mod
    from flgp_tpu_torch.parallel import gpc as pgpc
    from flgp_tpu_torch.parallel import mcmc as pmcmc
    from flgp_tpu_torch.parallel import mesh as pmesh
    from flgp_tpu_torch.parallel import spectral as pspec
    from flgp_tpu_torch.parallel.smc import sharded_smc_fn

    os.environ.update(FLGP_COORDINATOR=f"127.0.0.1:{_free_port()}", FLGP_NUM_PROCESSES="1",
                      FLGP_PROCESS_ID="0")
    try:
        if not pmesh.init_distributed():
            _fail("init_distributed did not start from the FLGP_* environment")
        probe = torch.arange(4.0, device=dev)
        dist.all_reduce(probe)
        print(f"init_distributed: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, an all_reduce on the card "
              f"{'leaves' if torch.equal(probe, torch.arange(4.0, device=dev)) else 'CHANGES'} "
              f"its tensor", flush=True)
        if dist.get_backend() != "nccl" or not torch.equal(probe, torch.arange(4.0, device=dev)):
            _fail("the process group is not a working NCCL group")
        data, chain = pmesh.global_mesh(("data",)), pmesh.global_mesh(("chain",))
        g, sub, st, Z = ooc["g"], ooc["sub"], ooc["spectrum"], ooc["Z"]

        hk.reset_launches()
        (v1, V1), s1 = _timed(lambda: pspec.sharded_spectrum_from_ell_fn(data, g)(
            Z.values, Z.indices, sub.counts))
        l1 = {k: v for k, v in hk.LAUNCHES.items() if v}
        same1 = torch.equal(v1, st.values) and torch.equal(V1, st.vectors)
        del V1
        hk.reset_launches()
        (v2, V2), s2 = _timed(lambda: pspec.sharded_spectrum_fn(data, g)(
            ooc["X_dev"], sub.centers, sub.counts))
        l2 = {k: v for k, v in hk.LAUNCHES.items() if v}
        same2 = torch.equal(v2, st.values) and torch.equal(V2, st.vectors)
        del V2
        print(f"sharded_spectrum_from_ell_fn on phase 16's graph: {s1:.3f} s, launches {l1}, "
              f"{'the same bits as' if same1 else 'DIFFERS from'} the streamed spectrum; "
              f"sharded_spectrum_fn on X: {s2:.3f} s, launches {l2}, "
              f"{'the same bits as' if same2 else 'DIFFERS from'} the in-memory spectrum "
              f"[{card}]", flush=True)
        if not (same1 and same2):
            _fail("a world-size-1 sharded spectrum is not the single-device spectrum's bits")

        # GPR on the spiral: the sharded Woodbury objective and prediction
        sp = fits["spiral"]
        ds, m = sp["ds"], SPIRAL["m"]
        X_sp = torch.as_tensor(np.concatenate([ds.x_train, ds.x_test]), dtype=torch.float32,
                               device=dev)
        eig, _ = build_spectrum(torch.Generator(device=dev).manual_seed(0), X_sp, sp["cfg"].graph)
        values, vectors = eig.values.double(), eig.vectors.double()
        n_sp, K = vectors.shape[0], SPIRAL["K"]
        mask = torch.zeros(n_sp, dtype=torch.float64, device=dev)
        mask[:m] = 1.0
        Y = torch.zeros(n_sp, dtype=torch.float64, device=dev)
        Y[:m] = torch.as_tensor(ds.y_train, dtype=torch.float64, device=dev)
        t, noise, sigma = sp["t"].double(), sp["noise"].double(), sp["cfg"].sigma
        nm_sh = pspec.sharded_gpr_nmll_fn(data, K, sigma)(values, vectors, Y, mask, t, noise)
        train = torch.arange(m, device=dev)
        nm = gpr_mod.gpr_nmll(EigenPair(values, vectors), Y[:m], train, K, t, noise, sigma)
        pr_sh = pspec.sharded_predict_fn(data, K, sigma)(values, vectors, Y, mask, t, noise)
        pr = gpr_mod.gpr_predict(EigenPair(values, vectors), Y[:m], train,
                                 torch.arange(n_sp, device=dev), K, t, noise, sigma)
        nm_rel = abs(float(nm_sh) - float(nm)) / abs(float(nm))
        print(f"sharded GPR on the spiral (n=4000, m=200, K=100, float64, the streamed fit's t "
              f"and noise): NMLL {float(nm_sh):.10g} vs gpr_nmll {float(nm):.10g} (relative "
              f"{nm_rel:.2e}, gate 1e-8); prediction max abs diff {_maxabs(pr_sh, pr):.2e} "
              f"(gate 1e-6 + 1e-6 |pred|)", flush=True)
        if not nm_rel <= 1e-8:
            _fail(f"sharded GPR NMLL differs from gpr_nmll by {nm_rel:.2e}")
        _allclose("sharded GPR prediction", pr_sh, pr, 1e-6, 1e-6)

        # the sharded Laplace tail at phase 4's trained t
        tor = SHAPES["torus"]
        eig4 = phase4.eigenpair
        m4, K4 = tor["m"], tor["K"]
        v4, V4 = eig4.values.double(), eig4.vectors.double()
        mask4 = torch.zeros(V4.shape[0], dtype=torch.float64, device=dev)
        mask4[:m4] = 1.0
        Y4 = torch.zeros_like(mask4)
        Y4[:m4] = torch.as_tensor(sampling["y_train"], dtype=torch.float64, device=dev)
        t4 = torch.as_tensor(float(phase4.pars["t"]), dtype=torch.float64, device=dev)
        amll, mean, var, _ = pgpc.sharded_gpc_laplace_fn(data, K4, 1e-3)(v4, V4, Y4, mask4, mask4,
                                                                       t4)
        ref_mean = torch.as_tensor(phase4.posterior_mean, device=dev)
        ref_var = torch.as_tensor(phase4.posterior_cov, device=dev)
        print(f"sharded_gpc_laplace_fn on the torus at phase 4's t {float(t4):.6g}: amll "
              f"{float(amll):.8g}; test-row mean max abs diff from phase 4's Laplace moments "
              f"{_maxabs(mean[m4:], ref_mean):.2e}, variance {_maxabs(var[m4:], ref_var):.2e} "
              f"(gate rtol 1e-5, atol 1e-8)", flush=True)
        _allclose("sharded Laplace mean", mean[m4:], ref_mean, 1e-5, 1e-8)
        _allclose("sharded Laplace variance", var[m4:], ref_var, 1e-5, 1e-8)

        # chain-sharded samplers on phase 12's posterior
        post, gp, ref = sampling["post"], sampling["gp"], sampling["hmc_moments"]
        c = PARALLEL_SAMPLERS
        x0 = 0.1 * torch.randn((c["chains"], post.dim), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(17))
        runs = {"hmc": pmcmc.sharded_hmc_fn(chain, post, *c["hmc"], n_leapfrog=16),
                "nuts": pmcmc.sharded_nuts_fn(chain, post, *c["nuts"]),
                "chees": pmcmc.sharded_chees_fn(chain, post, *c["chees"])}
        for name, fn in runs.items():
            run, wall = _timed(lambda fn=fn: fn(torch.Generator(device=dev).manual_seed(170), x0))
            mean, _ = pmcmc.pooled_mean_variance(chain, run.samples)
            mo = f_moments(gp, run.samples)
            tol = 6.0 * np.sqrt(mo["mc"] ** 2 + ref["mc"] ** 2) + 0.05
            gap = float(np.max(np.abs(mo["mean"] - ref["mean"]) / tol))
            finite = bool(torch.all(torch.isfinite(run.samples))) and bool(
                torch.all(torch.isfinite(mean)))
            print(f"sharded {name} ({c['chains']} chains, {c[name][0]} warmup, {c[name][1]} "
                  f"draws): {wall:.3f} s, finite {finite}, f's mean at the train points vs phase "
                  f"12's HMC: max gap / bound {gap:.3f} [{card}]", flush=True)
            if not finite or gap > 1.0:
                _fail(f"sharded {name}: finite {finite}, max gap / bound {gap:.3f}")

        # particle-sharded SMC against run_smc on one generator
        mu = torch.tensor([1.0, -0.5], device=dev)

        def log_prior(x):
            return -0.5 * torch.sum(x * x, dim=-1)

        def log_like(x):
            return -torch.sum((x - mu) ** 2, dim=-1)

        x0 = torch.randn((4096, 2), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        ref_smc, ref_s = _timed(lambda: run_smc(torch.Generator(device=dev).manual_seed(2),
                                                log_prior, log_like, x0))
        got, got_s = _timed(lambda: sharded_smc_fn(chain, log_prior, log_like)(
            torch.Generator(device=dev).manual_seed(2), x0))
        same = (got.n_stages == ref_smc.n_stages and torch.equal(got.particles, ref_smc.particles)
                and torch.equal(got.log_evidence, ref_smc.log_evidence))
        print(f"sharded_smc_fn (4096 particles, HMC mutation, {got.n_stages} stages): {got_s:.3f} "
              f"s, run_smc {ref_s:.3f} s; particles and evidence "
              f"{'the same bits' if same else 'DIFFER'}", flush=True)
        if not same:
            _fail("sharded_smc_fn at world size 1 is not run_smc's bits")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def streaming_phases(dev, huge: dict, phase4, sampling: dict, card: str) -> None:
    """Phases 16 and 17, each timed; the files live in a temporary directory
    removed at the end."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ooc = streamed_fit_phase(dev, huge, tmp, card)
        fits = streamed_entry_fits(dev, tmp, card)
        print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        multidevice_phase(dev, ooc, fits, phase4, sampling, card)
        print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
        ooc["mat"].close()
    torch.cuda.empty_cache()


def streaming_only(dev) -> None:
    """``--streaming``: the card, the build, the torus fit (phase 4), the n=1e7
    cloud with one draw of the huge path's anchors, a reference HMC run on
    the torus posterior at phase 12's budget, then phases 16 and 17."""
    card = card_line()
    print(f"card: {card}", flush=True)
    _, build_s = _timed(lambda: (_build.build(), _build.load()))
    print(f"build: {build_s:.1f} s", flush=True)
    hk.reset_launches()
    phase4, err, wall, ds = fit(SHAPES["torus"], torus_fit_cfg(), dev, seed=0)
    print(f"torus fit: err {err:.6f}  wall {wall:.3f} s  launches "
          f"{ {k: hk.LAUNCHES[k] for k in MAIN_PATH} }", flush=True)
    cfg = SHAPES["huge"]
    ds7 = torus_rings(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"])
    Xt = feature_major(ds7, dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    U = col.kmeans_anchors_colmajor(gen, Xt, cfg["s"], n_sample=1 << 17)
    huge = dict(ds=ds7, anchors=U, counts=col.cluster_sizes_colmajor(Xt, U, cfg["chunk"]))
    del Xt
    m, K = SHAPES["torus"]["m"], SHAPES["torus"]["K"]
    gp = make_whitened(phase4.eigenpair, torch.arange(m), K, 1e-3)
    post = GpcLogPost(gp, torch.as_tensor(ds.y_train, dtype=torch.float32, device=dev),
                      torch.ones((m,), dtype=torch.float32, device=dev), 1e-2, 10.0, 2.0)
    c = SAMPLERS["hmc"]
    x0 = 0.1 * torch.randn((c["chains"], post.dim), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    run = hmc.run_hmc(torch.Generator(device=dev).manual_seed(2), post, x0,
                      n_warmup=c["n_warmup"], n_samples=c["n_samples"], n_leapfrog=c["n_leapfrog"])
    sampling = dict(post=post, gp=gp, hmc_moments=f_moments(gp, run.samples), y_train=ds.y_train)
    streaming_phases(dev, huge, phase4, sampling, card)
    print(card)


def subsample_stage_times(dev, calls: int = 4) -> None:
    """The n=1e6 subsample stage alone, ``calls`` times from one seed: the
    times, and whether every call gave the first one's anchors."""
    big = SHAPES["large"]
    X_all = cloud(torus_rings(n=big["n"], m_train=big["m"], seed=big["seed"]), dev)
    subs, times = timed_subsamples(X_all, ft.GraphConfig(s=big["s"], r=big["r"], K=big["K"]), dev,
                                   calls)
    same = all(torch.equal(a.centers, subs[0].centers) for a in subs)
    print(f"n=1e6 subsample stage (k-means‖ + Lloyd, s={big['s']}), {calls} calls from one seed: "
          + ", ".join(f"{t:.4f}" for t in times) + f" s; anchors "
          f"{'identical' if same else 'differ'}", flush=True)


def torus_fit_cfg():
    tor = SHAPES["torus"]
    return ft.FitConfig(graph=ft.GraphConfig(s=tor["s"], r=tor["r"], K=tor["K"]), sigma=1e-3,
                        dtype=torch.float32, solve_dtype=torch.float64)


def inference_phases(dev, card: str, phase4, torus_launches: dict, mnist_eig: EigenPair,
                     mnist_ds, mnist_launches: dict, sampling: dict) -> None:
    """Phases 13–15, each timed."""
    for number, run in ((13, lambda: hyperposterior_phase(dev, mnist_eig, mnist_ds, mnist_launches,
                                                          phase4.eigenpair, torus_launches, card)),
                        (14, lambda: svi_phase(dev, sampling, card)),
                        (15, lambda: golden_phase(dev, phase4, card))):
        t0 = time.perf_counter()
        run()
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()


def sampling_only(dev) -> None:
    """``--sampling``: the card, the build, the torus fit (phase 4), the
    multiclass LAE fit of phase 11, then phases 12–15."""
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    hk.reset_launches()
    phase4, err, wall, _ = fit(SHAPES["torus"], torus_fit_cfg(), dev, seed=0)
    torus_launches = {k: hk.LAUNCHES[k] for k in MAIN_PATH}
    print(f"torus fit: err {err:.6f}  wall {wall:.3f} s  launches {torus_launches}", flush=True)
    from flgp_tpu_torch.datasets import mnist_like

    ds = mnist_like(n=MNIST["n"], m_train=MNIST["m"], seed=MNIST["seed"])
    f = entry_fit("fit_lae_logit_mult_gp", ds, mult_cfg(MNIST, torch.float32), dev, seed=0,
                  cold_and_warm=False)
    _report_fit("fit_lae_logit_mult_gp", "mnist_like n=70000, d=16, J=10, s=600", f)
    t0 = time.perf_counter()
    sampling = sampling_phase(dev, phase4.eigenpair, card)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    inference_phases(dev, card, phase4, torus_launches, f["first"].eigenpair, ds,
                     {k: f["launches"].get(k, 0) for k in MAIN_PATH}, sampling)
    print(card)


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
        cfg = SHAPES[label]
        X = cloud(torus_rings(n=cfg["n"], m_train=cfg["m"], seed=cfg["seed"]), dev)
        check_kernels(label, X, cfg, dev, results)
        del X
    check_knn_chunk(dev, results)

    # 4. torus fit: the main path, through the entry point a user calls
    tor = SHAPES["torus"]
    tor_cfg = torus_fit_cfg()
    hk.reset_launches()
    res, err, wall, _ = fit(tor, tor_cfg, dev, seed=0)
    launches = dict(hk.LAUNCHES)
    phase4, torus_launches = res, {k: launches[k] for k in MAIN_PATH}
    print(f"torus fit (cold): err {err:.6f}  t {float(res.pars['t']):.6g}  wall {wall:.3f} s  "
          f"launches {launches}", flush=True)
    if err > ERR_GATE:
        _fail(f"torus test error {err} > {ERR_GATE}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        _fail(f"the torus fit launched no {missing} kernel")
    res, err2, wall2, _ = fit(tor, tor_cfg, dev, seed=0)
    torus_eig = res.eigenpair
    print(f"torus fit (warm): err {err2:.6f}  wall {wall2:.3f} s", flush=True)
    if err2 > ERR_GATE:
        _fail(f"warm torus test error {err2} > {ERR_GATE}")

    # 5. the n=1e6 fit
    large_fit(dev)
    torch.cuda.empty_cache()

    # 6. and 7. the huge-n path: K6–K8, then the n=1e7 fit
    huge_launches, huge = huge_phase(dev, results)
    launches.update({k: v for k, v in huge_launches.items() if k.endswith("_t")})
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
    torch.cuda.empty_cache()

    # 11. multiclass and the extras
    mult_launches, mnist_eig, mnist_ds = multiclass_phase(dev, results)
    print("K1–K5 at the multiclass shape (side rows of the kernels line; launches per "
          "fit_lae_logit_mult_gp): " + "; ".join(
              f"{k} {results[k]['ms_mnist']:.4f} ms (bound {bound(results[k]['work_mnist'])[0]:.4f},"
              f" plain {results[k]['plain_ms_mnist']:.4f}, library "
              f"{'none' if results[k]['library_ms_mnist'] is None else format(results[k]['library_ms_mnist'], '.4f')}"
              f") x {mult_launches.get(k, 0)}" for k in MAIN_PATH), flush=True)
    torch.cuda.empty_cache()

    # 12. the posterior-sampling path on the torus fit's spectrum
    t0 = time.perf_counter()
    sampling = sampling_phase(dev, torus_eig, card)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13.–15. the rest of the inference stack, the goldens and the instrumented fit
    inference_phases(dev, card, phase4, torus_launches, mnist_eig, mnist_ds,
                     {k: mult_launches.get(k, 0) for k in MAIN_PATH}, sampling)
    del mnist_eig
    torch.cuda.empty_cache()

    # 16. and 17. the out-of-core fits and the multi-device layer
    streaming_phases(dev, huge, phase4, sampling, card)
    del huge, sampling

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
    elif sys.argv[1:] in (["--subsample-times"], ["--sampling"], ["--streaming"]):
        if not torch.cuda.is_available():
            _fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
        pin_full_precision()
        if sys.argv[1] == "--sampling":
            sampling_only(torch.device("cuda", 0))
        elif sys.argv[1] == "--streaming":
            streaming_only(torch.device("cuda", 0))
        else:
            print(f"card: {card_line()}", flush=True)
            subsample_stage_times(torch.device("cuda", 0))
    else:
        main()
