"""Typed configuration for the PyTorch port.

Same surface as ``flgp_tpu.config``: enums, the ``EPS`` jitter and three
frozen dataclasses with eager validation.  Dtype fields hold ``torch``
dtypes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch


class Subsample(str, enum.Enum):
    """Anchor-point selection method."""

    KMEANS = "kmeans"
    RANDOM = "random"
    MINIBATCH_KMEANS = "minibatchkmeans"


class KernelType(str, enum.Enum):
    """Cross-similarity flavor."""

    LAE = "lae"
    SE = "se"


class LaplacianType(str, enum.Enum):
    """Graph-Laplacian normalization."""

    RW = "rw"
    NORMALIZED = "normalized"
    CLUSTER_NORMALIZED = "cluster-normalized"


class Approach(str, enum.Enum):
    """Empirical-Bayes objective."""

    MARGINAL = "marginal"
    POSTERIOR = "posterior"


class NoiseModel(str, enum.Enum):
    """Homoscedastic vs per-point observation noise."""

    SAME = "same"
    DIFFERENT = "different"


# Numerical jitter on divisions and log-Cholesky diagonals.
EPS = 1e-9


def pin_full_precision() -> None:
    """Run every float32 contraction at full float32 precision.

    TF32 keeps ~10 mantissa bits, which wrecks the |x|²−2x·u+|u|² distance
    cancellation and spectra clustered near 1 (the JAX package measured a
    torus GPC error of 0.35 instead of 0.017 with reduced-precision f32
    products and pins ``Precision.HIGHEST`` for that reason).  Matmuls and
    cuDNN both default differently across PyTorch versions, so set all three.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Configuration of the spectral (graph) stage."""

    s: int = 600                      # number of anchor/induced points
    r: int = 3                        # kNN fan-in per point
    K: int = -1                       # spectral truncation; -1 -> K = s
    subsample: Subsample = Subsample.KMEANS
    kernel: KernelType = KernelType.LAE
    gl: LaplacianType = LaplacianType.CLUSTER_NORMALIZED
    root: bool = True                 # sqrt the eigenvalues of W
    nstart: int = 1                   # k-means restarts
    kmeans_iters: int = 100           # Lloyd iterations
    epsilon: float = 0.1              # SE bandwidth for covariance-only entry point
    nystrom_rcond: float = 0.0        # relative cutoff on Nyström inverse eigenvalues

    def __post_init__(self):
        if self.s < 1:
            raise ValueError(f"GraphConfig.s must be >= 1, got {self.s}")
        if self.r < 1:
            raise ValueError(f"GraphConfig.r must be >= 1, got {self.r}")
        if self.r > self.s:
            raise ValueError(
                f"GraphConfig.r ({self.r}) cannot exceed the anchor count s ({self.s})"
            )
        if self.K != -1 and self.K < 1:
            raise ValueError(
                f"GraphConfig.K must be -1 (=> s) or >= 1, got {self.K}"
            )
        if self.nstart < 1:
            raise ValueError(f"GraphConfig.nstart must be >= 1, got {self.nstart}")
        if self.epsilon <= 0:
            raise ValueError(f"GraphConfig.epsilon must be > 0, got {self.epsilon}")
        if not 0.0 <= self.nystrom_rcond < 1.0:
            raise ValueError(
                f"GraphConfig.nystrom_rcond must be in [0, 1), got {self.nystrom_rcond}"
            )
        for field, enum_t in (
            ("subsample", Subsample), ("kernel", KernelType), ("gl", LaplacianType)
        ):
            v = getattr(self, field)
            if not isinstance(v, enum_t):
                object.__setattr__(self, field, enum_t(v))

    def resolved_K(self) -> int:
        return self.s if self.K < 0 else self.K


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameter-learning configuration."""

    approach: Approach = Approach.POSTERIOR
    noise: NoiseModel = NoiseModel.SAME
    t0: float = 10.0
    t_lb: float = 1e-3
    t_ub: float = 1e4                  # initial scan window top; the 1-D optimizer
                                       # expands above it when the optimum pins there
    noise0: float = 1.0
    noise_lb: float = 1e-4
    # t-prior  p*log t + (t/tau)^(-q)
    prior_p_gpc: float = 1e-2
    prior_p_gpr: float = 1.0
    prior_q: float = 10.0
    prior_tau: float = 2.0
    # inverse-gamma noise prior
    prior_alpha: float = 1e-1
    prior_beta: float = 1e-3
    # optimizer schedule
    grid_size: int = 32
    adam_steps: int = 200
    adam_lr: float = 0.05
    # Laplace Newton iteration
    newton_tol: float = 1e-5
    newton_max_iter: int = 100

    def __post_init__(self):
        if self.t0 <= 0 or self.t_lb <= 0:
            raise ValueError("TrainConfig.t0 and t_lb must be > 0")
        if self.t_ub <= self.t_lb:
            raise ValueError(
                f"TrainConfig.t_ub ({self.t_ub}) must exceed t_lb ({self.t_lb})"
            )
        if self.noise0 <= 0 or self.noise_lb <= 0:
            raise ValueError("TrainConfig.noise0 and noise_lb must be > 0")
        if self.grid_size < 2:
            raise ValueError(f"TrainConfig.grid_size must be >= 2, got {self.grid_size}")
        for field, enum_t in (("approach", Approach), ("noise", NoiseModel)):
            v = getattr(self, field)
            if not isinstance(v, enum_t):
                object.__setattr__(self, field, enum_t(v))


_FLOAT_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Top-level fit configuration shared by all drivers."""

    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sigma: float = 1e-3                # ridge on H
    a2s: Optional[Sequence[float]] = None   # SE bandwidth grid; None -> default
    gl_sparse: bool = False
    gl_threshold: float = 0.01
    gl_solver: str = "dense"
    gl_lobpcg_iters: int = 80
    # prediction
    n_gibbs: int = 100                 # PG Gibbs sweeps
    # Rao-Blackwellized prediction over the last `gibbs_avg_sweeps` ω states;
    # 0 predicts from the final state only
    gibbs_avg_sweeps: int = 50
    output_cov: bool = False
    dtype: torch.dtype = torch.float32
    # dtype of the train/predict solve tail (Newton, Cholesky, Woodbury, PG
    # Gibbs).  None = same as ``dtype``.  The graph stage is robust in f32;
    # the tail is not (the JAX package measured torus GPC error 0.037 with an
    # all-f32 fit vs 0.016 with an f64 tail).
    solve_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.sigma < 0:
            raise ValueError(f"FitConfig.sigma must be >= 0, got {self.sigma}")
        if self.gl_solver not in ("dense", "lobpcg"):
            raise ValueError(
                f"FitConfig.gl_solver must be 'dense' or 'lobpcg', got {self.gl_solver!r}"
            )
        if self.gl_solver == "lobpcg" and not self.gl_sparse:
            raise ValueError("FitConfig.gl_solver='lobpcg' requires gl_sparse=True")
        if not 0.0 < self.gl_threshold <= 1.0:
            raise ValueError(
                f"FitConfig.gl_threshold must be in (0, 1], got {self.gl_threshold}"
            )
        if self.n_gibbs < 1:
            raise ValueError(f"FitConfig.n_gibbs must be >= 1, got {self.n_gibbs}")
        if not 0 <= self.gibbs_avg_sweeps <= self.n_gibbs:
            raise ValueError(
                "FitConfig.gibbs_avg_sweeps must be in [0, n_gibbs="
                f"{self.n_gibbs}], got {self.gibbs_avg_sweeps}"
            )
        for field in ("dtype", "solve_dtype"):
            v = getattr(self, field)
            if v is not None and v not in _FLOAT_DTYPES:
                raise ValueError(
                    f"FitConfig.{field} must be torch.float32 or torch.float64, got {v!r}"
                )


def default_a2s() -> np.ndarray:
    """Default bandwidth-squared grid of the SE, Nyström and GLGP drivers:
    exp(linspace(log 0.1, log 10, 10)), float64."""
    return np.exp(np.linspace(np.log(0.1), np.log(10.0), 10))
