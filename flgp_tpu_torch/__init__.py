"""flgp_tpu_torch: the PyTorch and CUDA port of FLGP-TPU for NVIDIA Hopper.

Heat-kernel Gaussian processes on graph-Laplacian spectra, with the
graph-stage kernels (kNN, LAE weights, ELL column sums, normalized Gram,
eigenvector extension) hand-written in CUDA for ``sm_90a``.  Same public
names as ``flgp_tpu``; imports neither JAX nor ``flgp_tpu``.
"""

from .config import (
    Approach,
    FitConfig,
    GraphConfig,
    KernelType,
    LaplacianType,
    NoiseModel,
    Subsample,
    TrainConfig,
)
from .fit.drivers import FitResult, fit_lae_logit_gp
from .types import EigenPair, EllMatrix

__all__ = [
    "Approach",
    "EigenPair",
    "EllMatrix",
    "FitConfig",
    "FitResult",
    "GraphConfig",
    "KernelType",
    "LaplacianType",
    "NoiseModel",
    "Subsample",
    "TrainConfig",
    "fit_lae_logit_gp",
]
