"""flgp_tpu_torch: the PyTorch and CUDA port of FLGP-TPU for NVIDIA Hopper.

Heat-kernel Gaussian processes on graph-Laplacian spectra, with the
graph-stage kernels (kNN, LAE weights, ELL column sums, normalized Gram,
eigenvector extension, raw ELL product) hand-written in CUDA for ``sm_90a``.  The same
public names as ``flgp_tpu``: the twelve fit drivers (binary, regression and multiclass),
``heat_kernel_covariance`` and ``lae_eigenmap``; imports neither JAX nor ``flgp_tpu``.
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
    default_a2s,
)
from .fit.drivers import (
    FitResult,
    fit_gl_logit_gp,
    fit_gl_regression_gp,
    fit_lae_logit_gp,
    fit_lae_regression_gp,
    fit_nystrom_logit_gp,
    fit_nystrom_regression_gp,
    fit_se_logit_gp,
    fit_se_regression_gp,
)
from .fit.extras import heat_kernel_covariance, lae_eigenmap
from .fit.multiclass import (
    fit_gl_logit_mult_gp,
    fit_lae_logit_mult_gp,
    fit_nystrom_logit_mult_gp,
    fit_se_logit_mult_gp,
)
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
    "default_a2s",
    "fit_gl_logit_gp",
    "fit_gl_logit_mult_gp",
    "fit_gl_regression_gp",
    "fit_lae_logit_gp",
    "fit_lae_logit_mult_gp",
    "fit_lae_regression_gp",
    "fit_nystrom_logit_gp",
    "fit_nystrom_logit_mult_gp",
    "fit_nystrom_regression_gp",
    "fit_se_logit_gp",
    "fit_se_logit_mult_gp",
    "fit_se_regression_gp",
    "heat_kernel_covariance",
    "lae_eigenmap",
]
