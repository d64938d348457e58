"""i-vector backend: normalization, LDA/WCCN, two-cov, G-PLDA, scoring,
score normalization.

array re-design of reference ``PldaTools`` (SURVEY.md §2.1) and
``ComputeNorm`` (§2.2): dev-set statistics, EFR/sphNorm iterations, LDA,
WCCN, Mahalanobis/two-covariance models, Gaussian PLDA EM + scoring —
all batched matmul pipelines — plus z/t/zt/tz score normalization.
"""

from .ivnorm import (
    DevSet,
    length_norm,
    compute_cov_matrices,
    efr_iterations,
    apply_efr,
    compute_lda,
    compute_wccn,
    compute_mahalanobis,
)
from .plda import PldaModel, plda_em_iteration, plda_train, plda_llr
from .scoring import (
    cosine_scores,
    mahalanobis_scores,
    two_cov_model,
    two_cov_scores,
)
from .norm import znorm, tnorm, ztnorm, tznorm

__all__ = [
    "DevSet", "length_norm", "compute_cov_matrices", "efr_iterations",
    "apply_efr", "compute_lda", "compute_wccn", "compute_mahalanobis",
    "PldaModel", "plda_em_iteration", "plda_train", "plda_llr",
    "cosine_scores", "mahalanobis_scores", "two_cov_model", "two_cov_scores",
    "znorm", "tnorm", "ztnorm", "tznorm",
]
