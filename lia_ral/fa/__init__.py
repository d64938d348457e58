"""Factor-analysis stack: Baum-Welch stats, TotalVariability (i-vector),
JFA eigenvoice/eigenchannel/D engines.

Array re-design of reference ``AccumulateTVStat``/``AccumulateJFAStat``
(SURVEY.md §2.1): per-speaker accumulator loops become batched einsums over
a speaker axis, per-speaker L inversions become batched Cholesky solves,
and the pthread merge of A/C accumulators becomes a psum.
"""

from .stats import BwStats, bw_stats_batch, save_stats, load_stats
from .tv import (
    TvModel,
    TvAccums,
    init_t,
    estimate_tett,
    tv_e_step,
    tv_m_step,
    min_divergence,
    tv_em_iteration,
    estimate_w,
    estimate_w_ubm_weight,
    estimate_w_eigen_decomposition,
    weighted_cov,
    norm_t_matrix,
    approximate_tctc,
    get_speaker_model,
    verify_em_llk,
)

__all__ = [
    "BwStats", "bw_stats_batch", "save_stats",
    "load_stats",
    "TvModel", "TvAccums", "init_t", "estimate_tett", "tv_e_step",
    "tv_m_step", "min_divergence", "tv_em_iteration", "estimate_w",
    "estimate_w_ubm_weight", "estimate_w_eigen_decomposition",
    "weighted_cov", "norm_t_matrix", "approximate_tctc",
    "get_speaker_model", "verify_em_llk",
]
