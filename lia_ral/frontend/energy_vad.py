"""Energy-based voice activity detection.

JAX equivalent of reference ``LIA_SpkDet/EnergyDetector`` —
energyDetector (EnergyDetector.cpp:200-280): train a small 1-D GMM on the
log-energy coefficient by EM, pick a threshold from the highest-energy
component (meanStd mode: mean − α·σ, cpp:271-273; weight mode: keep the
top-w_high mass of the energy histogram, computeEnergyThreshold
cpp:106-125), select frames above threshold (selectFrames cpp:128-168),
emit speech segments.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..gmm.em import global_mean_cov, m_step, variance_control
from ..gmm.kernels import em_stats
from ..gmm.model import GmmDiag


@dataclasses.dataclass
class EnergyDetectorCfg:
    """Reference EnergyDetector config keys."""

    nb_train_it: int = 10
    mixture_distrib_count: int = 3
    variance_flooring: float = 0.5
    variance_ceiling: float = 10.0
    alpha: float = 0.25
    threshold_mode: str = "meanStd"   # meanStd | weight

    @classmethod
    def from_config(cls, cfg) -> "EnergyDetectorCfg":
        return cls(
            nb_train_it=cfg.get_int("nbTrainIt", 10),
            mixture_distrib_count=cfg.get_int("mixtureDistribCount", 3),
            variance_flooring=cfg.get_float("varianceFlooring", 0.5),
            variance_ceiling=cfg.get_float("varianceCeiling", 10.0),
            alpha=cfg.get_float("alpha", 0.25),
            threshold_mode=cfg.get_str("thresholdMode", "meanStd"),
        )


def energy_mixture_init(k: int, dtype=jnp.float32) -> GmmDiag:
    """Fixed init — reference energyMixtureInit (cpp:173-196): means
    spread linearly over [−2, 2], unit variances, equal weights."""
    if k > 1:
        means = jnp.linspace(-2.0, 2.0, k, dtype=dtype)[:, None]
    else:
        means = jnp.full((1, 1), -2.0, dtype)
    return GmmDiag(
        weights=jnp.full((k,), 1.0 / k, dtype),
        means=means,
        cov_inv=jnp.ones((k, 1), dtype),
    )


def _likelihood_loss(m1, v1, w1, m2, v2, w2) -> float:
    """Reference likelihoodLoss (EnergyDetector.cpp:~80): symmetrised
    penalty of merging two 1-D Gaussians."""
    a1 = w1 / (w1 + w2)
    a2 = 1.0 - a1
    dm = m1 - m2
    var = a1 * v1 + a2 * v2 + a1 * a2 * dm * dm
    d1 = var / v1
    d2 = var / v2
    return 0.5 * (w1 * np.log(d1) + w2 * np.log(d2))


def weight_mode_threshold(energy: np.ndarray, w: np.ndarray,
                          p_select: float, nb_bins: int = 100) -> float:
    """Reference computeEnergyThreshold (cpp:106-125): walk the energy
    histogram from the top until the selected mass reaches p_select."""
    sel = w > 0
    e = energy[sel]
    if e.size == 0:
        return -np.inf
    hist, edges = np.histogram(e, bins=nb_bins, density=True)
    count = 0.0
    i = nb_bins - 1
    while i >= 0 and count <= p_select:
        count += hist[i] * (edges[i + 1] - edges[i])
        i -= 1
    return float(edges[i + 2]) if i >= 0 else float(edges[0])


def energy_detector(
    energy: np.ndarray,
    w: np.ndarray,
    cfg: EnergyDetectorCfg,
    verbose: bool = False,
) -> np.ndarray:
    """energy: (N,) log-energy per frame; w: (N,) selection weights.
    Returns the boolean speech mask (True = frame above threshold).
    """
    e = jnp.asarray(energy, jnp.float32)[:, None]      # (N,1)
    wj = jnp.asarray(w, jnp.float32)
    _, gcov = global_mean_cov(e, wj)
    gmm = energy_mixture_init(cfg.mixture_distrib_count)
    for it in range(cfg.nb_train_it):
        st = em_stats(e, wj, gmm)
        gmm = m_step(st)
        gmm = variance_control(gmm, cfg.variance_flooring,
                               cfg.variance_ceiling, gcov)
        if verbose:
            print(f"energy EM it {it}: meanLLK={float(st.mean_llk()):.4f}")
    means = np.asarray(gmm.means)[:, 0]
    covs = np.asarray(1.0 / gmm.cov_inv)[:, 0]
    weights = np.asarray(gmm.weights)
    hi = int(np.argmax(means))
    if cfg.threshold_mode == "meanStd":
        threshold = means[hi] - cfg.alpha * np.sqrt(covs[hi])
    elif cfg.threshold_mode == "weight":
        p_select = float(weights[hi])
        if cfg.mixture_distrib_count == 3:
            lo = int(np.argmin(means))
            mid = 3 - hi - lo
            loss_h = _likelihood_loss(means[mid], covs[mid], weights[mid],
                                      means[hi], covs[hi], weights[hi])
            loss_l = _likelihood_loss(means[mid], covs[mid], weights[mid],
                                      means[lo], covs[lo], weights[lo])
            if loss_h < loss_l:
                p_select += cfg.alpha * weights[mid]
        threshold = weight_mode_threshold(np.asarray(energy),
                                          np.asarray(w), p_select)
    else:
        raise ValueError(f"unknown thresholdMode {cfg.threshold_mode}")
    if verbose:
        print(f"energy threshold = {threshold:.4f} (mode {cfg.threshold_mode})")
    return (np.asarray(energy) > threshold) & (np.asarray(w) > 0)
