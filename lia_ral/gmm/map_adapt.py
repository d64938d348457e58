"""MAP adaptation of target models from a world model.

JAX equivalent of reference ``TrainTools.cpp`` MAP stack:
computeMAP dispatch (cpp:541-557), computeMAPConst (cpp:356),
computeMAPConst2 (cpp:389), computeMAPOccDep (cpp:445-490 — classic
relevance-factor MAP for mean/var/weight), and the adaptModel EM wrapper
(cpp:871-905).  All four criteria are pure elementwise pytree updates.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .em import bagged_frame_mask, m_step
from .kernels import EmStats, em_stats_chunked
from .model import GmmDiag


@dataclasses.dataclass
class MapCfg:
    """Reference MAPCfg (TrainTools.h:74-119), same config keys."""

    method: str = "MAPOccDep"     # MAPConst | MAPConst2 | MAPOccDep | MAPModelBased
    mean_adapt: bool = True
    var_adapt: bool = False
    weight_adapt: bool = False
    mean_r: float = 14.0          # MAPRegFactorMean (or MAPAlphaMean for Const)
    var_r: float = 14.0
    weight_r: float = 14.0
    nb_train_it: int = 1
    bagged_frame_probability: float = 1.0
    bagged_minimal_length: int = 3
    bagged_maximal_length: int = 7

    @classmethod
    def from_config(cls, cfg) -> "MapCfg":
        method = cfg.get_str("MAPAlgo", "MAPOccDep")
        const = method in ("MAPConst", "MAPConst2")
        mean_key = "MAPAlphaMean" if const else "MAPRegFactorMean"
        var_key = "MAPAlphaVar" if const else "MAPRegFactorVar"
        weight_key = "MAPAlphaWeight" if const else "MAPRegFactorWeight"
        return cls(
            method=method,
            mean_adapt=cfg.get_bool("meanAdapt", False),
            var_adapt=cfg.get_bool("varAdapt", False),
            weight_adapt=cfg.get_bool("weightAdapt", False),
            mean_r=cfg.get_float(mean_key, 0.75 if const else 14.0),
            var_r=cfg.get_float(var_key, 0.75 if const else 14.0),
            weight_r=cfg.get_float(weight_key, 0.75 if const else 14.0),
            nb_train_it=cfg.get_int("nbTrainIt", 1),
            bagged_frame_probability=cfg.get_float("baggedFrameProbability", 1.0),
            bagged_minimal_length=cfg.get_int("baggedMinimalLength", 3),
            bagged_maximal_length=cfg.get_int("baggedMaximalLength", 7),
        )


def map_adapt(world: GmmDiag, em_model: GmmDiag, frame_count: jax.Array,
              cfg: MapCfg) -> GmmDiag:
    """One MAP update: combine world prior with the EM estimate.

    ``em_model`` is the M-step result on the target data (the reference
    passes ``clientMixture=emAcc.getEM()``); ``frame_count`` the number of
    (weighted) frames behind it.
    """
    if cfg.method == "MAPConst":
        # tmp starts from world; mean = α·world + (1−α)·client (cpp:356-383)
        a = cfg.mean_r
        means = a * world.means + (1.0 - a) * em_model.means if cfg.mean_adapt \
            else world.means
        return world.replace(means=means)
    if cfg.method == "MAPConst2":
        # weight-weighted constant interpolation (cpp:389-420)
        a = cfg.mean_r
        if not cfg.mean_adapt:
            return world
        wm = a * world.weights[:, None]
        cm = (1.0 - a) * em_model.weights[:, None]
        means = (wm * world.means + cm * em_model.means) / (wm + cm)
        return world.replace(means=means)
    if cfg.method in ("MAPOccDep", "MAPModelBased"):
        # occupancy-dependent relevance-factor MAP (cpp:445-490)
        occ = em_model.weights * frame_count                  # (K,)
        out = world
        if cfg.mean_adapt:
            a = (occ / (occ + cfg.mean_r))[:, None]
            out = out.replace(
                means=(1.0 - a) * world.means + a * em_model.means)
        if cfg.var_adapt:
            a = (occ / (occ + cfg.var_r))[:, None]
            dm = world.means - em_model.means
            cov = ((1.0 - a) / world.cov_inv + a / em_model.cov_inv
                   + (1.0 - a) * a * dm * dm)
            out = out.replace(cov_inv=1.0 / cov)
        if cfg.weight_adapt:
            a = occ / (occ + cfg.weight_r)
            w = a * em_model.weights + (1.0 - a) * world.weights
            out = out.replace(weights=w / jnp.sum(w))
        return out
    raise ValueError(f"unknown MAP method {cfg.method}")


def compute_mllr(world: GmmDiag, em_model: GmmDiag,
                 frame_count: jax.Array) -> tuple[GmmDiag, jax.Array]:
    """Global MLLR mean transform μ' = W·[1, μ] (reference computeMLLR,
    TrainTools.cpp:788-866).

    The reference's per-dimension G-matrix loop becomes one batched
    einsum + batched solve over the feature dimension.
    Returns (adapted model, W (D, D+1))."""
    k, d = world.means.shape
    occ = em_model.weights * frame_count                    # (K,)
    xi = jnp.concatenate([jnp.ones((k, 1), world.means.dtype),
                          world.means], axis=1)             # (K, D+1)
    cov = 1.0 / world.cov_inv                               # (K, D)
    inv_cov = world.cov_inv                                 # 1/cov (K,D)
    # Z[p,q] = Σ_j occ_j·μ̂_jp·ξ_jq / cov_jp
    z = jnp.einsum("j,jp,jq->pq", occ, em_model.means * inv_cov, xi,
                   preferred_element_type=jnp.float32)      # (D, D+1)
    # G[p] = Σ_j (occ_j/cov_jp)·ξ_j·ξ_jᵀ
    g = jnp.einsum("j,jp,jq,jr->pqr", occ, inv_cov, xi, xi,
                   preferred_element_type=jnp.float32)      # (D, D+1, D+1)
    g = g + 1e-6 * jnp.eye(d + 1, dtype=g.dtype)[None]
    w_mat = jnp.linalg.solve(g, z[..., None])[..., 0]       # (D, D+1)
    new_means = w_mat[:, 0][None, :] + world.means @ w_mat[:, 1:].T
    del cov
    return world.replace(means=new_means), w_mat


def adapt_model(
    key: jax.Array,
    x: jax.Array,
    w: jax.Array,
    world: GmmDiag,
    cfg: MapCfg,
    chunk: int = 4096,
) -> GmmDiag:
    """Target-model training loop — reference adaptModel
    (TrainTools.cpp:871-905): iterate {bagged subsample → EM stats with the
    current client model → M-step → MAP combine with world prior}."""
    client = world
    for _ in range(cfg.nb_train_it):
        key, sub = jax.random.split(key)
        mask = bagged_frame_mask(sub, w, cfg.bagged_frame_probability,
                                 cfg.bagged_minimal_length,
                                 cfg.bagged_maximal_length)
        stats = em_stats_chunked(x, mask, client, chunk=chunk)
        em_model = m_step(stats)
        if cfg.method == "MLLR":
            client, _ = compute_mllr(world, em_model, stats.count)
        else:
            client = map_adapt(world, em_model, stats.count, cfg)
    return client
