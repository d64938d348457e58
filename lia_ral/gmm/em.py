"""GMM-UBM EM training: init, M-step, variance control, bagged subsampling.

JAX equivalent of reference ``LIA_SpkTools/src/TrainTools.cpp``
(trainModel cpp:993-1028, trainModelStream cpp:1030-1110, mixtureInit
cpp:619-674, varianceControl cpp:567-592, setItParameter cpp:560-564) and
``GeneralTools.cpp`` baggedSegments (cpp:455-511).

The reference's per-iteration shape — bagged frame subsample → threaded EM
stat accumulation → closed-form M-step → variance floor/ceil schedule —
is kept, but frames live in one padded (N,D) device array, the bagged
subsample is a per-frame weight mask drawn with the JAX PRNG, and stat
accumulation goes through gmm.stats_path (optionally sharded over a
device mesh with psum — see lia_ral.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .kernels import EmStats
from .model import GmmDiag


@dataclasses.dataclass
class TrainCfg:
    """Reference TrainCfg (TrainTools.h:122-160), same config keys."""

    nb_train_it: int = 20
    init_variance_flooring: float = 1.0
    init_variance_ceiling: float = 10.0
    final_variance_flooring: float = 0.5
    final_variance_ceiling: float = 5.0
    bagged_frame_probability: float = 1.0
    bagged_frame_probability_init: float = 0.0
    bagged_minimal_length: int = 3
    bagged_maximal_length: int = 7
    normalize_model: bool = False
    component_reduction: bool = False
    target_distrib_count: int = 0

    @classmethod
    def from_config(cls, cfg) -> "TrainCfg":
        return cls(
            nb_train_it=cfg.get_int("nbTrainIt", 20),
            init_variance_flooring=cfg.get_float("initVarianceFlooring", 1.0),
            init_variance_ceiling=cfg.get_float("initVarianceCeiling", 10.0),
            final_variance_flooring=cfg.get_float("finalVarianceFlooring", 0.5),
            final_variance_ceiling=cfg.get_float("finalVarianceCeiling", 5.0),
            bagged_frame_probability=cfg.get_float("baggedFrameProbability", 1.0),
            bagged_frame_probability_init=cfg.get_float(
                "baggedFrameProbabilityInit", 0.0),
            bagged_minimal_length=cfg.get_int("baggedMinimalLength", 3),
            bagged_maximal_length=cfg.get_int("baggedMaximalLength", 7),
            normalize_model=cfg.get_bool("normalizeModel", False),
            component_reduction=cfg.get_bool("componentReduction", False),
            target_distrib_count=cfg.get_int("targetMixtureDistribCount", 0),
        )


def default_stats_fn(chunk: int = 4096, fast_math: bool = False,
                     fast_stats: bool = False):
    """The single-device stats_fn: gmm.stats_path.em_stats with the
    precision flags of the ``fastMath``/``fastStats`` config keys."""
    from .stats_path import em_stats

    def fn(x, w, gmm):
        return em_stats(x, w, gmm, fast_math=fast_math,
                        fast_stats=fast_stats, chunk=chunk)
    return fn


def schedule_value(begin: float, end: float, nb_it: int, it: int) -> float:
    """Linear parameter schedule — reference setItParameter
    (TrainTools.cpp:560-564)."""
    if nb_it < 2:
        return begin
    return begin - (begin - end) / (nb_it - 1) * it


def global_mean_cov(x: jax.Array, w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Weighted global mean and variance of the frames — reference
    computeMeanCov/globalMeanCov (TrainTools.cpp:593)."""
    cnt = jnp.maximum(jnp.sum(w), 1e-30)
    mean = jnp.sum(x * w[:, None], axis=0) / cnt
    ex2 = jnp.sum(x * x * w[:, None], axis=0) / cnt
    return mean, ex2 - mean * mean


def m_step(stats: EmStats, min_occ: float = 1e-6) -> GmmDiag:
    """Closed-form diagonal-GMM M-step (the reference delegates this to
    ALIZE MixtureStat::getEM)."""
    occ = jnp.maximum(stats.n, min_occ)[:, None]
    means = stats.sum_x / occ
    cov = stats.sum_xx / occ - means * means
    cov = jnp.maximum(cov, 1e-8)
    weights = stats.n / jnp.maximum(stats.count, 1e-30)
    wsum = jnp.sum(weights)
    # empty selection (all-zero frame weights) → keep a uniform mixture
    weights = jnp.where(wsum > 0, weights / jnp.maximum(wsum, 1e-30),
                        1.0 / stats.n.shape[0])
    return GmmDiag(weights=weights, means=means, cov_inv=1.0 / cov)


def variance_control(gmm: GmmDiag, flooring: float, ceiling: float,
                     global_cov: jax.Array) -> GmmDiag:
    """Floor/ceil each component variance relative to the global data
    variance — reference varianceControl (TrainTools.cpp:567-592)."""
    cov = 1.0 / gmm.cov_inv
    cov = jnp.clip(cov, flooring * global_cov[None, :],
                   ceiling * global_cov[None, :])
    return gmm.replace(cov_inv=1.0 / cov)


@jax.jit
def _m_step_with_variance_control(stats: EmStats, flooring, ceiling,
                                  global_cov: jax.Array) -> GmmDiag:
    """M-step + variance flooring as ONE jitted call with the scheduled
    floor/ceil as traced scalars: the eager path recompiled its tiny ops
    for every distinct float of the per-iteration schedule."""
    return variance_control(m_step(stats), flooring, ceiling, global_cov)


def normalize_mixture(gmm: GmmDiag, data_mean: jax.Array,
                      data_cov: jax.Array, mean_only: bool = False) -> GmmDiag:
    """Map the model into a 0-mean/1-var feature space — reference
    normalizeMixture (TrainTools.cpp:287-336)."""
    std = jnp.sqrt(data_cov)
    means = (gmm.means - data_mean[None, :]) / std[None, :]
    if mean_only:
        return gmm.replace(means=means)
    cov = (1.0 / gmm.cov_inv) / data_cov[None, :]
    return gmm.replace(means=means, cov_inv=1.0 / cov)


# -- bagged frame selection ---------------------------------------------------

def bagged_frame_mask(
    key: jax.Array,
    base_mask: jax.Array,
    probability: float,
    min_len: int = 3,
    max_len: int = 7,
) -> jax.Array:
    """Random frame subsample as a 0/1 weight mask.

    Reference baggedSegments (GeneralTools.cpp:455-511) walks segments,
    cuts them into chunks of random length in [min_len, max_len] and keeps
    each chunk with probability p.  The array formulation: draw one
    chunk length per position bucket and one Bernoulli per bucket, then
    expand — equivalent selection statistics, fully vectorised, driven by
    the JAX PRNG (counter-based, reproducible under sharding) instead of C
    ``rand()``.
    """
    if probability >= 1.0:
        return base_mask
    n = base_mask.shape[0]
    # fixed average-length chunks with a random phase offset: same
    # expected selection fraction and chunk-scale burstiness as the
    # reference's random-length walk (whose C rand() draw is not
    # bit-reproducible anyway), expressed as reshape/broadcast ops only.
    # A cumsum+searchsorted formulation compiles a corpus-length vmapped
    # searchsorted; variable-length chunk walks are scatter/gather-shaped
    # and stay off the device.
    chunk_len = max((min_len + max_len) // 2, 1)
    n_chunks = -(-n // chunk_len) + 1
    k_off, k_keep = jax.random.split(key)
    keep = jax.random.bernoulli(k_keep, probability, (n_chunks,))
    sel = jnp.repeat(keep, chunk_len,
                     total_repeat_length=n_chunks * chunk_len)
    off = jax.random.randint(k_off, (), 0, chunk_len)
    sel = jax.lax.dynamic_slice(sel, (off,), (n,))
    return base_mask * sel.astype(base_mask.dtype)


# -- init ---------------------------------------------------------------------

def _split_component(gmm: GmmDiag, idx) -> GmmDiag:
    """Split component ``idx`` into mean±sqrt(cov) halves of equal weight
    (the inner step of reference mixtureInitBySplit, Tools.cpp:1057)."""
    sd = jnp.sqrt(1.0 / gmm.cov_inv[idx])
    m_plus = gmm.means[idx] + sd
    m_minus = gmm.means[idx] - sd
    half = gmm.weights[idx] / 2.0
    return GmmDiag(
        weights=jnp.concatenate([gmm.weights.at[idx].set(half),
                                 half[None]]),
        means=jnp.concatenate([gmm.means.at[idx].set(m_plus),
                               m_minus[None]]),
        cov_inv=jnp.concatenate([gmm.cov_inv, gmm.cov_inv[idx][None]]),
    )


def mixture_init_by_split(
    key: jax.Array,
    x: jax.Array,
    w: jax.Array,
    max_distrib: int,
    cfg: "TrainCfg | None" = None,
    stats_fn=None,
    chunk: int = 4096,
    verbose: bool = False,
) -> GmmDiag:
    """Binary-splitting GMM initialisation — reference mixtureInitBySplit
    (Tools.cpp:1057-1240): start from one Gaussian at the global
    mean/covariance; while 2K ≤ max split EVERY component into
    mean±sqrt(cov) halves and EM-retrain; then unitary splits of the
    heaviest component until K == max, EM after each.  Used by the
    diarization world-model builder (createWorld, Tools.cpp:1243)."""
    cfg = cfg or TrainCfg(nb_train_it=3)
    gmean, gcov = global_mean_cov(x, w)
    gmm = GmmDiag(weights=jnp.ones((1,), x.dtype),
                  means=gmean[None].astype(x.dtype),
                  cov_inv=(1.0 / jnp.maximum(gcov, 1e-8))[None]
                  .astype(x.dtype))

    def retrain(g, k):
        return train_model(k, x, w, g, cfg, stats_fn=stats_fn, chunk=chunk,
                           verbose=verbose)

    while 2 * gmm.n_components <= max_distrib:
        k = gmm.n_components
        for d in range(k):          # split every component of this round
            gmm = _split_component(gmm, d)
        key, kt = jax.random.split(key)
        gmm = retrain(gmm, kt)
        if verbose:
            print(f"split init: {gmm.n_components} components")
    while gmm.n_components < max_distrib:   # unitary splits
        idx = int(jnp.argmax(gmm.weights))
        gmm = _split_component(gmm, idx)
        key, kt = jax.random.split(key)
        gmm = retrain(gmm, kt)
        if verbose:
            print(f"split init (unitary): {gmm.n_components} components")
    return gmm


def mixture_init(
    key: jax.Array,
    x: jax.Array,
    w: jax.Array,
    n_components: int,
    bagged_probability_init: float = 0.1,
    min_len: int = 3,
    max_len: int = 7,
) -> GmmDiag:
    """Init by random frame picking — reference mixtureInit
    (TrainTools.cpp:619-674): component mean = mean of a random ~p/K frame
    subset, covariance = global covariance, weights = 1/K."""
    _, gcov = global_mean_cov(x, w)
    p = max(bagged_probability_init / n_components, 1e-6)
    keys = jax.random.split(key, n_components)
    gmean = jnp.sum(x * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)

    # component means as chunked (C,N)@(N,D) mask-matmuls: a full vmap
    # over K materialises K×N masks at once (4 GB at K=2048/N=500k and a
    # compile too large to hold); 128-component chunks bound the live
    # mask block at ~256 MB and make the reduction a matrix product
    chunk = min(128, n_components)
    pad = (-n_components) % chunk
    keys_p = jnp.concatenate([keys, keys[:pad]]) if pad else keys

    def chunk_means(kc):
        masks = jax.vmap(
            lambda kk: bagged_frame_mask(kk, w, p, min_len, max_len))(kc)
        cnt = jnp.sum(masks, axis=-1)                          # (C,)
        mean = jnp.dot(masks, x, preferred_element_type=jnp.float32) \
            / jnp.maximum(cnt, 1.0)[:, None]
        # empty selection → fall back to global weighted mean
        return jnp.where(cnt[:, None] > 0, mean, gmean[None, :])

    means = jax.lax.map(chunk_means,
                        keys_p.reshape(-1, chunk)).reshape(-1, x.shape[1])
    means = means[:n_components]
    k = n_components
    return GmmDiag(
        weights=jnp.full((k,), 1.0 / k, x.dtype),
        means=means.astype(x.dtype),
        cov_inv=jnp.broadcast_to(1.0 / jnp.maximum(gcov, 1e-8),
                                 (k, x.shape[1])).astype(x.dtype),
    )


def reduce_model(gmm: GmmDiag, target_count: int) -> GmmDiag:
    """Component-number reduction: keep the heaviest components and
    renormalise (reference selectComponent/reduceModel,
    TrainTools.cpp:175-222; componentReduction/targetMixtureDistribCount
    config keys)."""
    idx = jnp.argsort(-gmm.weights)[:target_count]
    w = gmm.weights[idx]
    return GmmDiag(weights=w / jnp.sum(w), means=gmm.means[idx],
                   cov_inv=gmm.cov_inv[idx])


# -- the training loop --------------------------------------------------------

def train_model(
    key: jax.Array,
    x: jax.Array,
    w: jax.Array,
    init: GmmDiag,
    cfg: TrainCfg,
    stats_fn: Callable[[jax.Array, jax.Array, GmmDiag], EmStats] | None = None,
    chunk: int = 4096,
    verbose: bool = False,
) -> GmmDiag:
    """UBM EM loop — reference trainModel (TrainTools.cpp:993-1028).

    ``stats_fn`` defaults to the single-device statistics path; pass the
    mesh-sharded accumulator from lia_ral.parallel for multi-chip
    training (same signature, stats merged with psum).
    """
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    _, gcov = global_mean_cov(x, w)
    gmm = init
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        key, sub = jax.random.split(key)
        mask = bagged_frame_mask(sub, w, cfg.bagged_frame_probability,
                                 cfg.bagged_minimal_length,
                                 cfg.bagged_maximal_length)
        stats = stats_fn(x, mask, gmm)
        if verbose:
            print(f"it {it}: meanLLK={float(stats.mean_llk()):.5f} "
                  f"frames={float(stats.count):.0f} floor={floor:.3f} "
                  f"ceil={ceil:.3f}")
        gmm = _m_step_with_variance_control(stats, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm


def train_model_streams(
    key: jax.Array,
    streams: list[tuple[jax.Array, jax.Array]],
    stream_weights: list[float],
    init: GmmDiag,
    cfg: TrainCfg,
    stats_fn=None,
    chunk: int = 4096,
    verbose: bool = False,
) -> GmmDiag:
    """Multi-stream weighted EM — reference trainModelStream
    (TrainTools.cpp:1030-1110): per iteration each stream contributes a
    bagged-subsampled stat accumulator scaled by its stream weight before
    the merge (stream weights balance heterogeneous data sources).

    ``stats_fn`` as in train_model: defaults to gmm.stats_path; pass the
    mesh-sharded accumulator for several devices."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    all_x = jnp.concatenate([x for x, _ in streams])
    all_w = jnp.concatenate([w for _, w in streams])
    _, gcov = global_mean_cov(all_x, all_w)
    gmm = init
    k, d = init.means.shape
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        merged = EmStats.zeros(k, d)
        for (x, w), sw in zip(streams, stream_weights):
            key, sub = jax.random.split(key)
            mask = bagged_frame_mask(sub, w, cfg.bagged_frame_probability,
                                     cfg.bagged_minimal_length,
                                     cfg.bagged_maximal_length)
            st = stats_fn(x, mask, gmm)
            merged = merged.merge(jax.tree.map(lambda a: a * sw, st))
        if verbose:
            print(f"stream-it {it}: meanLLK={float(merged.mean_llk()):.5f}")
        gmm = _m_step_with_variance_control(merged, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm


def streaming_global_mean_cov(loader) -> tuple[jax.Array, jax.Array]:
    """Global weighted mean/cov in one streaming pass over the loader."""
    s = s2 = None
    cnt = 0.0
    for x, w in loader():
        xw = jnp.asarray(x) * jnp.asarray(w)[:, None]
        c0 = jnp.sum(jnp.asarray(x) * xw, axis=0)
        c1 = jnp.sum(xw, axis=0)
        s = c1 if s is None else s + c1
        s2 = c0 if s2 is None else s2 + c0
        cnt += float(jnp.sum(jnp.asarray(w)))
    mean = s / max(cnt, 1e-30)
    return mean, s2 / max(cnt, 1e-30) - mean * mean


def train_model_streaming(
    key: jax.Array,
    loader,
    init: GmmDiag,
    cfg: TrainCfg,
    stats_fn=None,
    chunk: int = 4096,
    verbose: bool = False,
) -> GmmDiag:
    """UBM EM over a corpus larger than host RAM.

    ``loader`` is a zero-argument callable returning a fresh iterable of
    ``(x, w)`` fixed-shape chunks per epoch (the featureServerBufferSize
    contract: the reference streams frames through a bounded buffer,
    config key in TrainWorld.cfg; our chunks are the device batches).
    Each EM iteration streams the corpus once, merging per-chunk
    sufficient statistics exactly as the in-RAM path does per shard —
    stats merge is associative, so the result equals in-RAM training
    when the bagged masks match (tests/test_streaming.py)."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    _, gcov = streaming_global_mean_cov(loader)
    gmm = init
    k, d = init.means.shape
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        merged = EmStats.zeros(k, d)
        for x, w in loader():
            key, sub = jax.random.split(key)
            w = jnp.asarray(w)
            mask = bagged_frame_mask(sub, w, cfg.bagged_frame_probability,
                                     cfg.bagged_minimal_length,
                                     cfg.bagged_maximal_length)
            merged = merged.merge(stats_fn(jnp.asarray(x), mask, gmm))
        if verbose:
            print(f"stream it {it}: meanLLK={float(merged.mean_llk()):.5f} "
                  f"frames={float(merged.count):.0f}")
        gmm = _m_step_with_variance_control(merged, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm
