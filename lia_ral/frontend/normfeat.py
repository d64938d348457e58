"""Feature normalization: CMVN (file/segmental/window) and feature warping.

JAX equivalent of reference ``LIA_SpkDet/NormFeat/NormFeat.cpp``
(normFeat cpp:231 — file/segmental/window 0-1 normalisation with global
fallback compensation cpp:358-430; Gaussian feature warping cpp:362-368
via per-coefficient histograms) and ``NormFeatWindowMode.cpp`` (streaming
per-window CMVN).  Underlying math: GeneralTools computeZeroOne
(cpp:670-681) and computeWarp (cpp:642-668).

All variants are expressed over (N,D) frame arrays with (N,) selection
weights; the sliding-window forms use cumulative sums (associative-scan
formulation of the reference's sequential window loop, SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri


def _masked_mean_std(x: jax.Array, w: jax.Array,
                     var_floor: float = 1e-8) -> tuple[jax.Array, jax.Array]:
    cnt = jnp.maximum(jnp.sum(w), 1e-30)
    mean = jnp.sum(x * w[:, None], axis=0) / cnt
    var = jnp.sum(x * x * w[:, None], axis=0) / cnt - mean * mean
    return mean, jnp.sqrt(jnp.maximum(var, var_floor))


@functools.partial(jax.jit, static_argnames=("cms_only", "var_only"))
def cmvn_global(x: jax.Array, w: jax.Array,
                cms_only: bool = False, var_only: bool = False) -> jax.Array:
    """File-mode CMVN: 0-mean/1-var over the selected frames
    (reference ``segmentalMode file``).  cms_only/var_only mirror the
    reference featNormKeepVariance / cmsOnly options."""
    mean, std = _masked_mean_std(x, w)
    if cms_only:
        return x - mean[None, :]
    if var_only:
        return x / std[None, :]
    return (x - mean[None, :]) / std[None, :]


def cmvn_segmental(x: jax.Array, seg_ids: jax.Array, w: jax.Array,
                   n_segments: int) -> jax.Array:
    """Per-segment CMVN: each segment normalised by its own statistics
    (reference ``segmentalMode segment``).  seg_ids: (N,) int segment index
    per frame; n_segments static."""
    wj = w[:, None]
    one_hot = jax.nn.one_hot(seg_ids, n_segments, dtype=x.dtype)  # (N,S)
    cnt = jnp.maximum(one_hot.T @ w, 1e-30)                        # (S,)
    mean = (one_hot * wj).T @ x / cnt[:, None]                     # (S,D)
    ex2 = (one_hot * wj).T @ (x * x) / cnt[:, None]
    std = jnp.sqrt(jnp.maximum(ex2 - mean * mean, 1e-8))
    return (x - mean[seg_ids]) / std[seg_ids]


def cmvn_window(x: jax.Array, w: jax.Array, window: int,
                global_fallback: bool = True) -> jax.Array:
    """Sliding-window CMVN: each frame normalised by the statistics of the
    +-window/2 frames around it (reference ``segmentalMode window`` /
    NormFeatWindowMode computeCMVparameters).

    The reference compensates short windows with global statistics
    (NormFeat.cpp:358-430); ``global_fallback`` pads the window mass with
    the global mean/var when fewer than ``window`` frames are selected.
    Implemented with cumulative sums over the frame axis (prefix-scan
    re-expression of the sequential window loop).
    """
    half = window // 2
    wj = w[:, None]
    cw = jnp.cumsum(jnp.concatenate([jnp.zeros((1,)), w]))          # (N+1,)
    cx = jnp.cumsum(jnp.concatenate([jnp.zeros((1, x.shape[1])), x * wj]),
                    axis=0)
    cxx = jnp.cumsum(jnp.concatenate([jnp.zeros((1, x.shape[1])),
                                      x * x * wj]), axis=0)
    n = x.shape[0]
    lo = jnp.clip(jnp.arange(n) - half, 0, n)
    hi = jnp.clip(jnp.arange(n) + half + 1, 0, n)
    cnt = cw[hi] - cw[lo]                                           # (N,)
    sx = cx[hi] - cx[lo]
    sxx = cxx[hi] - cxx[lo]
    if global_fallback:
        gmean, gstd = _masked_mean_std(x, w)
        deficit = jnp.maximum(window - cnt, 0.0)[:, None]
        sx = sx + deficit * gmean[None, :]
        sxx = sxx + deficit * (gstd * gstd + gmean * gmean)[None, :]
        cnt = jnp.maximum(cnt, 1e-30) + deficit[:, 0]
    else:
        cnt = jnp.maximum(cnt, 1e-30)
    mean = sx / cnt[:, None]
    var = jnp.maximum(sxx / cnt[:, None] - mean * mean, 1e-8)
    return (x - mean) / jnp.sqrt(var)


def feature_mapping(x: jax.Array, channel_gmm, reference_gmm) -> jax.Array:
    """Feature mapping (reference featMap, NormFeat.cpp:583 and
    GeneralTools featureMapping h:281-286): map each frame through its
    winning component of the channel-dependent GMM onto the
    channel-independent reference GMM:
        x' = μ_ref,k* + σ_ref,k*/σ_ch,k* · (x − μ_ch,k*).
    """
    from ..gmm.kernels import weighted_logdens
    ld = weighted_logdens(x, channel_gmm)
    k_star = jnp.argmax(ld, axis=-1)                       # (N,)
    mu_ch = channel_gmm.means[k_star]
    mu_ref = reference_gmm.means[k_star]
    # σ_ref/σ_ch = sqrt(covInv_ch / covInv_ref)
    scale = jnp.sqrt(channel_gmm.cov_inv[k_star]
                     / reference_gmm.cov_inv[k_star])
    return mu_ref + scale * (x - mu_ch)


@functools.partial(jax.jit, static_argnames=("window", "chunk"))
def warp_core_prepadded(xp: jax.Array, wp: jax.Array, window: int = 301,
                        chunk: int = 256) -> jax.Array:
    """Warp core over a PRE-PADDED signal: xp (P + 2·half, D) where rows
    [half, half+n) are the real frames, the flanks hold the caller-built
    reflection padding and anything beyond carries zero weight in wp.
    Returns (P, D); only the first n rows are meaningful.  Pre-padding on
    the host lets same-bucket files share one compiled executable
    (compile-once obligation vs the reference's per-file stream,
    NormFeat.cpp:661)."""
    half = window // 2
    d = xp.shape[1]
    total = xp.shape[0] - 2 * half                            # P

    def block(start):
        idx = start + jnp.arange(chunk)                       # (C,)
        centre = xp[idx + half]                               # (C,D)
        win_idx = idx[:, None] + jnp.arange(window)[None, :]  # (C,W)
        win = xp[win_idx]                                     # (C,W,D)
        ww = wp[win_idx]                                      # (C,W)
        less = (win < centre[:, None, :]).astype(xp.dtype)
        rank = jnp.einsum("cwd,cw->cd", less, ww)
        cnt = jnp.maximum(jnp.sum(ww, axis=1), 1.0)[:, None]
        p = (rank + 0.5) / (cnt + 1.0)
        return ndtri(jnp.clip(p, 1e-6, 1.0 - 1e-6))

    starts = jnp.arange(0, total, chunk)
    out = jax.lax.map(block, starts)                          # (B,C,D)
    return out.reshape(-1, d)


@functools.partial(jax.jit, static_argnames=("window", "chunk"))
def feature_warping(x: jax.Array, w: jax.Array, window: int = 301,
                    chunk: int = 256) -> jax.Array:
    """Gaussian feature warping over a sliding window.

    Reference featWarp (NormFeat.cpp:661, computeWarp GeneralTools:642):
    per coefficient, the empirical CDF rank of the centre frame within its
    window is mapped through the inverse normal CDF.  The histogram
    machinery of the reference reduces to exact rank computation; the
    window loop is blocked so the (chunk, window, D) comparison tensor
    stays on-chip.
    """
    n, d = x.shape
    half = window // 2
    pad_lo = jnp.flip(x[:half], axis=0)          # reflect-pad edges
    pad_hi = jnp.flip(x[-half:], axis=0)
    npad = (-n) % chunk
    xp = jnp.concatenate([pad_lo, x, pad_hi,
                          jnp.zeros((npad, d), x.dtype)], axis=0)
    wp = jnp.concatenate([jnp.flip(w[:half]), w, jnp.flip(w[-half:]),
                          jnp.zeros((npad,), w.dtype)])
    return warp_core_prepadded(xp, wp, window, chunk)[:n]


@functools.partial(jax.jit, static_argnames=("cms_only", "var_only"))
def cmvn_global_batch(x: jax.Array, w: jax.Array, cms_only: bool = False,
                      var_only: bool = False) -> jax.Array:
    """File-mode CMVN over a padded file batch (B,T,D)×(B,T) — one
    compiled executable per bucket shape instead of one per file shape
    (the compiled counterpart of the reference's compile-nothing
    per-file stream, NormFeat.cpp:231).  Zero-weight padding rows are
    exact: every statistic is weighted by w."""
    return jax.vmap(lambda a, b: cmvn_global(a, b, cms_only=cms_only,
                                             var_only=var_only))(x, w)


@functools.partial(jax.jit, static_argnames=("window", "global_fallback"))
def cmvn_window_batch(x: jax.Array, w: jax.Array, window: int,
                      global_fallback: bool = True) -> jax.Array:
    """Sliding-window CMVN over a padded file batch (B,T,D)×(B,T)."""
    return jax.vmap(lambda a, b: cmvn_window(a, b, window,
                                             global_fallback))(x, w)


@functools.partial(jax.jit, static_argnames=("window", "chunk"))
def feature_warping_batch(xp: jax.Array, wp: jax.Array, window: int = 301,
                          chunk: int = 256) -> jax.Array:
    """Feature warping over a batch of PRE-PADDED signals
    (B, P + 2·half, D) — see warp_core_prepadded for the layout."""
    return jax.vmap(lambda a, b: warp_core_prepadded(a, b, window,
                                                     chunk))(xp, wp)
