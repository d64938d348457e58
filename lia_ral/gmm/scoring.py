"""GMM-UBM trial scoring: LLR with top-K component selection.

JAX equivalent of reference ``LIA_SpkDet/ComputeTest/ComputeTest.cpp``
(main loop cpp:90-224): for each test file the world model determines the
top-K components on every ``worldDecime``-th frame (DETERMINE_TOP_DISTRIBS)
and every model — world included on non-determine frames — is then scored
on those components only, completed by the world's non-top residual mass
from the determine frame (USE_TOP_DISTRIBS; ALIZE LKVector
sumNonTopDistribLK semantics).  LLR = client meanLLK − world meanLLK.

Here the "top-10 speed trick" is re-expressed as dense matmuls + a
vectorised gather: computing the full (N,K) log-density block is one
matrix product,
while faithfully reproducing the approximation keeps score parity with the
reference.  Scoring C clients at once batches the client matmuls into one
(N,D)@(D,C·K) contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .kernels import weighted_logdens
from .model import GmmDiag


def decime_groups(seg_lengths: list[int], world_decime: int) -> np.ndarray:
    """Group-leader frame index for every frame of a masked frame sequence.

    The reference restarts decimation at each segment (idxFrame counts
    within the segment, ComputeTest.cpp:160); frames in the same group
    share the top-component set determined at the group leader.
    """
    out = []
    base = 0
    for L in seg_lengths:
        idx = np.arange(L)
        out.append(base + (idx // world_decime) * world_decime)
        base += L
    return (np.concatenate(out) if out else np.zeros(0, np.int64)).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("top_k", "use_residual"))
def top_k_llk(
    x: jax.Array,
    world: GmmDiag,
    clients: GmmDiag,       # stacked pytree with leading C axis
    groups: jax.Array,      # (N,) int32 group-leader frame index
    top_k: int = 10,
    use_residual: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Per-frame llk for world (N,) and clients (C,N) under top-K scoring.

    ``groups[t]`` = frame whose DETERMINE pass fixes the top set for t
    (groups = arange(N) → determine every frame, worldDecime=1).
    """
    top_k = min(top_k, world.n_components)
    wld = weighted_logdens(x, world)                       # (N,K)
    full_llk = jax.nn.logsumexp(wld, axis=-1)              # (N,)
    # top components at the determine frames (gathered per frame via groups)
    top_vals, top_idx = jax.lax.top_k(wld, top_k)          # (N,k)
    top_vals = top_vals[groups]                            # stale sets
    top_idx = top_idx[groups]
    det_full = full_llk[groups]
    if use_residual:
        # residual mass of the non-top world components at the determine
        # frame: log(exp(full) − exp(top_lse)), computed stably
        top_lse = jax.nn.logsumexp(top_vals, axis=-1)
        diff = jnp.clip(top_lse - det_full, max=-1e-7)
        residual = det_full + jnp.log1p(-jnp.exp(diff))    # (N,)
    else:
        residual = jnp.full_like(det_full, -jnp.inf)

    def model_llk(ld):
        """top-sum of a model's own densities + world residual — (N,)."""
        sel = jnp.take_along_axis(ld, top_idx, axis=-1)    # (N,k)
        stacked = jnp.concatenate([sel, residual[:, None]], axis=-1)
        return jax.nn.logsumexp(stacked, axis=-1)

    # world: DETERMINE frames get the full llk, USE frames the approximation
    is_det = jnp.arange(x.shape[0], dtype=groups.dtype) == groups
    world_llk = jnp.where(is_det, full_llk, model_llk(wld))
    client_llk = jax.vmap(
        lambda c: model_llk(weighted_logdens(x, c)))(clients)  # (C,N)
    return world_llk, client_llk


def compute_test_llr(
    x: jax.Array,
    w: jax.Array,
    world: GmmDiag,
    clients: GmmDiag,
    groups: jax.Array | None = None,
    top_k: int = 10,
    use_residual: bool = True,
) -> jax.Array:
    """File-mode trial LLRs (C,): client meanLLK − world meanLLK over the
    weighted frames (ComputeTest.cpp:197-210)."""
    if groups is None:
        groups = jnp.arange(x.shape[0], dtype=jnp.int32)
    world_llk, client_llk = top_k_llk(x, world, clients, groups,
                                      top_k=top_k, use_residual=use_residual)
    cnt = jnp.maximum(jnp.sum(w), 1e-30)
    mean_w = jnp.sum(world_llk * w) / cnt
    mean_c = jnp.sum(client_llk * w[None, :], axis=-1) / cnt
    return mean_c - mean_w


@functools.partial(jax.jit, static_argnames=("top_k", "use_residual"))
def compute_test_llr_batch(
    x: jax.Array,        # (B, T, D) padded test segments
    w: jax.Array,        # (B, T) frame weights (0 = padding)
    world: GmmDiag,
    clients: GmmDiag,    # stacked pytree with leading C axis (shared)
    groups: jax.Array,   # (B, T) per-line decime group leaders
    top_k: int = 10,
    use_residual: bool = True,
) -> jax.Array:
    """Many NDX lines against ONE client set in a single dispatch —
    (B, C) LLRs.  The reference scores line-by-line (ComputeTest.cpp:90
    loop); on a device the per-line dispatch round-trip dominates large trial
    lists, so same-client-set lines batch through one vmapped executable
    per (bucketed length, client count) shape."""
    return jax.vmap(
        lambda xi, wi, gi: compute_test_llr(
            xi, wi, world, clients, groups=gi, top_k=top_k,
            use_residual=use_residual))(x, w, groups)


def stack_gmms(gmms: list[GmmDiag]) -> GmmDiag:
    """Stack a list of same-shape GMMs into one pytree with leading C axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *gmms)


def set_decision(llr, threshold: float):
    """Reference setDecision (GeneralTools.cpp:232): 1 iff LLR >= thr."""
    return jnp.where(jnp.asarray(llr) >= threshold, 1, 0)


@functools.partial(jax.jit, static_argnames=("top_data", "top_model"))
def likelihood_gd(data: GmmDiag, model: GmmDiag,
                  top_data: int | None = None,
                  top_model: int | None = None) -> jax.Array:
    """Model-vs-model expected likelihood — reference likelihoodGD
    (GeneralTools.cpp:816-855): for each (top-weight) data component d,
    lk(d) = Σ_m w_m · cst_m · exp(−½ Σ_i (cov_d + Δμ²)/cov_m), and the
    result is Σ_d w_d · log lk(d).  TabWeight component selection
    (GeneralTools.h:153+) = top-N by weight.

    Batched as a (Kd, Km) pairwise block: the Σ_i contraction is a
    matmul of [cov_d + μ_d², μ_d, 1] against the model's precision
    features, the same augmented-design trick as the frame kernels.
    """
    kd, km = data.n_components, model.n_components
    top_data = kd if top_data is None else min(top_data, kd)
    top_model = km if top_model is None else min(top_model, km)
    wd, di = jax.lax.top_k(data.weights, top_data)
    wm, mi = jax.lax.top_k(model.weights, top_model)
    d_mean, d_cov = data.means[di], data.cov[di]            # (kd,D)
    m_mean, m_inv = model.means[mi], model.cov_inv[mi]      # (km,D)
    # Σ_i (cov_d + (μd−μm)²)·inv_m  =  (cov_d+μd²)·inv_m − 2 μd·(μm inv_m)
    #                                  + (μm² inv_m)
    a = jnp.concatenate([d_cov + d_mean ** 2, d_mean,
                         jnp.ones((top_data, 1), d_mean.dtype)], axis=-1)
    b = jnp.concatenate([m_inv, -2.0 * m_mean * m_inv,
                         jnp.sum(m_mean ** 2 * m_inv, axis=-1,
                                 keepdims=True)], axis=-1)
    quad = a @ b.T                                          # (kd,km)
    log_terms = model.log_const()[mi][None, :] + jnp.log(wm)[None, :] \
        - 0.5 * quad
    lk_comp = jax.nn.logsumexp(log_terms, axis=-1)          # (kd,) log lk(d)
    return jnp.sum(wd * lk_comp)
