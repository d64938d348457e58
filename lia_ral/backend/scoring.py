"""i-vector trial scoring: cosine, Mahalanobis, two-covariance.

JAX equivalent of reference ``PldaTest`` scoring backends
(PldaTools.cpp): cosineDistance (cpp:3842), mahalanobisDistance,
twoCovScoring (cpp:4083-4180).  Each is one batched matmul pipeline over
(models × segments); the reference's BoolMatrix trial mask is applied by
the caller.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cosine_scores(models: jax.Array, segments: jax.Array,
                  wccn: jax.Array | None = None) -> jax.Array:
    """Cosine similarity (M,T) — reference cosineDistance (cpp:3842),
    optionally in WCCN-transformed space."""
    if wccn is not None:
        models = models @ wccn.T
        segments = segments @ wccn.T
    mn = models / jnp.maximum(jnp.linalg.norm(models, axis=-1,
                                              keepdims=True), 1e-12)
    sn = segments / jnp.maximum(jnp.linalg.norm(segments, axis=-1,
                                                keepdims=True), 1e-12)
    return mn @ sn.T


def mahalanobis_scores(models: jax.Array, segments: jax.Array,
                       metric: jax.Array) -> jax.Array:
    """−(m−s)ᵀ·M·(m−s) per trial (reference mahalanobisDistance)."""
    cross = models @ metric @ segments.T                    # (M,T)
    qm = jnp.einsum("mr,rq,mq->m", models, metric, models)
    qs = jnp.einsum("tr,rq,tq->t", segments, metric, segments)
    return 2.0 * cross - qm[:, None] - qs[None, :]


def two_cov_model(w: jax.Array, b: jax.Array
                  ) -> tuple[jax.Array, jax.Array]:
    """G' and H' matrices of two-covariance scoring — reference
    twoCovScoring (cpp:4083-4130):
    G' = W⁻¹·(B⁻¹+2W⁻¹)⁻¹·W⁻¹ ; H' = W⁻¹·(B⁻¹+W⁻¹)⁻¹·W⁻¹."""
    r = w.shape[0]
    eye = jnp.eye(r, dtype=w.dtype)
    w_inv = jnp.linalg.inv(w + 1e-8 * eye)
    b_inv = jnp.linalg.inv(b + 1e-8 * eye)
    g = w_inv @ jnp.linalg.inv(b_inv + 2.0 * w_inv) @ w_inv
    h = w_inv @ jnp.linalg.inv(b_inv + w_inv) @ w_inv
    return g, h


def two_cov_scores(models: jax.Array, segments: jax.Array,
                   w: jax.Array, b: jax.Array) -> jax.Array:
    """Two-covariance LLR (M,T) — reference twoCovScoring (cpp:4083-4180):
    (m+s)ᵀG'(m+s) − mᵀH'm − sᵀH's (constant terms omitted, as in the
    reference)."""
    g, h = two_cov_model(w, b)
    qm = jnp.einsum("mr,rq,mq->m", models, h, models)       # (M,)
    qs = jnp.einsum("tr,rq,tq->t", segments, h, segments)   # (T,)
    # (m+s)ᵀG(m+s) = mᵀGm + 2 mᵀGs + sᵀGs
    gm = jnp.einsum("mr,rq,mq->m", models, g, models)
    gs = jnp.einsum("tr,rq,tq->t", segments, g, segments)
    cross = models @ g @ segments.T                         # (M,T)
    mix = gm[:, None] + 2.0 * cross + gs[None, :]
    return mix - qm[:, None] - qs[None, :]
