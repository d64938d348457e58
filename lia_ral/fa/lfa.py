"""Latent Factor Analysis (LFA): the older symmetrical-FA channel model.

JAX equivalent of reference ``LIA_SpkTools/FactorAnalysis``
(FactorAnalysis.h:121-211): M_{s,h} = m + D·z_s + U·x_h with D the
relevance-factor diagonal prior (D² = Σ/τ, FactorAnalysis ``_tau``) —
channel compensation of models AND features:

* getXEstimate/getYEstimate (h:182-191) → latent posteriors (shared
  machinery with fa.jfa);
* substractSpeakerStats/substractChannelStats (h:206-207) → stat
  centering;
* normalizeFeatures (h:210-211) → feature-domain channel compensation
  x_t ← x_t − Σ_g γ_g(t)·(U·x_h)_g, the normFeatLFA path
  (AccumulateJFAStat substractUXfromFeatures cpp:4689 and
  NormFeat.cpp:856).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..gmm.kernels import llk_and_posteriors
from ..gmm.model import GmmDiag
from .jfa import (JfaModel, JfaStats, _latent_posterior, _subspace_gram,
                  estimate_x, estimate_z_map, jfa_u_iteration)
from .stats import BwStats


def lfa_model(u: jax.Array, gmm: GmmDiag, tau: float = 16.0) -> JfaModel:
    """LFA as a JFA model with V absent and D fixed by the relevance
    factor: D = sqrt(Σ/τ) (reference _tau semantics — MAP prior with
    relevance τ on the speaker offset)."""
    k, d = gmm.means.shape
    d_mat = jnp.sqrt((1.0 / jnp.asarray(gmm.cov_inv)) / tau)
    return JfaModel(
        v=jnp.zeros((1, k, d), jnp.float32),
        u=jnp.asarray(u, jnp.float32),
        d=d_mat.astype(jnp.float32),
        ubm_means=jnp.asarray(gmm.means, jnp.float32),
        ubm_inv_var=jnp.asarray(gmm.cov_inv, jnp.float32),
    )


def lfa_train(key: jax.Array, stats: JfaStats, gmm: GmmDiag, rank_u: int,
              nb_it: int = 10, tau: float = 16.0, verbose: bool = False
              ) -> JfaModel:
    """Train the channel subspace U under the LFA model (reference
    EigenChannel LFA variant, EigenChannel.cpp:70-200 with
    ``channelCompensation LFA``)."""
    k, d = gmm.means.shape
    s = stats.spk.n.shape[0]
    model = lfa_model(
        jax.random.normal(key, (rank_u, k, d), jnp.float32) * 0.001,
        gmm, tau)
    z = jnp.zeros((s, k, d), jnp.float32)
    x = jnp.zeros((stats.sess.n.shape[0], rank_u), jnp.float32)
    for it in range(nb_it):
        # z via MAP relevance, y stays zero (no eigenvoice in LFA)
        z = estimate_z_map(stats, model, jnp.zeros((s, 1), jnp.float32),
                           x, tau=tau)
        model, x = jfa_u_iteration(stats, model,
                                   jnp.zeros((s, 1), jnp.float32), z)
        if verbose:
            print(f"LFA U it {it}: |U|={float(jnp.abs(model.u).mean()):.6f}")
    return model


def estimate_channel(stats_session: BwStats, model: JfaModel) -> jax.Array:
    """Channel factor x for test sessions with no speaker prior
    (reference getXEstimate): z=0, y=0."""
    h = stats_session.n.shape[0]
    k, d = model.ubm_means.shape
    js = JfaStats.from_sessions(stats_session, np.arange(h), h)
    x, _ = estimate_x(js, model, jnp.zeros((h, model.rank_v), jnp.float32),
                      jnp.zeros((h, k, d), jnp.float32))
    return x


def compensate_features(x: jax.Array, gmm: GmmDiag, model: JfaModel,
                        x_h: jax.Array) -> jax.Array:
    """Feature-domain channel compensation (reference
    substractUXfromFeatures, AccumulateJFAStat.cpp:4689; NormFeat
    normFeatLFA cpp:856): x_t ← x_t − Σ_g γ_g(t)·(U·x_h)_g."""
    ux = jnp.einsum("r,rkd->kd", x_h, model.u)          # (K,D)
    _, post = llk_and_posteriors(x, gmm)                # (N,K)
    return x - jnp.dot(post, ux, preferred_element_type=jnp.float32)


def compensate_model(gmm: GmmDiag, model: JfaModel, x_h: jax.Array
                     ) -> GmmDiag:
    """Model-domain compensation: shift means by U·x_h (the
    TrainTargetFA / ComputeTestLFA path, TrainTarget.cpp:279-420)."""
    ux = jnp.einsum("r,rkd->kd", x_h, model.u)
    return gmm.replace(means=gmm.means + ux)
