"""GMM supervectors, NAP projection, Fisher/KL kernels, NAP training.

JAX equivalent of reference ``LIA_SpkTools/SuperVectors``
(SuperVectors.cpp): modelToSv/svToModel (cpp:70-86), projectOnSubSpace
(cpp:108-126), computeNap (cpp:128-138), computeNAPChannelEffect
(cpp:160-232), getFisherWeightVector (cpp:240), getKLVector (cpp:253),
getSuperVector dispatch (cpp:266) — plus the NAP-subspace training of
``LIA_SpkDet/CovIntra`` (CovIntra.cpp:257: within-class covariance top
eigenvectors via SVDLIBC Lanczos → here jnp.linalg SVD).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..gmm.model import GmmDiag


def model_to_sv(gmm: GmmDiag) -> jax.Array:
    """Concatenated means (K·D,) (reference modelToSv, cpp:70)."""
    return gmm.means.reshape(-1)


def sv_to_model(sv: jax.Array, gmm: GmmDiag) -> GmmDiag:
    """Replace a model's means from a supervector (reference svToModel)."""
    return gmm.replace(means=sv.reshape(gmm.means.shape))


def project_on_subspace(x: jax.Array, u: jax.Array) -> jax.Array:
    """U·(Uᵀ·x) — the channel-subspace component of x (reference
    projectOnSubSpace, cpp:108; rows of ``u`` span the subspace)."""
    return (x @ u.T) @ u


def compute_nap(gmm: GmmDiag, u: jax.Array) -> GmmDiag:
    """Remove the nuisance-subspace component from a model's mean
    supervector (reference computeNap, cpp:128-138)."""
    sv = model_to_sv(gmm)
    return sv_to_model(sv - project_on_subspace(sv[None, :], u)[0], gmm)


def nap_project_vectors(vectors: jax.Array, u: jax.Array) -> jax.Array:
    """Batched NAP on raw supervectors (reference NAPSV utility)."""
    return vectors - project_on_subspace(vectors, u)


def fisher_weight_vector(world: GmmDiag, client: GmmDiag) -> jax.Array:
    """Weight-ratio Fisher vector c_k/w_k (reference
    getFisherWeightVector, cpp:240-249; 'SVMUBM' supervector)."""
    return client.weights / world.weights


def kl_vector(model: GmmDiag) -> jax.Array:
    """KL-kernel supervector μ_kd·sqrt(w_k·covInv_kd) (reference
    getKLVector, cpp:253-265)."""
    scale = jnp.sqrt(model.weights[:, None] * model.cov_inv)
    return (model.means * scale).reshape(-1)


def get_supervector(mode: str, world: GmmDiag, client: GmmDiag) -> jax.Array:
    """Reference getSuperVector dispatch (cpp:266-277): SVMUBM | KL."""
    if mode == "SVMUBM":
        return fisher_weight_vector(world, client)
    if mode == "KL":
        return kl_vector(client)
    raise ValueError("Cannot find supervector mode [KL|SVMUBM]")


def train_nap_subspace(vectors: jax.Array, spk_ids: jax.Array,
                       n_speakers: int, rank: int) -> jax.Array:
    """NAP / within-class covariance subspace (reference CovIntra.cpp:
    151-280): top-``rank`` eigenvectors of the within-speaker scatter of
    the supervectors, via SVD of the speaker-centered matrix (replacing
    SVDLIBC svdLAS2).  Returns (rank, dim) with orthonormal rows."""
    one_hot = jax.nn.one_hot(spk_ids, n_speakers, dtype=vectors.dtype)
    counts = jnp.maximum(one_hot.sum(axis=0), 1.0)
    means = (one_hot.T @ vectors) / counts[:, None]
    centered = vectors - means[spk_ids]
    # right singular vectors of the centered matrix = eigenvectors of the
    # within-class scatter
    _, _, vt = jnp.linalg.svd(centered, full_matrices=False)
    return vt[:rank]
