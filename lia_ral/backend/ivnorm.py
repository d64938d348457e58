"""i-vector normalization: length-norm, EFR/sphNorm, LDA, WCCN, Mahalanobis.

JAX equivalent of reference ``PldaDev`` (PldaTools.cpp): lengthNorm
(cpp:436), center (cpp:466), computeCovMat (cpp:516-754 — total/within/
between scatter), computeWccnChol (cpp:1113), computeMahalanobis
(cpp:1366), computeLDA (cpp:1381), sphericalNuisanceNormalization
(cpp:1822-1928 — EFR & sphNorm iterations of {cov → eig → whiten →
center → length-norm}).

A dev set is (vectors (N,R), speaker ids (N,)); all statistics are
one-hot matmuls over the speaker axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class DevSet:
    """Development i-vectors with speaker labels."""

    vectors: jax.Array     # (N, R)
    spk_ids: jax.Array     # (N,) int in [0, n_speakers)
    n_speakers: int

    @classmethod
    def from_labels(cls, vectors, labels: list[str]) -> "DevSet":
        uniq = {}
        ids = []
        for lab in labels:
            ids.append(uniq.setdefault(lab, len(uniq)))
        return cls(jnp.asarray(vectors, jnp.float32),
                   jnp.asarray(np.asarray(ids, np.int32)), len(uniq))


def length_norm(x: jax.Array) -> jax.Array:
    """x / ||x|| (reference lengthNorm, cpp:436)."""
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def compute_cov_matrices(dev: DevSet
                         ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(Sigma total, W within, B between) — reference computeCovMat
    (cpp:516-560); all divided by the session count."""
    x = dev.vectors
    n = x.shape[0]
    mean = jnp.mean(x, axis=0)
    xc = x - mean
    sigma = (xc.T @ xc) / n
    one_hot = jax.nn.one_hot(dev.spk_ids, dev.n_speakers, dtype=x.dtype)
    counts = jnp.maximum(one_hot.sum(axis=0), 1.0)            # (S,)
    spk_means = (one_hot.T @ x) / counts[:, None]             # (S,R)
    xw = x - spk_means[dev.spk_ids]
    w = (xw.T @ xw) / n
    bm = spk_means - mean[None, :]
    b = ((bm * counts[:, None]).T @ bm) / n
    return sigma, w, b


def _inv_sqrt(mat: jax.Array, floor: float = 1e-12) -> jax.Array:
    """M^(-1/2) via eigendecomposition — rows of the result are the
    whitening transform the reference stores (sphNormMat = (V·Λ^-½)ᵀ).
    ``floor`` clips the eigenvalues before the inverse square root."""
    vals, vecs = jnp.linalg.eigh(mat)
    return (vecs * (1.0 / jnp.sqrt(jnp.maximum(vals, floor)))[None, :]).T


def efr_iterations(dev: DevSet, n_iterations: int = 1, mode: str = "EFR"
                   ) -> tuple[jax.Array, list[tuple[jax.Array, jax.Array]]]:
    """EFR / spherical nuisance normalization on the dev set.

    Reference sphericalNuisanceNormalization (cpp:1822-1928): iterate
    {compute Σ (EFR) or W (sphNorm) → M=Σ^-½ → center → rotate →
    length-norm}.  Returns the normalised vectors and the list of
    (mean, M) per iteration needed to apply the same transform to test
    vectors (applySphericalNuisanceNormalization, cpp:1931).
    """
    x = dev.vectors
    n, r = x.shape
    params: list[tuple[jax.Array, jax.Array]] = []
    for _ in range(n_iterations):
        d = dataclasses.replace(dev, vectors=x)
        sigma, w, _ = compute_cov_matrices(d)
        cov = w if mode == "sphNorm" else sigma
        # A dev set smaller than the vector dimension yields a singular
        # covariance; whitening then amplifies pure estimation noise in
        # the (R−n+1)-dim null space by ~1/√ε and destroys the scores
        # (measured: cosine EER 0 → 0.5 on a 36-vector, R=64 set).  The
        # reference assumes dev ≫ R and never guards (PldaTools.cpp:
        # 1822-1928); here the null directions are floored at the mean
        # eigenvalue trace/R so they pass through at a typical scale.
        floor = (float(jnp.trace(cov)) / r if n - 1 < r else 1e-12)
        m = _inv_sqrt(cov, floor)
        mean = jnp.mean(x, axis=0)
        params.append((mean, m))
        x = length_norm((x - mean[None, :]) @ m.T)
    return x, params


def apply_efr(x: jax.Array, params: list[tuple[jax.Array, jax.Array]]
              ) -> jax.Array:
    """Apply recorded EFR transforms to new vectors."""
    for mean, m in params:
        x = length_norm((x - mean[None, :]) @ m.T)
    return x


def compute_lda(dev: DevSet, rank: int) -> jax.Array:
    """LDA projection (reference computeLDA, cpp:1381): top generalized
    eigenvectors of W⁻¹B, returned as (rank, R) projection rows."""
    _, w, b = compute_cov_matrices(dev)
    w = w + 1e-6 * jnp.eye(w.shape[0], dtype=w.dtype)
    # solve the symmetric generalized problem via W^-1/2
    wis = _inv_sqrt(w)
    m = wis @ b @ wis.T
    vals, vecs = jnp.linalg.eigh(m)
    top = vecs[:, ::-1][:, :rank]                  # descending eigenvalues
    proj = (wis.T @ top).T                         # (rank, R)
    return proj


def compute_wccn(dev: DevSet) -> jax.Array:
    """WCCN Cholesky transform (reference computeWccnChol, cpp:1113):
    W⁻¹ = L·Lᵀ, returns Lᵀ (apply as x @ L)."""
    _, w, _ = compute_cov_matrices(dev)
    w = w + 1e-6 * jnp.eye(w.shape[0], dtype=w.dtype)
    w_inv = jnp.linalg.inv(w)
    l = jnp.linalg.cholesky(w_inv)
    return l.T


def compute_mahalanobis(dev: DevSet) -> jax.Array:
    """Within-class Mahalanobis metric W⁻¹ (reference computeMahalanobis,
    cpp:1366)."""
    _, w, _ = compute_cov_matrices(dev)
    w = w + 1e-6 * jnp.eye(w.shape[0], dtype=w.dtype)
    return jnp.linalg.inv(w)
