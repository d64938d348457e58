"""GmmDiag: the diagonal-covariance GMM model pytree.

JAX replacement for ALIZE MixtureGD/DistribGD (SURVEY.md §1.1).
Where the reference stores per-component objects with cached ``cst``/``det``
scalars, we store three dense arrays — ``weights (K,)``, ``means (K,D)``,
``cov_inv (K,D)`` — and derive log-space constants inside the kernels
(cheap VPU work that XLA fuses into the surrounding matmuls).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..pytree import dataclass as pytree_dataclass

_LOG_2PI = math.log(2.0 * math.pi)


@pytree_dataclass
class GmmDiag:
    """weights[K], means[K,D], cov_inv[K,D] (inverse variances)."""

    weights: jax.Array
    means: jax.Array
    cov_inv: jax.Array

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def cov(self) -> jax.Array:
        return 1.0 / self.cov_inv

    def log_const(self) -> jax.Array:
        """Per-component log of the Gaussian normaliser:
        log cst_k = -0.5·(D·log2π − Σ_d log covInv_kd)."""
        d = self.dim
        return -0.5 * (d * _LOG_2PI - jnp.sum(jnp.log(self.cov_inv), axis=-1))

    def log_weights(self) -> jax.Array:
        return jnp.log(self.weights)

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(cls, weights, means, cov_inv, dtype=jnp.float32) -> "GmmDiag":
        return cls(
            weights=jnp.asarray(weights, dtype),
            means=jnp.asarray(means, dtype),
            cov_inv=jnp.asarray(cov_inv, dtype),
        )

    @classmethod
    def from_cov(cls, weights, means, cov, dtype=jnp.float32) -> "GmmDiag":
        cov = jnp.asarray(cov, dtype)
        return cls.create(weights, means, 1.0 / cov, dtype)

    @classmethod
    def uniform_init(cls, k: int, d: int, dtype=jnp.float32) -> "GmmDiag":
        """Unit-variance zero-mean equal-weight init (ALIZE fresh MixtureGD)."""
        return cls(
            weights=jnp.full((k,), 1.0 / k, dtype),
            means=jnp.zeros((k, d), dtype),
            cov_inv=jnp.ones((k, d), dtype),
        )

    # -- file IO (host side) -------------------------------------------------
    @classmethod
    def load(cls, path: str, fmt: str | None = None, dtype=jnp.float32) -> "GmmDiag":
        from ..io.gmm_io import read_gmm_file
        w, m, ci = read_gmm_file(path, fmt)
        return cls.create(w, m, ci, dtype)

    def save(self, path: str, fmt: str = "RAW", model_id: str = "#1") -> None:
        from ..io.gmm_io import write_gmm_file
        write_gmm_file(
            path,
            np.asarray(self.weights, np.float64),
            np.asarray(self.means, np.float64),
            np.asarray(self.cov_inv, np.float64),
            fmt=fmt,
            model_id=model_id,
        )

    def astype(self, dtype) -> "GmmDiag":
        return GmmDiag(
            weights=self.weights.astype(dtype),
            means=self.means.astype(dtype),
            cov_inv=self.cov_inv.astype(dtype),
        )
