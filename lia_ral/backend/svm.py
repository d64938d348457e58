"""Kernel SVM (C-SVC) for GMM-supervector speaker models.

JAX replacement for the reference's bundled libsvm
(``LIA_Utils/Svm``: C_SVC setup Svm.cpp:91-119 — linear kernel by
default, C defaulting to 1/avg‖x‖², optional target-class penalty for
the 1-target-vs-cohort NIST setup).  The SMO solver is replaced by a
batched projected-gradient ascent on the dual — every iteration is a
kernel-matrix matvec, trivially vmappable over many
one-vs-cohort problems at once.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


def kernel_matrix(x: jax.Array, y: jax.Array, kind: str = "linear",
                  degree: int = 1, gamma: float = 0.0,
                  coef0: float = 0.0) -> jax.Array:
    """libsvm kernel types 0-2 (reference kernelType config key)."""
    if kind == "linear":
        return x @ y.T
    if kind == "poly":
        g = gamma if gamma > 0 else 1.0 / x.shape[1]
        return (g * (x @ y.T) + coef0) ** degree
    if kind == "rbf":
        g = gamma if gamma > 0 else 1.0 / x.shape[1]
        d2 = (jnp.sum(x * x, 1)[:, None] + jnp.sum(y * y, 1)[None, :]
              - 2.0 * x @ y.T)
        return jnp.exp(-g * d2)
    raise ValueError(f"unknown kernel {kind}")


@dataclasses.dataclass
class SvmModel:
    support: np.ndarray     # (N, D) training vectors
    alpha_y: np.ndarray     # (N,) α_i·y_i
    bias: float
    kind: str = "linear"
    degree: int = 1
    gamma: float = 0.0
    coef0: float = 0.0

    def decision(self, x: jax.Array) -> jax.Array:
        k = kernel_matrix(jnp.asarray(x, jnp.float32),
                          jnp.asarray(self.support, jnp.float32),
                          self.kind, self.degree, self.gamma, self.coef0)
        return k @ jnp.asarray(self.alpha_y, jnp.float32) + self.bias


def default_c(x: np.ndarray) -> float:
    """Reference getC (Svm.cpp:75-84): C = 1/mean‖x‖²."""
    return float(1.0 / max(np.mean(np.sum(x * x, axis=1)), 1e-12))


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _dual_solve(k: jax.Array, y: jax.Array, c_vec: jax.Array,
                n_iter: int = 500) -> jax.Array:
    """Projected-gradient ascent on the C-SVC dual:
    max Σα − ½·αᵀ·Q·α  s.t. 0 ≤ α_i ≤ C_i, Σ α_i·y_i = 0,
    with Q = y·yᵀ ∘ K.  Each step projects onto the box and onto the
    equality constraint (alternating projection)."""
    q = k * (y[:, None] * y[None, :])
    # step size 1/λ_max(Q) via a few power iterations
    v0 = jnp.ones((q.shape[0],), q.dtype) / q.shape[0]

    def power(v, _):
        v = q @ v
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-12), None

    v, _ = jax.lax.scan(power, v0, None, length=16)
    lam_max = jnp.abs(v @ (q @ v))
    lr = 1.0 / jnp.maximum(lam_max, 1e-8)

    def project(a):
        # exact projection onto {0 ≤ α ≤ C} ∩ {αᵀy = 0}:
        # α(λ) = clip(a − λ·y, 0, C); g(λ) = α(λ)ᵀy is monotone
        # non-increasing in λ → bisection
        c_max = jnp.max(c_vec)
        span = jnp.max(jnp.abs(a)) + c_max + 1.0

        def g(lam):
            return jnp.dot(jnp.clip(a - lam * y, 0.0, c_vec), y)

        def bisect(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            pos = g(mid) > 0.0
            return (jnp.where(pos, mid, lo), jnp.where(pos, hi, mid)), None

        (lo, hi), _ = jax.lax.scan(bisect, (-span, span), None, length=50)
        lam = 0.5 * (lo + hi)
        return jnp.clip(a - lam * y, 0.0, c_vec)

    def step(carry, _):
        # FISTA-accelerated projected gradient on the (concave) dual
        alpha, alpha_prev, t = carry
        mom = alpha + ((t - 1.0) / (t + 2.0)) * (alpha - alpha_prev)
        grad = 1.0 - q @ mom
        new = project(mom + lr * grad)
        return (new, alpha, t + 1.0), None

    alpha0 = jnp.zeros_like(y)
    (alpha, _, _), _ = jax.lax.scan(step, (alpha0, alpha0, jnp.float32(1.0)),
                                    None, length=n_iter)
    return project(alpha)


def svm_train(x: np.ndarray, y: np.ndarray, c: float | None = None,
              target_penalty: float | None = None, kind: str = "linear",
              degree: int = 1, gamma: float = 0.0, coef0: float = 0.0,
              n_iter: int = 500) -> SvmModel:
    """Train a C-SVC (reference Svm.cpp svm_train call site cpp:339).

    y ∈ {+1,−1}; ``target_penalty`` multiplies C for the +1 class
    (reference targetPenalty for unbalanced 1-vs-cohort data)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if c is None:
        c = default_c(x)
    c_vec = np.full(y.shape, c, np.float32)
    if target_penalty is not None:
        c_vec[y > 0] *= target_penalty
    xj = jnp.asarray(x)
    k = kernel_matrix(xj, xj, kind, degree, gamma, coef0)
    alpha = np.asarray(_dual_solve(k, jnp.asarray(y), jnp.asarray(c_vec),
                                   n_iter=n_iter))
    # bias from margin support vectors (0 < α < C)
    dec0 = np.asarray(k) @ (alpha * y)
    on_margin = (alpha > 1e-6 * c) & (alpha < c_vec * (1 - 1e-6))
    if on_margin.any():
        bias = float(np.mean(y[on_margin] - dec0[on_margin]))
    else:
        bias = float(np.mean(y - dec0))
    keep = alpha > 1e-8
    return SvmModel(support=x[keep], alpha_y=(alpha * y)[keep], bias=bias,
                    kind=kind, degree=degree, gamma=gamma, coef0=coef0)
