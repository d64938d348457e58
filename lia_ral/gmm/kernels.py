"""Diagonal-GMM kernels in plain XLA: log-densities, posteriors, EM stats.

Array re-expression of the reference hot loops (SURVEY.md §3.1/§3.3):
the per-frame × per-component Gaussian log-likelihood that ALIZE
MixtureGDStat computes scalar-by-scalar becomes two matrix products via
the quadratic expansion

    −½ Σ_d (x_d−μ_kd)²·ivar_kd
        = −½·(x² @ ivarᵀ) + x @ (μ·ivar)ᵀ − ½·Σ_d μ²·ivar ,

and the EM sufficient-statistics accumulation (reference
``AccumulateStat.cpp:103-152`` frame loop + per-thread ``addAccEM`` merge)
becomes γᵀ@X / γᵀ@X² matmuls with a pytree-sum merge — which is literally a
``psum`` when sharded (SURVEY.md §2.6).

All functions take an explicit per-frame weight vector.  Weights encode
padding (0), label selection masks, and bagged-frame subsampling — ragged
segment structure never reaches device code as dynamic shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..pytree import dataclass as pytree_dataclass
from .model import GmmDiag


@pytree_dataclass
class EmStats:
    """Zero/first/second-order sufficient statistics.

    Equivalent of ALIZE MixtureGDStat EM accumulators (occupancy, Σγx,
    Σγx²) plus the LLK monitor.  ``merge``/tree-sum is associative — the
    sharded psum and the reference's threaded ``addAccEM`` merge are the
    same operation.
    """

    n: jax.Array          # (K,)   Σ_t γ_tk·w_t
    sum_x: jax.Array      # (K,D)  Σ_t γ_tk·w_t·x_t
    sum_xx: jax.Array     # (K,D)  Σ_t γ_tk·w_t·x_t²
    llk: jax.Array        # ()     Σ_t w_t·log p(x_t)
    count: jax.Array      # ()     Σ_t w_t

    @classmethod
    def zeros(cls, k: int, d: int, dtype=jnp.float32) -> "EmStats":
        return cls(
            n=jnp.zeros((k,), dtype),
            sum_x=jnp.zeros((k, d), dtype),
            sum_xx=jnp.zeros((k, d), dtype),
            llk=jnp.zeros((), dtype),
            count=jnp.zeros((), dtype),
        )

    def merge(self, other: "EmStats") -> "EmStats":
        return jax.tree.map(jnp.add, self, other)

    def mean_llk(self) -> jax.Array:
        """Reference getMeanLLK: average frame log-likelihood."""
        return self.llk / jnp.maximum(self.count, 1e-30)


def _dot(a: jax.Array, b: jax.Array, bf16: bool = False) -> jax.Array:
    """f32 product; ``bf16`` rounds both operands to one bf16 pass."""
    if bf16:
        a, b = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


def component_logdens(x: jax.Array, gmm: GmmDiag,
                      fast_math: bool = False) -> jax.Array:
    """Per-frame per-component Gaussian log-density (N,K).

    The logits need f32-grade products: one bf16 pass rounds them by
    ~5e-2 and moves softmax occupancies by percents against the
    reference's f64 math.  ``fast_math`` asks for exactly that single
    bf16 pass (the ``fastMath`` tier); the constant row stays f32."""
    mi = gmm.means * gmm.cov_inv                       # (K,D)
    cst = (gmm.log_const()
           - 0.5 * jnp.sum(gmm.means * mi, axis=-1))   # (K,)
    quad = _dot(x * x, gmm.cov_inv.T, fast_math)       # (N,K)
    cross = _dot(x, mi.T, fast_math)
    return -0.5 * quad + cross + cst[None, :]


def weighted_logdens(x: jax.Array, gmm: GmmDiag,
                     fast_math: bool = False) -> jax.Array:
    """log(w_k · N_k(x)) — (N,K)."""
    return (component_logdens(x, gmm, fast_math)
            + gmm.log_weights()[None, :])


def frame_llk(
    x: jax.Array,
    gmm: GmmDiag,
    min_llk: float | None = None,
    max_llk: float | None = None,
) -> jax.Array:
    """Per-frame GMM log-likelihood (N,), optionally clamped to the
    reference's [minLLK, maxLLK] bounds (config keys minLLK/maxLLK)."""
    llk = jax.nn.logsumexp(weighted_logdens(x, gmm), axis=-1)
    if min_llk is not None:
        llk = jnp.maximum(llk, min_llk)
    if max_llk is not None:
        llk = jnp.minimum(llk, max_llk)
    return llk


def llk_and_posteriors(x: jax.Array, gmm: GmmDiag, fast_math: bool = False
                       ) -> tuple[jax.Array, jax.Array]:
    """(llk (N,), posteriors γ (N,K)) in one pass."""
    lw = weighted_logdens(x, gmm, fast_math)
    llk = jax.nn.logsumexp(lw, axis=-1)
    post = jnp.exp(lw - llk[:, None])
    return llk, post


def em_stats(x: jax.Array, w: jax.Array, gmm: GmmDiag,
             fast_math: bool = False, fast_stats: bool = False) -> EmStats:
    """Sufficient statistics for one frame block.

    x: (N,D) frames; w: (N,) per-frame weights (0 = padding/unselected).
    The precision flags of gmm.stats_path: ``fast_math`` rounds the
    density product to one bf16 pass, ``fast_stats`` the first- and
    second-order sums; occupancies are always summed in f32.
    """
    llk, post = llk_and_posteriors(x, gmm, fast_math)
    pw = post * w[:, None]                              # (N,K)
    return EmStats(
        n=jnp.sum(pw, axis=0),
        sum_x=_dot(pw.T, x, fast_stats),
        sum_xx=_dot(pw.T, x * x, fast_stats),
        llk=jnp.sum(llk * w),
        count=jnp.sum(w),
    )


def accumulate_bw_stats(x: jax.Array, w: jax.Array, gmm: GmmDiag,
                        fast_stats: bool = False
                        ) -> tuple[jax.Array, jax.Array]:
    """Baum-Welch stats of ONE utterance: x (T,D), w (T,) →
    (n (K,), f (K,D)); ``fast_stats`` as in ``em_stats``."""
    _, post = llk_and_posteriors(x, gmm)
    pw = post * w[:, None]
    return jnp.sum(pw, axis=0), _dot(pw.T, x, fast_stats)


@functools.partial(jax.jit,
                   static_argnames=("chunk", "fast_math", "fast_stats"))
def em_stats_chunked(x: jax.Array, w: jax.Array, gmm: GmmDiag,
                     chunk: int = 4096, fast_math: bool = False,
                     fast_stats: bool = False) -> EmStats:
    """Memory-bounded stats over a long frame axis via lax.scan.

    Bounds the live posterior block at (chunk, K) instead of
    materialising the full (N, K) γ matrix in device memory.  N must not be huge relative to HBM
    for x itself; callers stream corpora in epochs (see gmm.em).
    N is padded up to a chunk multiple with zero weights.
    """
    n, d = x.shape
    k = gmm.n_components
    pad = (-n) % chunk
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, d), x.dtype)], axis=0)
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)], axis=0)
    xc = x.reshape(-1, chunk, d)
    wc = w.reshape(-1, chunk)

    def body(acc: EmStats, blk):
        xb, wb = blk
        return acc.merge(em_stats(xb, wb, gmm, fast_math, fast_stats)), None

    # Derive the zero carry from the inputs so its type matches under
    # shard_map (a plain zeros init is device-invariant while the scan
    # output varies over the manual mesh axis).
    varying_zero = jnp.sum(w[:1]) * 0.0
    init = jax.tree.map(lambda z: z + varying_zero.astype(z.dtype),
                        EmStats.zeros(k, d, x.dtype))
    acc, _ = jax.lax.scan(body, init, (xc, wc))
    return acc
