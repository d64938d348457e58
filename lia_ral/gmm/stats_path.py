"""The one place that decides how GMM statistics are computed.

Every statistics call of the pipeline (TrainWorld's EM statistics, the
Baum-Welch statistics of TotalVariability, IvExtractor and
ComputeJFAStats, and their mesh-sharded forms) goes through ``em_stats``
or ``bw_stats`` here.  On a GPU they run the fused kernel of
``stats_kernel``; on any other backend, XLA's plain path of
``gmm.kernels``.  Neither falls back to the other, and the kernel never
runs in interpret mode outside the tests.

Two independent precision flags reach both paths:

* ``fast_math``  the density product in one bf16 pass (config key
                 ``fastMath``, the analogue of the reference's
                 -ffast-math build, configure.ac:21); read by TrainWorld's
                 EM statistics only;
* ``fast_stats`` the first- and second-order sums in one bf16 pass, with
                 f32-grade densities and occupancies (config key
                 ``fastStats``); read by the EM and Baum-Welch statistics.

Both off is the f32-grade default; both on is allowed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .kernels import EmStats, accumulate_bw_stats, em_stats_chunked
from .model import GmmDiag


def use_kernel() -> bool:
    """True where the fused kernel serves the statistics: a GPU."""
    return jax.default_backend() == "gpu"


def em_stats(x: jax.Array, w: jax.Array, gmm: GmmDiag,
             fast_math: bool = False, fast_stats: bool = False,
             chunk: int = 4096) -> EmStats:
    """EM sufficient statistics of frames x (N, D) with weights w (N,)."""
    if not use_kernel():
        return em_stats_chunked(x, w, gmm, chunk=chunk, fast_math=fast_math,
                                fast_stats=fast_stats)
    from .stats_kernel import em_segments, segment_stats

    n, d = x.shape
    n_seg, per = em_segments(n)
    pad = n_seg * per - n
    xs = jnp.pad(x, ((0, pad), (0, 0))).reshape(n_seg, per, d)
    ws = jnp.pad(w, (0, pad)).reshape(n_seg, per)
    occ, sum_x, sum_xx, llk = segment_stats(
        xs, ws, gmm, fast_math=fast_math, fast_stats=fast_stats)
    return EmStats(n=occ.sum(0), sum_x=sum_x.sum(0), sum_xx=sum_xx.sum(0),
                   llk=llk.sum(), count=jnp.sum(w))


def bw_stats(x: jax.Array, mask: jax.Array, gmm: GmmDiag,
             fast_stats: bool = False) -> tuple[jax.Array, jax.Array]:
    """Baum-Welch (n (S, K), f (S, K, D)) of a padded utterance batch
    x (S, T, D) with frame weights mask (S, T)."""
    if not use_kernel():
        return jax.vmap(lambda xs, ws: accumulate_bw_stats(
            xs, ws, gmm, fast_stats=fast_stats))(x, mask)
    from .stats_kernel import segment_stats

    occ, sum_x, _, _ = segment_stats(x, mask, gmm, fast_stats=fast_stats)
    return occ, sum_x
