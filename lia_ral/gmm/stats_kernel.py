"""Fused GMM sufficient statistics on NVIDIA Hopper (Pallas, Triton route).

One kernel pair serves both statistics of the pipeline:

* TrainWorld's EM statistics (reference ``AccumulateStat.cpp:103-152``):
  one frame axis, cut into segments whose partial sums are added here;
* the Baum-Welch (N, F) statistics of TotalVariability, IvExtractor and
  ComputeJFAStats (``AccumulateTVStat.cpp:281-351``): one segment per
  utterance.

The plain XLA path writes the (frames, K) posterior block to device
memory and reads it back for the softmax and for γᵀ@x.  Here it never
leaves the chip.  With the augmented design ``xa = [x², x, 0]`` (width
A, padded to a power of two) and ``B = [−½Σ⁻¹; μΣ⁻¹; 0]·log2(e)``, the
base-2 logits are ``xa @ B + cst``, and

* pass 1 (grid over frame blocks) walks the K tiles with an online max
  and sum and writes each frame's base-2 log-normaliser;
* pass 2 (grid over K tiles × segments) recomputes each (BN, BK) logit
  tile, forms ``p = 2^(ld − lse)·w`` and accumulates ``pᵀ @ xa`` and
  ``Σ p`` in registers over the segment's frames.

Blocks run in parallel in no order, so every block owns its output tile
and nothing is carried between blocks; the segment partial sums are
added by XLA afterwards, which keeps results the same from run to run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .model import GmmDiag

_LOG2_E = 1.4426950408889634
_LN_2 = 0.6931471805599453
_BN = 64            # frames per tile
_BK = 64            # components per tile
_NUM_WARPS = 4
_NUM_STAGES = 1
_EM_SEGMENTS = 32   # frame segments of an EM pass (× K tiles = blocks)
_PAD_LOGIT = -1e30  # logit of a padding component: its posterior is 0

# f32-grade products on the tensor cores: operands split in three bf16
# passes (hi·hi + hi·lo + lo·hi)
_X3 = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def _dot(a, b, fast: bool):
    """(M, C) @ (C, N) in f32: one bf16 pass if ``fast``, else x3."""
    if fast:
        return jax.lax.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
    return jax.lax.dot(a, b, precision=_X3,
                       preferred_element_type=jnp.float32)


def _dot_t(a, b, fast: bool):
    """(C, M)ᵀ @ (C, N) in f32: one bf16 pass if ``fast``, else x3."""
    dims = (((0,), (0,)), ((), ()))
    if fast:
        return jax.lax.dot_general(a.astype(jnp.bfloat16),
                                   b.astype(jnp.bfloat16), dims,
                                   preferred_element_type=jnp.float32)
    return jax.lax.dot_general(a, b, dims, precision=_X3,
                               preferred_element_type=jnp.float32)


def _lse_kernel(xa_ref, b_ref, cst_ref, lse_ref, *, bk, n_k, fast_math):
    xa = xa_ref[...]                                   # (BN, A)
    bn = xa.shape[0]

    def body(j, carry):
        m, s = carry
        cols = pl.ds(j * bk, bk)
        ld = _dot(xa, b_ref[:, cols], fast_math) + cst_ref[cols][None, :]
        m_new = jnp.maximum(m, jnp.max(ld, axis=1))
        s = (s * jnp.exp2(m - m_new)
             + jnp.sum(jnp.exp2(ld - m_new[:, None]), axis=1))
        return m_new, s

    m, s = jax.lax.fori_loop(
        0, n_k, body, (jnp.full((bn,), -jnp.inf, jnp.float32),
                       jnp.zeros((bn,), jnp.float32)))
    lse_ref[...] = m + jnp.log2(s)


def _stats_kernel(xa_ref, w_ref, lse_ref, b_ref, cst_ref, acc_ref, n_ref,
                  *, n_t, fast_math, fast_stats):
    b = b_ref[...]                                     # (A, BK)
    cst = cst_ref[...]                                 # (BK,)

    def body(i, carry):
        acc, n = carry
        rows = pl.ds(i * _BN, _BN)
        xa = xa_ref[rows, :]                           # (BN, A)
        ld = _dot(xa, b, fast_math) + cst[None, :]     # (BN, BK)
        p = jnp.exp2(ld - lse_ref[rows][:, None]) * w_ref[rows][:, None]
        return acc + _dot_t(p, xa, fast_stats), n + jnp.sum(p, axis=0)

    acc, n = jax.lax.fori_loop(
        0, n_t, body, (jnp.zeros(acc_ref.shape, jnp.float32),
                       jnp.zeros(n_ref.shape, jnp.float32)))
    acc_ref[...] = acc
    n_ref[...] = n


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


@functools.partial(jax.jit, static_argnames=("fast_math", "fast_stats",
                                             "interpret"))
def segment_stats(x: jax.Array, w: jax.Array, gmm: GmmDiag,
                  fast_math: bool = False, fast_stats: bool = False,
                  interpret: bool = False):
    """Per-segment GMM statistics of padded frame blocks.

    x: (S, T, D) frames; w: (S, T) frame weights (0 = padding).
    Returns ``(n (S, K), sum_x (S, K, D), sum_xx (S, K, D), llk (S,))``
    with ``llk`` the weighted frame log-likelihood sum of each segment.

    ``fast_math`` runs the density product in one bf16 pass (the
    ``fastMath`` tier); ``fast_stats`` runs the first- and second-order
    contraction in one bf16 pass (the ``fastStats`` tier).  Occupancies
    are always summed in f32.  ``interpret`` runs the kernels on the
    host; it exists for the CPU tests.
    """
    s, t, d = x.shape
    k = gmm.n_components
    a = max(_next_pow2(2 * d), 16)
    bk = min(_BK, max(_next_pow2(k), 16))
    k_pad = -(-k // bk) * bk
    t_pad = -(-t // _BN) * _BN
    x = jnp.pad(x.astype(jnp.float32), ((0, 0), (0, t_pad - t), (0, 0)))
    w = jnp.pad(w.astype(jnp.float32), ((0, 0), (0, t_pad - t)))
    xa = jnp.concatenate(
        [x * x, x, jnp.zeros((s, t_pad, a - 2 * d), jnp.float32)], axis=2)

    mi = gmm.means * gmm.cov_inv
    b = jnp.concatenate([-0.5 * gmm.cov_inv.T, mi.T,
                         jnp.zeros((a - 2 * d, k), jnp.float32)], axis=0)
    cst = (gmm.log_const() - 0.5 * jnp.sum(gmm.means * mi, axis=-1)
           + gmm.log_weights())
    b = jnp.pad(b * _LOG2_E, ((0, 0), (0, k_pad - k)))
    cst = jnp.pad(cst * _LOG2_E, (0, k_pad - k), constant_values=_PAD_LOGIT)

    params = plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                  num_stages=_NUM_STAGES)
    n_frames = s * t_pad
    lse = pl.pallas_call(
        functools.partial(_lse_kernel, bk=bk, n_k=k_pad // bk,
                          fast_math=fast_math),
        grid=(n_frames // _BN,),
        in_specs=[pl.BlockSpec((_BN, a), lambda i: (i, 0)),
                  pl.BlockSpec((a, k_pad), lambda i: (0, 0)),
                  pl.BlockSpec((k_pad,), lambda i: (0,))],
        out_specs=pl.BlockSpec((_BN,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n_frames,), jnp.float32),
        backend="triton", compiler_params=params, interpret=interpret,
        name="gmm_lse",
    )(xa.reshape(n_frames, a), b, cst).reshape(s, t_pad)

    acc, n = pl.pallas_call(
        functools.partial(_stats_kernel, n_t=t_pad // _BN,
                          fast_math=fast_math, fast_stats=fast_stats),
        grid=(k_pad // bk, s),
        in_specs=[pl.BlockSpec((None, t_pad, a), lambda j, i: (i, 0, 0)),
                  pl.BlockSpec((None, t_pad), lambda j, i: (i, 0)),
                  pl.BlockSpec((None, t_pad), lambda j, i: (i, 0)),
                  pl.BlockSpec((a, bk), lambda j, i: (0, j)),
                  pl.BlockSpec((bk,), lambda j, i: (j,))],
        out_specs=[pl.BlockSpec((None, bk, a), lambda j, i: (i, j, 0)),
                   pl.BlockSpec((None, bk), lambda j, i: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((s, k_pad, a), jnp.float32),
                   jax.ShapeDtypeStruct((s, k_pad), jnp.float32)],
        backend="triton", compiler_params=params, interpret=interpret,
        name="gmm_stats",
    )(xa, w, lse, b, cst)

    llk = _LN_2 * jnp.sum(lse * w, axis=1)
    return n[:, :k], acc[:, :k, d:2 * d], acc[:, :k, :d], llk


def em_segments(n_frames: int) -> tuple[int, int]:
    """(segments, frames per segment) for an EM pass over ``n_frames``:
    enough segments that K tiles × segments fill the card, each a whole
    number of frame tiles."""
    n_seg = max(1, min(_EM_SEGMENTS, -(-n_frames // _BN)))
    per = -(-n_frames // n_seg)
    return n_seg, -(-per // _BN) * _BN
