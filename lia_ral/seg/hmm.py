"""HMM container + Viterbi decoding for diarization.

JAX equivalent of reference ``LIA_SpkTools/Hmm`` (include/Hmm.h:
74-121: states = GMMs + transition matrix) and the ALIZE ViterbiAccum
consumed by ``viterbiDecoding`` (Tools.cpp:1021).  The frame-sequential
Viterbi recursion — the reference's only order-dependent compute besides
window CMVN (SURVEY.md §5) — is a ``lax.scan`` in the log domain with the
emission matrix computed as one batched GMM pass beforehand.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag
from ..gmm.scoring import stack_gmms


@dataclasses.dataclass
class DiarHmm:
    """States (stacked GMM pytree with leading state axis) + names +
    log-transition matrix."""

    gmms: GmmDiag          # leading axis = state
    names: list[str]
    log_trans: jax.Array   # (S, S)

    @property
    def n_states(self) -> int:
        return len(self.names)

    @classmethod
    def from_gmms(cls, gmms: list[GmmDiag], names: list[str],
                  trans: np.ndarray | None = None) -> "DiarHmm":
        s = len(gmms)
        if trans is None:
            trans = compute_transitions(s)
        return cls(stack_gmms(gmms), list(names),
                   jnp.log(jnp.asarray(trans, jnp.float32) + 1e-30))

    def replace_state(self, idx: int, gmm: GmmDiag) -> "DiarHmm":
        new = jax.tree.map(
            lambda stacked, leaf: stacked.at[idx].set(leaf),
            self.gmms, gmm)
        return dataclasses.replace(self, gmms=new)


def compute_transitions(n_states: int, gamma: float = 0.8) -> np.ndarray:
    """Reference computeTransitions (Tools.h:110): strong self-loop
    probability gamma, remainder spread over other states."""
    if n_states == 1:
        return np.ones((1, 1))
    off = (1.0 - gamma) / (n_states - 1)
    t = np.full((n_states, n_states), off)
    np.fill_diagonal(t, gamma)
    return t


def emission_llk(x: jax.Array, hmm: DiarHmm) -> jax.Array:
    """Per-frame per-state GMM log-likelihood (N, S)."""
    def one(g):
        return jax.nn.logsumexp(weighted_logdens(x, g), axis=-1)
    return jax.vmap(one, out_axes=1)(hmm.gmms)


@jax.jit
def _viterbi(emissions: jax.Array, log_trans: jax.Array) -> jax.Array:
    """Log-domain Viterbi over (N, S) emissions → state path (N,)."""
    n, s = emissions.shape

    def step(delta, em_t):
        # delta: (S,) best log-prob ending in each state
        cand = delta[:, None] + log_trans            # (S_prev, S)
        best_prev = jnp.argmax(cand, axis=0)         # (S,)
        delta_t = jnp.max(cand, axis=0) + em_t
        return delta_t, best_prev

    delta0 = emissions[0] - jnp.log(s * 1.0)
    delta_final, back = jax.lax.scan(step, delta0, emissions[1:])
    last = jnp.argmax(delta_final)

    def backstep(state, bp_t):
        prev = bp_t[state]
        return prev, state

    _, path_rev = jax.lax.scan(backstep, last, back, reverse=True)
    return jnp.concatenate([path_rev, last[None]])


def viterbi_decode(x: jax.Array, hmm: DiarHmm,
                   mask: jax.Array | None = None) -> np.ndarray:
    """Most likely state per frame (reference viterbiDecoding,
    Tools.cpp:1021).  Masked-out frames keep the previous state by giving
    them uniform emissions."""
    em = emission_llk(x, hmm)
    if mask is not None:
        em = jnp.where(mask[:, None] > 0, em, 0.0)
    return np.asarray(_viterbi(em, hmm.log_trans))


def path_to_segments(path: np.ndarray, names: list[str],
                     frame_length: float = 0.01,
                     min_duration: int = 0) -> list:
    """State path → labelled segments; runs shorter than min_duration
    frames are merged into the previous run (reference minimum-duration
    rules, AcousticSegmentation.cpp:55-68)."""
    from ..io.labels import Segment
    if path.size == 0:
        return []
    segs: list[Segment] = []
    start = 0
    cur = path[0]
    runs = []
    for i in range(1, len(path)):
        if path[i] != cur:
            runs.append([start, i, cur])
            start, cur = i, path[i]
    runs.append([start, len(path), cur])
    if min_duration > 0:
        merged = []
        for r in runs:
            if merged and (r[1] - r[0]) < min_duration:
                merged[-1][1] = r[1]    # absorb the short run
            else:
                merged.append(r)
        # collapse adjacent same-state runs
        runs = []
        for r in merged:
            if runs and runs[-1][2] == r[2] and runs[-1][1] == r[0]:
                runs[-1][1] = r[1]
            else:
                runs.append(r)
    for a, b, st in runs:
        segs.append(Segment(a * frame_length, b * frame_length,
                            names[int(st)]))
    return segs
