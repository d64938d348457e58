"""Baum-Welch sufficient statistics (N, F) per utterance/speaker.

JAX equivalent of reference ``computeAndAccumulateTVStat``
(AccumulateTVStat.cpp:281-351 — hot loop 332-349: occupancy posteriors ×
frames into _statN/_statF) and the ComputeJFAStats precompute tool
(SURVEY.md §2.2).  Utterances are processed as padded (S, T, D) batches
with (S, T) masks; the stats of each utterance are two matmul reductions.

Checkpointing (saveAccs parity, AccumulateTVStat.cpp:1614): stats are
saved as .npz pytrees plus ALIZE-format .matx matrices for interop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..pytree import dataclass as pytree_dataclass
from ..gmm.model import GmmDiag
from ..gmm.stats_path import bw_stats
from ..utils.shapes import bucket_len, next_pow2


@pytree_dataclass
class BwStats:
    """Zero- and first-order Baum-Welch stats per utterance.

    n: (S, K) occupancy; f: (S, K, D) first-order sums (raw — centering by
    the UBM mean happens in the consumer, matching the reference where
    substractM mutates _statF after load).
    """

    n: jax.Array
    f: jax.Array

    @property
    def n_utts(self) -> int:
        return self.n.shape[0]

    def merge(self, other: "BwStats") -> "BwStats":
        """Concatenate along the utterance axis."""
        return BwStats(n=jnp.concatenate([self.n, other.n]),
                       f=jnp.concatenate([self.f, other.f]))

    def centered(self, ubm_means: jax.Array) -> jax.Array:
        """F̄ = F − N·m (reference substractM, AccumulateTVStat.cpp:1078)."""
        return self.f - self.n[..., None] * ubm_means[None, :, :]

    def normalized(self, ubm_means: jax.Array, ubm_inv_var: jax.Array
                   ) -> jax.Array:
        """F̄·sqrt(Σ⁻¹) (reference normStatistics, cpp:1215)."""
        return self.centered(ubm_means) * jnp.sqrt(ubm_inv_var)[None, :, :]


def bw_stats_batch(x: jax.Array, mask: jax.Array, gmm: GmmDiag,
                   fast_stats: bool = False) -> BwStats:
    """Stats of a padded utterance batch: x (S,T,D), mask (S,T), through
    gmm.stats_path (``fast_stats``: config key ``fastStats``)."""
    n, f = bw_stats(x, mask, gmm, fast_stats)
    return BwStats(n=n, f=f)


def bw_stats_bucketed(entries, gmm: GmmDiag, bucket: int = 2048,
                      batch_size: int = 64,
                      fast_stats: bool = False) -> BwStats:
    """Stats of ragged utterances via length-bucketed padded batches.

    entries: list of (x (T_i,D) ndarray, mask (T_i,) ndarray).  Each
    utterance is padded to a multiple of ``bucket`` frames and grouped
    with same-padded-length peers into (batch, T, D) bw_stats_batch
    dispatches — one compiled executable per bucket shape and one device
    round-trip per batch instead of one per utterance (the device shape
    of the reference's static per-thread file-list split,
    AccumulateTVStat.cpp:478-551).  Row order == input order.
    """
    if not entries:
        # reachable when every session of an NDX failed to load (the
        # tools warn-and-skip unreadable sessions) — fail with a clear
        # message instead of an opaque stack-on-empty error
        raise ValueError("bw_stats_bucketed: no readable sessions "
                         "(every utterance of the list failed to load)")
    k, d = gmm.means.shape
    rows_n: list = [None] * len(entries)
    rows_f: list = [None] * len(entries)
    by_len: dict[int, list[int]] = {}
    for i, (x, _) in enumerate(entries):
        plen = bucket_len(x.shape[0], bucket)
        by_len.setdefault(plen, []).append(i)
    for plen, idxs in by_len.items():
        for s0 in range(0, len(idxs), batch_size):
            grp = idxs[s0:s0 + batch_size]
            # pad the batch axis to the next power of two (zero-weight
            # utterances) so ragged tail batches reuse compiled shapes
            b_pad = next_pow2(len(grp))
            xs = np.zeros((b_pad, plen, d), np.float32)
            ms = np.zeros((b_pad, plen), np.float32)
            for j, i in enumerate(grp):
                x, m = entries[i]
                xs[j, :x.shape[0]] = x
                ms[j, :m.shape[0]] = m
            st = bw_stats_batch(jnp.asarray(xs), jnp.asarray(ms), gmm,
                                fast_stats=fast_stats)
            for j, i in enumerate(grp):
                rows_n[i] = st.n[j]
                rows_f[i] = st.f[j]
    return BwStats(n=jnp.stack(rows_n), f=jnp.stack(rows_f))


def save_stats(path: str, stats: BwStats, names: list[str] | None = None
               ) -> None:
    np.savez(path,
             n=np.asarray(stats.n), f=np.asarray(stats.f),
             names=np.asarray(names if names is not None else [], dtype=object))


def load_stats(path: str) -> tuple[BwStats, list[str]]:
    z = np.load(path, allow_pickle=True)
    return (BwStats(n=jnp.asarray(z["n"]), f=jnp.asarray(z["f"])),
            list(z["names"]))


def save_stats_matx(prefix: str, stats: BwStats, fmt: str = "DB") -> None:
    """ALIZE-interop checkpoint: <prefix>_N.matx (S,K) and <prefix>_F_X.matx
    (S, K·D) — the reference's saveAccs layout."""
    from ..io.matrix import write_matrix_file
    s, k, d = stats.f.shape
    write_matrix_file(prefix + "_N.matx", np.asarray(stats.n, np.float64), fmt)
    write_matrix_file(prefix + "_F_X.matx",
                      np.asarray(stats.f, np.float64).reshape(s, k * d), fmt)


def load_stats_matx(prefix: str, vect_size: int) -> BwStats:
    from ..io.matrix import read_matrix_file
    n = read_matrix_file(prefix + "_N.matx")
    f = read_matrix_file(prefix + "_F_X.matx")
    s, k = n.shape
    return BwStats(n=jnp.asarray(n, jnp.float32),
                   f=jnp.asarray(f.reshape(s, k, vect_size), jnp.float32))
