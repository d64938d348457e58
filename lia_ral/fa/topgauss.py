"""Top-N Gaussian selection cache.

JAX equivalent of reference ``LIA_SpkTools/TopGauss``
(TopGauss.h:74-110): per-frame top component indices plus the residual
weight/likelihood of the non-top components, cached to disk and reused to
speed up repeated LLK evaluations (LFA/JFA scoring).  Here the
computation is one ``lax.top_k`` over the batched log-density matrix; the
cache keeps score parity across tools rather than saving compute.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag


@dataclasses.dataclass
class TopGauss:
    """Per-frame top-N indices + residual mass (reference fields: index
    list, residual weight ``_w``, residual likelihood ``_lk``)."""

    indices: np.ndarray        # (N, top) int32
    top_lse: np.ndarray        # (N,) logsumexp of the top terms
    residual_log: np.ndarray   # (N,) log of the non-top weighted mass
    residual_weight: np.ndarray  # (N,) sum of non-top component weights

    @property
    def n_frames(self) -> int:
        return self.indices.shape[0]

    def frame_llk(self) -> np.ndarray:
        """Full-frame llk reconstructed from top + residual."""
        return np.logaddexp(self.top_lse, self.residual_log)

    # -- binary cache (reference read/write, TopGauss.cpp:76-110) ------------
    def save(self, path: str) -> None:
        np.savez(path, indices=self.indices, top_lse=self.top_lse,
                 residual_log=self.residual_log,
                 residual_weight=self.residual_weight)

    @classmethod
    def load(cls, path: str) -> "TopGauss":
        z = np.load(path)
        return cls(z["indices"], z["top_lse"], z["residual_log"],
                   z["residual_weight"])

    # -- reference wire format (TopGauss.cpp:76-110) --------------------------
    # Layout: [nt:u8][nbgcnt:u8] [nbg:u8 x nt] [idx:u8 x nbgcnt]
    #         [snsw:f8 x nt] [snsl:f8 x nt]  (little-endian, 64-bit ulong).
    # The reference supports a variable top count per frame; this framework
    # computes a fixed top-N (static shapes for the device) but reads ragged
    # files back into the padded representation.
    def save_reference(self, path: str) -> None:
        nt = self.n_frames
        top = self.indices.shape[1]
        with open(path, "wb") as f:
            np.asarray([nt, nt * top], "<u8").tofile(f)
            np.full(nt, top, "<u8").tofile(f)
            self.indices.astype("<u8").tofile(f)
            self.residual_weight.astype("<f8").tofile(f)
            np.exp(self.residual_log).astype("<f8").tofile(f)

    @classmethod
    def load_reference(cls, path: str) -> "TopGauss":
        with open(path, "rb") as f:
            raw = f.read()
        nt, nbgcnt = np.frombuffer(raw, "<u8", count=2)
        off = 16
        nbg = np.frombuffer(raw, "<u8", count=int(nt), offset=off)
        off += 8 * int(nt)
        idx = np.frombuffer(raw, "<u8", count=int(nbgcnt), offset=off)
        off += 8 * int(nbgcnt)
        snsw = np.frombuffer(raw, "<f8", count=int(nt), offset=off)
        off += 8 * int(nt)
        snsl = np.frombuffer(raw, "<f8", count=int(nt), offset=off)
        top = int(nbg.max()) if nt else 0
        indices = np.zeros((int(nt), top), np.int32)
        pos = 0
        for t in range(int(nt)):
            k = int(nbg[t])
            row = idx[pos:pos + k].astype(np.int32)
            pos += k
            indices[t, :k] = row
            if k < top:                      # pad ragged rows with repeats
                indices[t, k:] = row[-1] if k else 0
        with np.errstate(divide="ignore"):
            residual_log = np.log(np.maximum(snsl, 1e-300))
        return cls(indices=indices, top_lse=np.zeros(int(nt)),
                   residual_log=residual_log,
                   residual_weight=np.asarray(snsw))


def write_fileinfo(path: str, indices: np.ndarray,
                   sum_non_top_lk: np.ndarray,
                   sum_non_top_weight: np.ndarray) -> None:
    """Reference FileInfo::writeTopInfo side files (FileInfo.cpp:110-131):
    per frame, ``top`` uint64 component indices followed by the non-top
    likelihood sum and the non-top weight sum as doubles."""
    n, top = indices.shape
    rec = np.empty((n, top + 2), "<u8")
    rec[:, :top] = indices.astype("<u8")
    rec[:, top] = np.asarray(sum_non_top_lk, "<f8").view("<u8")
    rec[:, top + 1] = np.asarray(sum_non_top_weight, "<f8").view("<u8")
    rec.tofile(path)


def read_fileinfo(path: str, top: int, frame: int | None = None):
    """Reference FileInfo::loadTopInfo (FileInfo.cpp:155-187): seek to the
    ``frame``-th record and return (indices, sumNonTopLK, sumNonTopWeight);
    with ``frame=None`` return all records."""
    rec_bytes = top * 8 + 16
    with open(path, "rb") as f:
        raw = f.read()
    n = len(raw) // rec_bytes
    frames = range(n) if frame is None else [frame]
    idx_out, lk_out, w_out = [], [], []
    for t in frames:
        off = t * rec_bytes
        idx_out.append(np.frombuffer(raw, "<u8", count=top,
                                     offset=off).astype(np.int64))
        lk, w = np.frombuffer(raw, "<f8", count=2, offset=off + top * 8)
        lk_out.append(lk)
        w_out.append(w)
    if frame is not None:
        return idx_out[0], lk_out[0], w_out[0]
    return (np.stack(idx_out), np.asarray(lk_out), np.asarray(w_out))


def compute_topgauss(x: jax.Array, gmm: GmmDiag, top: int = 10) -> TopGauss:
    """Reference TopGauss::compute (cpp:113+): evaluate the world on every
    frame, keep the top components and the exact residual mass."""
    ld = weighted_logdens(x, gmm)                    # (N,K)
    full = jax.nn.logsumexp(ld, axis=-1)
    vals, idx = jax.lax.top_k(ld, top)
    top_lse = jax.nn.logsumexp(vals, axis=-1)
    diff = jnp.clip(top_lse - full, max=-1e-7)
    residual = full + jnp.log1p(-jnp.exp(diff))
    w_top = jnp.sum(gmm.weights[idx], axis=-1)
    return TopGauss(
        indices=np.asarray(idx, np.int32),
        top_lse=np.asarray(top_lse),
        residual_log=np.asarray(residual),
        residual_weight=np.asarray(1.0 - w_top),
    )


def topgauss_llk(x: jax.Array, gmm: GmmDiag, tg: TopGauss) -> jax.Array:
    """LLK of any model using a cached top set + the cached residual
    (reference TopGauss::get usage in LFA/JFA scoring)."""
    ld = weighted_logdens(x, gmm)
    sel = jnp.take_along_axis(ld, jnp.asarray(tg.indices), axis=-1)
    stacked = jnp.concatenate(
        [sel, jnp.asarray(tg.residual_log)[:, None]], axis=-1)
    return jax.nn.logsumexp(stacked, axis=-1)
