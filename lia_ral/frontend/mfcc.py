"""MFCC extraction (filter-bank cepstra) — replaces the external SPro L0.

The reference does not extract features itself (README.md "Feature
extraction": SPro or HTK produce the .prm files; SimpleSpkDetSystem calls
spro_cepstral_analysis, SimpleSpkDetSystem.cpp:470).  This module provides
a JAX-native MFCC front end with the SPro-style pipeline: pre-emphasis →
framing → Hamming window → |FFT| → mel filter bank → log → DCT → optional
log-energy and deltas.  Batched over frames — the FFT and the DCT/filter
matmuls are XLA-native matrix products.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class MfccCfg:
    sample_rate: float = 8000.0
    frame_length_s: float = 0.020     # SPro default 20 ms
    frame_shift_s: float = 0.010      # 10 ms (reference frameLength 0.01)
    n_filters: int = 24
    n_ceps: int = 19                  # BASELINE config 1: 19-dim MFCC
    pre_emphasis: float = 0.95
    with_energy: bool = True
    freq_min: float = 0.0
    freq_max: float = 0.0             # 0 → Nyquist


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _imel(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_fft: int, n_filters: int, sample_rate: float,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filter bank (n_fft//2+1, n_filters)."""
    if fmax <= 0:
        fmax = sample_rate / 2
    mels = np.linspace(_mel(fmin), _mel(fmax), n_filters + 2)
    hz = _imel(mels)
    bins = np.floor((n_fft + 1) * hz / sample_rate).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_filters))
    for j in range(n_filters):
        lo, c, hi = bins[j], bins[j + 1], bins[j + 2]
        for i in range(lo, c):
            if c > lo:
                fb[i, j] = (i - lo) / (c - lo)
        for i in range(c, hi):
            if hi > c:
                fb[i, j] = (hi - i) / (hi - c)
    return fb


def dct_matrix(n_ceps: int, n_filters: int) -> np.ndarray:
    """DCT-II basis (n_filters, n_ceps), c0 excluded (SPro convention)."""
    j = np.arange(n_filters)
    out = np.zeros((n_filters, n_ceps))
    for i in range(1, n_ceps + 1):
        out[:, i - 1] = np.cos(math.pi * i * (j + 0.5) / n_filters)
    return out * math.sqrt(2.0 / n_filters)


def mfcc(signal: jax.Array, cfg: MfccCfg | None = None) -> jax.Array:
    """signal (S,) float → (N, n_ceps[+1]) MFCC frames (energy last,
    matching the fixture layout where featureServerMask drops column 16)."""
    cfg = cfg or MfccCfg()
    flen = int(round(cfg.frame_length_s * cfg.sample_rate))
    shift = int(round(cfg.frame_shift_s * cfg.sample_rate))
    n_fft = 1 << max(8, (flen - 1).bit_length())
    sig = jnp.asarray(signal, jnp.float32)
    # pre-emphasis
    sig = jnp.concatenate([sig[:1], sig[1:] - cfg.pre_emphasis * sig[:-1]])
    n_frames = max((sig.shape[0] - flen) // shift + 1, 0)
    idx = (jnp.arange(n_frames)[:, None] * shift
           + jnp.arange(flen)[None, :])                       # (N,flen)
    frames = sig[idx]
    window = jnp.asarray(np.hamming(flen), jnp.float32)
    fw = frames * window[None, :]
    spec = jnp.abs(jnp.fft.rfft(fw, n=n_fft, axis=-1))        # (N,F)
    fb = jnp.asarray(mel_filterbank(n_fft, cfg.n_filters, cfg.sample_rate,
                                    cfg.freq_min, cfg.freq_max), jnp.float32)
    logmel = jnp.log(jnp.maximum(spec @ fb, 1e-10))           # (N,M)
    dct = jnp.asarray(dct_matrix(cfg.n_ceps, cfg.n_filters), jnp.float32)
    ceps = logmel @ dct                                       # (N,C)
    if cfg.with_energy:
        energy = jnp.log(jnp.maximum(jnp.sum(fw * fw, axis=-1), 1e-10))
        ceps = jnp.concatenate([ceps, energy[:, None]], axis=-1)
    return ceps


def add_deltas(x: jax.Array, window: int = 2) -> jax.Array:
    """Append delta coefficients (SPro WITHD): regression over ±window."""
    n = x.shape[0]
    num = jnp.zeros_like(x)
    den = 0.0
    for t in range(1, window + 1):
        fwd = jnp.concatenate([x[t:], jnp.repeat(x[-1:], t, axis=0)])
        bwd = jnp.concatenate([jnp.repeat(x[:1], t, axis=0), x[:-t]])
        num = num + t * (fwd - bwd)
        den += 2.0 * t * t
    del n
    return jnp.concatenate([x, num / den], axis=-1)
