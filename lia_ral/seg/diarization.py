"""Diarization processes: turn detection, E-HMM segmentation,
resegmentation, acoustic segmentation.

JAX equivalents of the LIA_SpkSeg tools (SURVEY.md §2.3):
* TurnDetection (TurnDetection.cpp:54-101): GLR/BIC over two sliding
  0.5 s windows, peak picking at α·σ;
* Segmentation (Segmentation.cpp:63-484): one-step E-HMM — iteratively
  add speakers (addSpeaker cpp:211), EM-train state models, Viterbi
  decode (cpp:459), stop criteria (cpp:275/332);
* ReSegmentation (ReSegmentation.cpp:55-328): rebuild the HMM from an
  existing segmentation, MAP-adapt speaker models + Viterbi loop;
* AcousticSegmentation (AcousticSegmentation.cpp:55-354): decode with
  pretrained event GMMs + minimum-duration rules.

Orchestration is host-side (matching the reference's loop structure over
small HMMs); all per-frame compute (emissions, EM stats, Viterbi) runs in
the jitted kernels.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..gmm.em import TrainCfg, m_step, mixture_init, train_model
from ..gmm.kernels import em_stats
from ..gmm.map_adapt import MapCfg, adapt_model
from ..gmm.model import GmmDiag
from .clustering import glr_window_distance
from .hmm import (DiarHmm, compute_transitions, path_to_segments,
                  viterbi_decode, _viterbi)


def create_world(key, x: jax.Array, w: jax.Array, max_distrib: int,
                 nb_train_it: int = 3) -> GmmDiag:
    """World model for diarization by binary-split init + EM (reference
    createWorld, Tools.cpp:1243-1271 → mixtureInitBySplit)."""
    from ..gmm.em import mixture_init_by_split
    return mixture_init_by_split(key, x, w, max_distrib,
                                 TrainCfg(nb_train_it=nb_train_it))


def seg_em(key, x: jax.Array, w: jax.Array, init: GmmDiag,
           nb_train_it: int = 5) -> GmmDiag:
    """EM-train a state model on the frames of one segmentation mask
    (reference segEM, Tools.h:153)."""
    return train_model(key, x, w, init, TrainCfg(nb_train_it=nb_train_it))


def seg_adaptation(key, x: jax.Array, hmm: DiarHmm, path: np.ndarray,
                   world: GmmDiag, min_state_frames: int = 1
                   ) -> tuple[DiarHmm, list[int]]:
    """MAP-adapt every HMM state on its currently assigned frames and drop
    states that lost all data (reference segAdaptation, Tools.cpp:1276 →
    NoDataSpeakerVerification, Tools.cpp:862-908).  Returns the updated
    HMM and the kept state indices."""
    s = hmm.n_states
    masks = (np.asarray(path)[None, :] == np.arange(s)[:, None]
             ).astype(np.float32)
    keep = [si for si in range(s) if masks[si].sum() >= min_state_frames]
    adapted = _batched_state_adapt(jax.random.split(key, s), x,
                                   jnp.asarray(masks), world)
    idx = np.asarray(keep, np.int64)
    kept = jax.tree.map(lambda a: a[idx], adapted)
    names = [hmm.names[si] for si in keep]
    return DiarHmm(gmms=kept, names=names,
                   log_trans=jnp.log(jnp.asarray(
                       compute_transitions(len(keep)), jnp.float32) + 1e-30)
                   ), keep


@functools.partial(jax.jit, static_argnames=("window",))
def glr_distance_curve(x: jax.Array, window: int) -> jax.Array:
    """GLR between the two ``window``-frame windows around every frame,
    as one device call (reference TurnDetection.cpp:54-78 runs the
    two-window scatter per frame from the host — a classic prefix-sum):

        d[t] = 2w·log|Σ_merged| − w·(log|Σ_left| + log|Σ_right|)

    with diagonal covariances from cumulative Σx / Σx² (globally centered
    first so the f32 cumsums keep precision over long signals).
    Returns (N,) with zeros outside [window, N − window)."""
    n, d = x.shape
    x = x - jnp.mean(x, axis=0)[None, :]
    zero = jnp.zeros((1, d), x.dtype)
    c1 = jnp.concatenate([zero, jnp.cumsum(x, axis=0)])
    c2 = jnp.concatenate([zero, jnp.cumsum(x * x, axis=0)])

    def win_logdet(lo, hi):
        cnt = (hi - lo).astype(x.dtype)[:, None]
        mean = (c1[hi] - c1[lo]) / cnt
        var = (c2[hi] - c2[lo]) / cnt - mean * mean
        return jnp.sum(jnp.log(jnp.maximum(var, 1e-8)), axis=1)

    t = jnp.arange(n)
    t_lo = jnp.clip(t - window, 0, n)
    t_hi = jnp.clip(t + window, 0, n)
    ld_l = win_logdet(t_lo, t)
    ld_r = win_logdet(t, t_hi)
    ld_m = win_logdet(t_lo, t_hi)
    dist = (2 * window) * ld_m - window * (ld_l + ld_r)
    valid = (t >= window) & (t < n - window)
    return jnp.where(valid, dist, 0.0)


def turn_detection(x: np.ndarray, window: int = 50, alpha: float = 0.6,
                   min_gap: int = 25) -> np.ndarray:
    """Speaker-turn candidates: GLR distance between the two windows
    around each frame, peaks above mean+α·σ, local-maximum pick with a
    minimum gap (reference TurnDetection.cpp:54-101).
    Returns frame indices of detected turns.

    The distance curve is one jitted prefix-sum pass on device
    (glr_distance_curve) instead of N host-side covariance logdets; only
    the tiny sequential peak-pick stays on the host."""
    n = x.shape[0]
    if n < 2 * window + 1:
        return np.zeros(0, np.int64)
    dists = np.asarray(glr_distance_curve(jnp.asarray(x, jnp.float32),
                                          window), np.float64)
    thr = dists.mean() + alpha * dists.std()
    turns = []
    for t in range(window, n - window):
        lo, hi = max(t - min_gap, 0), min(t + min_gap + 1, n)
        if dists[t] >= thr and dists[t] == dists[lo:hi].max():
            if not turns or t - turns[-1] >= min_gap:
                turns.append(t)
    return np.asarray(turns, np.int64)


def _train_state_model(key, x, w, world: GmmDiag, map_reg: float = 16.0,
                       nb_it: int = 3) -> GmmDiag:
    """Speaker state model by MAP adaptation from the world (the
    reference's segEM/segAdaptation, Tools.h:152-153)."""
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, weight_adapt=True,
                 mean_r=map_reg, weight_r=map_reg, nb_train_it=nb_it)
    return adapt_model(key, x, w, world, cfg)


@functools.partial(jax.jit, static_argnames=("map_reg", "nb_it"))
def _batched_state_adapt(keys, x, masks, world: GmmDiag,
                         map_reg: float = 16.0, nb_it: int = 3) -> GmmDiag:
    """MAP-adapt one state model per mask row in a single vmapped device
    call — replaces the reference's serial per-speaker segAdaptation loop
    (Tools.cpp:1276).  Rows with an all-zero mask come back ≈world (zero
    occupancy MAP keeps the prior), so callers can pad to a static state
    count and reuse one compiled executable for the whole E-HMM run."""
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, weight_adapt=True,
                 mean_r=map_reg, weight_r=map_reg, nb_train_it=nb_it)
    return jax.vmap(lambda k, m: adapt_model(k, x, m, world, cfg))(keys, masks)


def _merge_state_rows(old: GmmDiag, new: GmmDiag, take_new) -> GmmDiag:
    """Per-state select between two stacked-GMM pytrees."""
    return jax.tree.map(
        lambda o, nw: jnp.where(
            jnp.reshape(take_new, (-1,) + (1,) * (o.ndim - 1)), nw, o),
        old, new)


@jax.jit
def _masked_emissions(x, gmms: GmmDiag, active_mask) -> jax.Array:
    """Per-frame per-state emissions with inactive (padding) states forced
    to −1e30 so Viterbi never enters them."""
    from .hmm import emission_llk
    em = emission_llk(x, DiarHmm(gmms=gmms, names=[], log_trans=None))
    return jnp.where(active_mask[None, :] > 0, em, -1e30)


def e_hmm_segmentation(
    x: np.ndarray,
    world: GmmDiag,
    max_speakers: int = 5,
    init_seg_frames: int = 300,
    nb_decode_it: int = 3,
    min_duration: int = 50,
    frame_length: float = 0.01,
    seed: int = 0,
    map_reg: float = 16.0,
    verbose: bool = False,
):
    """E-HMM speaker segmentation (reference Segmentation.cpp:356-484).

    Iteratively: pick the region worst-explained by existing speakers as
    the seed of a new speaker, MAP-train its model, re-decode with the
    grown HMM, until max_speakers or no region left.

    Shape discipline: the state bank is padded to a static
    ``max_speakers`` rows with an activity mask, so the whole run reuses
    exactly one compiled executable each for {batched MAP re-adaptation,
    masked emissions, Viterbi} — instead of recompiling at every speaker
    count (the reference's host loop is O(speakers²) model retrains,
    Segmentation.cpp:356-484).  Returns (segments, state path)."""
    xj = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    s_max = max(max_speakers, 1)
    key = jax.random.key(seed)

    def full_log_trans(active: int) -> jax.Array:
        t = np.full((s_max, s_max), 1e-30)
        t[:active, :active] = compute_transitions(active)
        return jnp.log(jnp.asarray(t, jnp.float32))

    def adapt(masks_np: np.ndarray, k) -> GmmDiag:
        # map_reg is the reference's MAPRegFactor reaching segAdaptation
        # (Tools.cpp:1276); a seed of init_seg_frames frames over K
        # components moves its means only occ/(occ+r) per iteration, so
        # strong priors can starve new speakers of any Viterbi frames
        return _batched_state_adapt(jax.random.split(k, s_max), xj,
                                    jnp.asarray(masks_np), world,
                                    map_reg=map_reg)

    # state 0 trained on all frames (reference addSpeaker on L0 world)
    masks = np.zeros((s_max, n), np.float32)
    masks[0] = 1.0
    key, k0 = jax.random.split(key)
    bank = adapt(masks, k0)
    active = 1
    names = ["S0"]

    def decode(bank, active):
        amask = jnp.asarray(np.arange(s_max) < active, jnp.float32)
        em = _masked_emissions(xj, bank, amask)
        path = np.asarray(_viterbi(em, full_log_trans(active)))
        return path, np.asarray(em)

    path, em = decode(bank, active)
    for spk in range(1, max_speakers):
        # per-frame LLK of the assigned state → worst window seeds S_spk
        assigned = em[np.arange(n), path]
        if n <= init_seg_frames:
            break
        window_scores = np.convolve(assigned,
                                    np.ones(init_seg_frames) / init_seg_frames,
                                    mode="valid")
        start = int(np.argmin(window_scores))
        seed_masks = np.zeros((s_max, n), np.float32)
        seed_masks[spk, start:start + init_seg_frames] = 1.0
        key, ks = jax.random.split(key)
        bank = _merge_state_rows(
            bank, adapt(seed_masks, ks),
            jnp.asarray(np.arange(s_max) == spk))
        active = spk + 1
        names.append(f"S{spk}")
        # iterative decode + batched re-adapt (reference nbDecodeIt loop)
        for _ in range(nb_decode_it):
            path, em = decode(bank, active)
            masks = (path[None, :] == np.arange(s_max)[:, None]
                     ).astype(np.float32)
            counts = masks.sum(axis=1)
            key, ka = jax.random.split(key)
            # states with <10 assigned frames keep their previous model
            bank = _merge_state_rows(bank, adapt(masks, ka),
                                     jnp.asarray(counts >= 10))
        # re-decode with the final adapted bank so the NEXT speaker's
        # worst-window seeding (and the loop-exit path) uses fresh
        # emissions — the reference re-decodes with the current HMM
        # before seeding (Segmentation.cpp:459 then addSpeaker cpp:211)
        path, em = decode(bank, active)
        if verbose:
            print(f"E-HMM: {active} speakers, "
                  f"frames/state={np.bincount(path, minlength=active)}")
    path, _ = decode(bank, active)
    segs = path_to_segments(path, names, frame_length, min_duration)
    return segs, path


def resegmentation(
    x: np.ndarray,
    segments,
    world: GmmDiag,
    nb_it: int = 3,
    min_duration: int = 50,
    min_state_frames: int = 25,
    frame_length: float = 0.01,
    seed: int = 0,
    map_reg: float = 16.0,
):
    """Refinement pass (reference ReSegmentation.cpp:245-328): rebuild the
    HMM from an existing segmentation, MAP-adapt state models, Viterbi
    re-decode, drop speakers that lose all their frames."""
    from ..io.labels import segments_to_frame_mask
    xj = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    names = sorted({s.label for s in segments})
    s = len(names)
    key = jax.random.key(seed)
    masks = np.stack([
        np.asarray(segments_to_frame_mask(
            [sg for sg in segments if sg.label == nm], n, frame_length),
            np.float32)
        for nm in names])                                   # (S, N)
    key, k0 = jax.random.split(key)
    bank = _batched_state_adapt(jax.random.split(k0, s), xj,
                                jnp.asarray(masks), world, map_reg=map_reg)
    # static (S,)-shaped state bank + activity mask: dropped speakers get
    # −1e30 emissions instead of a shape change, so the nb_it loop reuses
    # one compiled executable per kernel
    active = np.ones(s, bool)

    def log_trans(act: np.ndarray) -> jax.Array:
        """Transitions over the REMAINING states embedded in the static
        (s, s) matrix — the reference rebuilds the HMM over the surviving
        speakers after a drop (ReSegmentation.cpp:245-328), so the
        off-diagonal mass must be split over (n_active − 1) states, not
        the original (s − 1)."""
        t = np.full((s, s), 1e-30)
        idx = np.nonzero(act)[0]
        t[np.ix_(idx, idx)] = compute_transitions(max(len(idx), 1))
        return jnp.log(jnp.asarray(t, jnp.float32))

    path = None
    for _ in range(nb_it):
        em = _masked_emissions(xj, bank, jnp.asarray(active, jnp.float32))
        path = np.asarray(_viterbi(em, log_trans(active)))
        masks = (path[None, :] == np.arange(s)[:, None]).astype(np.float32)
        counts = masks.sum(axis=1)
        active &= counts >= min_state_frames   # drop irrelevant speakers
        key, kk = jax.random.split(key)
        bank = _batched_state_adapt(jax.random.split(kk, s), xj,
                                    jnp.asarray(masks * active[:, None]),
                                    world, map_reg=map_reg)
    em = _masked_emissions(xj, bank, jnp.asarray(active, jnp.float32))
    path = np.asarray(_viterbi(em, log_trans(active)))
    return path_to_segments(path, names, frame_length, min_duration), path


def acoustic_segmentation(
    x: np.ndarray,
    event_models: list[GmmDiag],
    event_names: list[str],
    min_duration: int = 30,
    frame_length: float = 0.01,
):
    """SAD/acoustic event segmentation with pretrained GMMs (reference
    AcousticSegmentation.cpp:258-354): Viterbi over the event HMM with
    minimum-duration post-rules."""
    hmm = DiarHmm.from_gmms(event_models, event_names)
    path = viterbi_decode(jnp.asarray(x, jnp.float32), hmm)
    return path_to_segments(path, event_names, frame_length, min_duration), path
