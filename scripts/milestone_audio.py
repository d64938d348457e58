"""Audio-to-decision milestone: waveform in → verify decision out.

Round-4 VERDICT item 8: every other milestone starts from synthetic
``.prm`` feature files; this one starts from RAW AUDIO and exercises the
full serving path of `api/spkdet.py` (the reference
SimpleSpkDetSystem.cpp flow: parameterizeAudio 470 → energy VAD + CMVN
normalizeFeatures 392 → adaptSpeakerModel 901 → verifySpeaker 975),
plus one pass through the TCP server (SpkDetServer.cpp:845 wire
protocol), recording:

  * EER/minDCF over target + impostor verify trials,
  * p50/p95 verify latency per audio length (1/3/5/10 s) — the
    bucket-padding claim in api/spkdet.py _llr (one executable per
    frame bucket => flat latency) is MEASURED here,
  * one TCP round-trip verify (protocol sanity + its latency).

Synthetic voices: each speaker is coloured noise with speaker-specific
formant resonances (3 Gaussian spectral bumps); each utterance adds a
session-specific smooth spectral tilt + white noise, so MFCC envelopes
carry identity and sessions carry channel, like the feature-domain
corpora.

Usage: python scripts/milestone_audio.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

SR = 8000.0
N_SPK = 10
N_IMP = 5
ENROLL_S = 6.0
TEST_LENS = [1.0, 3.0, 5.0, 10.0]
TESTS_PER_LEN = 2          # per target speaker per length


def voice(rng, phonemes, tilt, seconds):
    """Speech-like synthetic voice: a sequence of 60-200 ms 'phoneme'
    segments, each coloured noise shaped by that phoneme's formant
    bumps, with a session spectral tilt, amplitude-modulated into
    bursts with near-silent pauses (so the energy VAD has real work).

    NON-stationarity is load-bearing: the serving path applies 0/1 CMVN
    (normalizeFeatures, SimpleSpkDetSystem.cpp:392), which deletes the
    per-utterance MFCC mean/scale — a stationary voice loses its whole
    identity there.  A speaker-specific PHONEME INVENTORY puts identity
    in the multimodal frame distribution, which CMVN preserves."""
    n = int(seconds * SR)
    sig = np.zeros(n, np.float32)
    t = 0
    while t < n:
        seg = int(rng.uniform(0.06, 0.2) * SR)
        seg = min(seg, n - t)
        formants = phonemes[rng.integers(len(phonemes))]
        spec = np.fft.rfft(rng.standard_normal(seg))
        f = np.fft.rfftfreq(seg, 1.0 / SR)
        env = 0.05 + sum(np.exp(-0.5 * ((f - f0) / bw) ** 2)
                         for f0, bw in formants)
        env = env * np.exp(tilt * (f / (SR / 2)))
        sig[t:t + seg] = np.fft.irfft(spec * env, seg)
        t += seg
    sig = sig / (np.abs(sig).max() + 1e-9) * 0.5
    # burst envelope: ~0.3-0.8 s speech, ~0.1-0.3 s pause (20 dB down)
    gate = np.full(n, 0.1, np.float32)
    t = 0
    while t < n:
        on = int(rng.uniform(0.3, 0.8) * SR)
        gate[t:t + on] = 1.0
        t += on + int(rng.uniform(0.1, 0.3) * SR)
    return (sig * gate).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    from lia_ral.api import (RemoteSpkDetClient, SimpleSpkDetSystem,
                                 SpkDetServer)
    from lia_ral.backend.eval import eer, min_dcf
    from lia_ral.config import Config
    from lia_ral.gmm.em import TrainCfg, mixture_init, train_model
    from lia_ral.gmm.model import GmmDiag

    rng = np.random.default_rng(20260822)
    t_all = time.perf_counter()

    def spk_formants():
        return [(rng.uniform(250, 900), rng.uniform(80, 160)),
                (rng.uniform(900, 2200), rng.uniform(120, 260)),
                (rng.uniform(2200, 3600), rng.uniform(180, 400))]

    # each speaker = an inventory of 6 phoneme formant-sets
    speakers = [[spk_formants() for _ in range(6)]
                for _ in range(N_SPK + N_IMP)]

    def utt(spk, seconds):
        return voice(rng, speakers[spk], rng.uniform(-1.0, 1.0), seconds)

    sysm = SimpleSpkDetSystem(Config(), sample_rate=SR)

    # UBM from ~60 s of audio across all speakers, through add_audio
    t0 = time.perf_counter()
    for s in range(N_SPK + N_IMP):
        sysm.add_audio(utt(s, 4.0))
    sysm.normalize_features(energy_column=19)
    x = sysm.features
    import jax.numpy as jnp
    tcfg = TrainCfg(nb_train_it=4, bagged_frame_probability=1.0,
                    bagged_frame_probability_init=1.0)
    w = jnp.ones(x.shape[0], jnp.float32)
    init = mixture_init(jax.random.key(0), jnp.asarray(x), w, 128, 1.0)
    ubm = train_model(jax.random.key(1), jnp.asarray(x), w, init, tcfg)
    sysm.set_background_model(ubm)
    sysm.reset_features()
    t_ubm = time.perf_counter() - t0

    # enroll targets + impostor models through the serving API
    t0 = time.perf_counter()
    for s in range(N_SPK + N_IMP):
        sysm.add_audio(utt(s, ENROLL_S))
        sysm.normalize_features(energy_column=19)
        sysm.create_speaker_model(f"spk{s}")
        sysm.reset_features()
    t_enroll = time.perf_counter() - t0

    # verify trials: per length, each target speaker vs own + 3 impostor
    # models; latency measured around verify_speaker only
    lat: dict[float, list[float]] = {L: [] for L in TEST_LENS}
    tgt, imp = [], []
    for L in TEST_LENS:
        for s in range(N_SPK):
            for _ in range(TESTS_PER_LEN):
                sysm.add_audio(utt(s, L))
                sysm.normalize_features(energy_column=19)
                for uid in [f"spk{s}"] + [
                        f"spk{N_SPK + j}" for j in
                        rng.choice(N_IMP, 3, replace=False)]:
                    t0 = time.perf_counter()
                    _, score = sysm.verify_speaker(uid)
                    lat[L].append(time.perf_counter() - t0)
                    (tgt if uid == f"spk{s}" else imp).append(score)
                sysm.reset_features()
    tgt_a, imp_a = np.asarray(tgt), np.asarray(imp)
    res = {"audio_eer": float(eer(tgt_a, imp_a)),
           "audio_mindcf": float(min_dcf(tgt_a, imp_a)),
           "n_target_trials": int(tgt_a.size),
           "n_impostor_trials": int(imp_a.size)}
    lat_table = {}
    for L in TEST_LENS:
        a = np.asarray(lat[L]) * 1000.0
        lat_table[f"{L:g}s"] = {"p50_ms": round(float(np.percentile(a, 50)), 1),
                                "p95_ms": round(float(np.percentile(a, 95)), 1)}
    p50s = [lat_table[f"{L:g}s"]["p50_ms"] for L in TEST_LENS]
    res["latency_flat_ratio"] = round(max(p50s) / max(min(p50s), 1e-9), 2)

    # one TCP round trip: load UBM + a model, stream audio, verify
    d = tempfile.mkdtemp(prefix="audio_ms_")
    ubm_path = os.path.join(d, "wld.gmm")
    ubm.save(ubm_path)
    spk_path = os.path.join(d, "spk0.gmm")
    sysm.save_speaker_model("spk0", spk_path)
    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    try:
        cli = RemoteSpkDetClient(port=port)
        cli.load_world(ubm_path)
        cli.load_speaker("spk0", spk_path)
        sig = utt(0, 3.0)
        t0 = time.perf_counter()
        cli.send_audio(sig)
        decision, score = cli.verify("spk0")
        res["tcp_verify_wall_ms"] = round(
            (time.perf_counter() - t0) * 1000.0, 1)
        res["tcp_verify_score"] = round(float(score), 4)
        res["tcp_verify_accept"] = bool(score > 0)
        cli.close()
    finally:
        srv.stop()

    summary = {
        "milestone": "audio-to-decision serving (waveform -> MFCC -> VAD "
                     "-> CMVN -> enroll/verify)",
        "platform": str(jax.devices()[0]),
        "shapes": {"sample_rate": SR, "K": 128, "n_targets": N_SPK,
                   "enroll_s": ENROLL_S, "test_lens_s": TEST_LENS},
        "results": res,
        "verify_latency_ms": lat_table,
        "wall_s": {"ubm": round(t_ubm, 1), "enroll": round(t_enroll, 1),
                   "total": round(time.perf_counter() - t_all, 1)},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
