"""End-to-end diarization milestone: the FULL 4-stage LIA_SpkSeg chain.

r4 drove only Segmentation→ReSegmentation on an all-speech corpus;
this (r5, VERDICT r4 missing #1) drives the reference's complete
pipeline shape on a conversation WITH silence and music:

  1. AcousticSegmentation (SAD): Viterbi over pretrained
     speech/silence/music GMMs (AcousticSegmentation.cpp:55-354,
     launchAcousticSegmentationProcess:354) — scored as SAD frame
     error + miss/false-alarm;
  2. TurnDetection on the speech frames (GLR boundary detection,
     TurnDetection.cpp:54-101) — scored as boundary recall/precision
     at a ±250 ms tolerance;
  3. Segmentation (E-HMM speaker carving, Segmentation.cpp:356-484)
     on the SAD speech — scored as full-timeline DER (so SAD misses/
     false alarms COUNT, unlike r4's speech-only corpus);
  4. ReSegmentation (ReSegmentation.cpp:245-328) — refined DER.

Plus the turn-driven chain the reference's clustering tools support:
detected turns are greedily clustered by world-normalised mean LLK
(bestFittingCluster/cohortMaxLikelihood semantics, Tools.cpp:736) and
the clusters are handed to ReSegmentation as its initial segmentation
— so the turn stage's quality contribution is measured end-to-end.

The acoustic event models are trained on bootstrap samples drawn from
the same generators (the reference ships pretrained .gmm event models;
training them stands in for that fixture).

Usage: python scripts/milestone_diar.py [--out FILE] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

N_SPK = 3
MINUTES = 5.0
D_FEAT = 24
K_BED = 64
K_UBM = 128
FRAME = 0.01
TOL_FRAMES = 25                 # ±250 ms boundary tolerance


def gen_conversation(rng):
    """(features (N,D), ref ids: speaker 0..N_SPK-1, -1 silence,
    -2 music) — speech turns separated by silence gaps with occasional
    music segments, plus bootstrap samples per acoustic event."""
    centers = rng.standard_normal((K_BED, D_FEAT)) * 2.0
    spk_w = rng.dirichlet(np.full(K_BED, 2.5), size=N_SPK)
    spk_off = rng.standard_normal((N_SPK, K_BED, D_FEAT)) * 0.35
    mus_centers = rng.standard_normal((8, D_FEAT)) * 2.5
    sil_mean = np.full(D_FEAT, -3.5)

    def speech(s, n):
        comp = rng.choice(K_BED, size=n, p=spk_w[s])
        return (centers[comp] + spk_off[s, comp]
                + rng.standard_normal((n, D_FEAT)) * 0.6)

    def silence(n):
        return sil_mean + rng.standard_normal((n, D_FEAT)) * 0.25

    def music(n):
        comp = rng.integers(0, 8, n)
        return mus_centers[comp] + rng.standard_normal((n, D_FEAT)) * 0.4

    frames, ref = [], []
    total = int(MINUTES * 60 / FRAME)
    cur = 0
    while cur < total:
        s = int(rng.integers(N_SPK))
        n = int(rng.uniform(2.0, 8.0) * 100)
        frames.append(speech(s, n))
        ref.extend([s] * n)
        cur += n
        roll = rng.random()
        if roll < 0.55:                       # silence gap
            n = int(rng.uniform(0.5, 2.0) * 100)
            frames.append(silence(n))
            ref.extend([-1] * n)
            cur += n
        elif roll < 0.70:                     # music interlude
            n = int(rng.uniform(2.0, 5.0) * 100)
            frames.append(music(n))
            ref.extend([-2] * n)
            cur += n
    x = np.concatenate(frames).astype(np.float32)
    ref = np.asarray(ref)
    boots = {
        "boot_speech": np.concatenate(
            [speech(s, 2000) for s in range(N_SPK)]).astype(np.float32),
        "boot_silence": silence(2000).astype(np.float32),
        "boot_music": music(3000).astype(np.float32),
    }
    return x, ref, boots


def segs_to_frames(segs, n, frame_length=FRAME):
    out = np.full(n, -1, np.int64)
    names = {}
    for s in segs:
        b = int(round(s.begin / frame_length))
        e = min(int(round(s.end / frame_length)), n)
        if s.label not in names:
            names[s.label] = len(names)
        out[b:e] = names[s.label]
    return out


def boundary_pr(true_b, det_b, tol=TOL_FRAMES):
    """Recall/precision of detected boundaries at ±tol frames."""
    true_b, det_b = np.asarray(true_b), np.asarray(det_b)
    if len(true_b) == 0 or len(det_b) == 0:
        return 0.0, 0.0
    hit_t = np.array([np.min(np.abs(det_b - t)) <= tol for t in true_b])
    hit_d = np.array([np.min(np.abs(true_b - t)) <= tol for t in det_b])
    return float(hit_t.mean()), float(hit_d.mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from lia_ral.backend.eval import der
    from lia_ral.config import Config
    from lia_ral.gmm.map_adapt import MapCfg, adapt_model
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.io.features import write_feature_file
    from lia_ral.seg.clustering import segment_mean_llk
    from lia_ral.io.labels import Segment
    from lia_ral.tools import train_world
    from lia_ral.tools.spkseg_tools import (acoustic_main, reseg_main,
                                                segmentation_main,
                                                turn_detection_main)
    from lia_ral.utils.stagemon import StageMonitor

    rng = np.random.default_rng(20260823)
    d = tempfile.mkdtemp(prefix="milestone_diar_")
    mon = StageMonitor()
    stage = mon.stage

    with stage("gen_corpus"):
        x, ref, boots = gen_conversation(rng)
        write_feature_file(os.path.join(d, "conv.prm"), x, fmt="SPRO4")
        for nm, bx in boots.items():
            write_feature_file(os.path.join(d, nm + ".prm"), bx,
                               fmt="SPRO4")

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "nbTrainIt": 4, "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
    }

    # ---- stage 0: acoustic event models (stand-in for the reference's
    # pretrained speech/silence/music fixtures) + conversation UBM ------
    with stage("train_acoustic_models"):
        # one K for all events: DiarHmm.from_gmms stacks the state
        # models into a single batched bank (same-shape requirement)
        for nm, k in (("boot_speech", 32), ("boot_silence", 32),
                      ("boot_music", 32)):
            cfg = Config(base)
            cfg["mixtureDistribCount"] = k
            cfg["inputFeatureFilename"] = nm
            cfg["outputWorldFilename"] = nm.replace("boot_", "evt_")
            train_world.main(cfg)

    # ---- stage 1: AcousticSegmentation (SAD) --------------------------
    with stage("acoustic_segmentation"):
        cfg = Config(base)
        cfg["inputFeatureFilename"] = "conv"
        cfg["acousticModels"] = "evt_speech,evt_silence,evt_music"
        cfg["saveLabelFileExtension"] = ".sad.lbl"
        cfg["minimumDuration"] = 30
        ev_segs = acoustic_main(cfg)["conv"]

    n = ref.shape[0]
    sad = np.zeros(n, bool)
    for s in ev_segs:
        if s.label == "evt_speech":
            b = int(round(s.begin / FRAME))
            e = min(int(round(s.end / FRAME)), n)
            sad[b:e] = True
    ref_speech = ref >= 0
    res = {
        "n_frames": int(n),
        "speech_frac_ref": round(float(ref_speech.mean()), 4),
        "sad_frame_err": round(float((sad != ref_speech).mean()), 5),
        "sad_miss": round(float((ref_speech & ~sad).sum()
                                / max(ref_speech.sum(), 1)), 5),
        "sad_fa": round(float((~ref_speech & sad).sum()
                              / max((~ref_speech).sum(), 1)), 5),
    }

    # speech-only timeline for the downstream stages (the reference
    # selects the SAD label before Segmentation — labelSelectedFrames)
    sp_idx = np.nonzero(sad)[0]
    x_sp = x[sp_idx]
    write_feature_file(os.path.join(d, "convsp.prm"), x_sp, fmt="SPRO4")
    ref_sp = ref[sp_idx]

    # conversation world UBM on the SAD-selected SPEECH frames (the
    # reference's createWorld runs under labelSelectedFrames=speech,
    # Tools.cpp:1243 — a world containing silence/music lobes starves
    # the E-HMM speaker carving, measured 2/3 speakers on this corpus)
    with stage("train_world"):
        cfg = Config(base)
        cfg["mixtureDistribCount"] = K_UBM
        cfg["inputFeatureFilename"] = "convsp"
        cfg["outputWorldFilename"] = "wld"
        train_world.main(cfg)

    # ---- stage 2: TurnDetection on the SAD speech ---------------------
    with stage("turn_detection"):
        cfg = Config(base)
        cfg["inputFeatureFilename"] = "convsp"
        cfg["saveLabelFileExtension"] = ".turn.lbl"
        cfg["windowDuration"] = 1.0
        cfg["alpha"] = 0.7
        turn_segs = turn_detection_main(cfg)["convsp"]

    det_b = [int(round(s.begin / FRAME)) for s in turn_segs[1:]]
    # true boundaries on the speech timeline: speaker changes, plus
    # splice points where SAD removed a gap between different speakers
    chg = np.nonzero(np.diff(ref_sp) != 0)[0] + 1
    rec, prec = boundary_pr(chg, det_b)
    res.update({"n_turns_detected": len(det_b),
                "n_true_boundaries": int(len(chg)),
                "turn_recall_250ms": round(rec, 4),
                "turn_precision_250ms": round(prec, 4)})

    # ---- stage 3: Segmentation (E-HMM) on the SAD speech --------------
    with stage("segmentation"):
        cfg = Config(base)
        cfg["mixtureDistribCount"] = K_UBM
        cfg["inputFeatureFilename"] = "convsp"
        cfg["inputWorldFilename"] = "wld"
        cfg["maxSpeakers"] = 5
        cfg["MAPRegFactorMean"] = 3.0       # weak prior: see r4 root-cause
        cfg["saveLabelFileExtension"] = ".seg.lbl"
        segs = segmentation_main(cfg)["convsp"]

    def full_timeline(hyp_sp):
        hyp = np.full(n, -1, np.int64)
        hyp[sp_idx] = hyp_sp
        return hyp

    hyp_seg = full_timeline(segs_to_frames(segs, len(sp_idx)))
    res["n_hyp_speakers_seg"] = int(len({s.label for s in segs}))
    res["der_segmentation"] = round(der(ref, hyp_seg), 5)
    res["der_segmentation_collar25"] = round(
        der(ref, hyp_seg, collar_frames=TOL_FRAMES), 5)

    # ---- stage 4: ReSegmentation --------------------------------------
    with stage("resegmentation"):
        cfg = Config(base)
        cfg["mixtureDistribCount"] = K_UBM
        cfg["inputFeatureFilename"] = "convsp"
        cfg["inputWorldFilename"] = "wld"
        cfg["MAPRegFactorMean"] = 3.0
        cfg["loadLabelFileExtension"] = ".seg.lbl"
        cfg["saveLabelFileExtension"] = ".reseg.lbl"
        rsegs = reseg_main(cfg)["convsp"]

    hyp_rs = full_timeline(segs_to_frames(rsegs, len(sp_idx)))
    res["n_hyp_speakers_reseg"] = int(len({s.label for s in rsegs}))
    res["der_resegmentation"] = round(der(ref, hyp_rs), 5)
    res["der_resegmentation_collar25"] = round(
        der(ref, hyp_rs, collar_frames=TOL_FRAMES), 5)

    # ---- turn-driven chain: greedy LLK clustering of the detected
    # turns (bestFittingCluster semantics) → ReSegmentation init --------
    with stage("turn_clustering"):
        world = GmmDiag.load(os.path.join(d, "wld.gmm"))
        xj = jnp.asarray(x_sp)
        mcfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=3.0,
                      nb_train_it=1)
        clusters: list[list[Segment]] = []
        models: list = []

        def turn_llk(seg, model):
            b = int(round(seg.begin / FRAME))
            e = min(int(round(seg.end / FRAME)), len(sp_idx))
            return float(segment_mean_llk(xj, [(b, e)], model)[0])

        for seg in turn_segs:
            wl = turn_llk(seg, world)
            b0 = int(round(seg.begin / FRAME))
            e0 = min(int(round(seg.end / FRAME)), len(sp_idx))
            self_mask = np.zeros(len(sp_idx), np.float32)
            self_mask[b0:e0] = 1.0
            m_self = adapt_model(jax.random.key(99), xj,
                                 jnp.asarray(self_mask), world, mcfg)
            self_v = max(turn_llk(seg, m_self) - wl, 1e-6)
            best, best_v = -1, 0.0
            scores = [turn_llk(seg, m) - wl for m in models]
            if scores:
                best_c = int(np.argmax(scores))
                # join only if the cluster model explains the turn
                # at least 0.65x as well (above world) as the turn's
                # OWN adapted model — an ANY MAP model of speech beats
                # the world on speech, so an unnormalised >0 test
                # collapses everything into one cluster (measured)
                if scores[best_c] > 0.65 * self_v:
                    best, best_v = best_c, scores[best_c]
            if best < 0 and len(clusters) < 5:
                clusters.append([seg])
            else:
                if best < 0:
                    best = int(np.argmax(scores))
                clusters[best].append(seg)
                models.pop(best)
            ci = best if best >= 0 else len(clusters) - 1
            mask = np.zeros(len(sp_idx), np.float32)
            for s2 in clusters[ci]:
                b = int(round(s2.begin / FRAME))
                e = min(int(round(s2.end / FRAME)), len(sp_idx))
                mask[b:e] = 1.0
            m_new = adapt_model(jax.random.key(ci), xj,
                                jnp.asarray(mask), world, mcfg)
            models.insert(ci, m_new)
        turn_lbl = [Segment(s.begin, s.end, f"c{ci}")
                    for ci, cl in enumerate(clusters) for s in cl]
        from lia_ral.io.labels import write_label_file
        write_label_file(os.path.join(d, "convsp.turnclust.lbl"),
                         sorted(turn_lbl, key=lambda s: s.begin))

    with stage("turn_resegmentation"):
        cfg = Config(base)
        cfg["mixtureDistribCount"] = K_UBM
        cfg["inputFeatureFilename"] = "convsp"
        cfg["inputWorldFilename"] = "wld"
        cfg["MAPRegFactorMean"] = 3.0
        cfg["loadLabelFileExtension"] = ".turnclust.lbl"
        cfg["saveLabelFileExtension"] = ".turnreseg.lbl"
        tsegs = reseg_main(cfg)["convsp"]

    hyp_tc = full_timeline(segs_to_frames(
        sorted(turn_lbl, key=lambda s: s.begin), len(sp_idx)))
    res["der_turn_clustering"] = round(der(ref, hyp_tc), 5)
    hyp_tr = full_timeline(segs_to_frames(tsegs, len(sp_idx)))
    res["n_hyp_speakers_turnchain"] = int(len({s.label for s in tsegs}))
    res["der_turn_resegmentation"] = round(der(ref, hyp_tr), 5)
    res["der_turn_resegmentation_collar25"] = round(
        der(ref, hyp_tr, collar_frames=TOL_FRAMES), 5)

    summary = {
        "milestone": "diarization 4-stage end-to-end (SAD + turns + "
                     "E-HMM + reseg, DER on the full timeline)",
        "platform": str(jax.devices()[0]),
        "shapes": {"minutes": MINUTES, "n_speakers": N_SPK,
                   "K_ubm": K_UBM, "D": D_FEAT},
        "results": res,
        "stage_wall_s": mon.stage_walls,
        "stage_records": mon.records,
        "total_wall_s": round(sum(mon.stage_walls.values()), 1),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
