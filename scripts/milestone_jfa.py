"""End-to-end JFA milestone (BASELINE.md config 4: 300ev/100ec + D).

Chains the real CLI tools over a synthetic corpus with separate speaker
(V·y) and channel (U·x) supervector structure:

  ComputeJFAStats → EigenVoice (orthonormalizeV) → EigenChannel →
  EstimateDMatrix → TrainTarget(channelCompensation JFA) →
  ComputeTest(computeTestMode jfa) → EER/minDCF

Reference flow anchors: EigenVoice.cpp:71-163, EigenChannel.cpp:70-200,
EstimateDMatrix.cpp:105-212, TrainTarget.cpp:393-560,
ComputeTest.cpp:376 (ComputeTestJFA).

Usage: python scripts/milestone_jfa.py [--scale small|full] [--out FILE]
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

SCALES = {
    # k: UBM comps, rv/ru: V/U ranks, spk/imp counts, sessions per dev spk
    "small": dict(k=64, d=24, rv=16, ru=8, n_dev=24, n_spk=10, n_imp=5,
                  sess=4, t_utt=600, it_v=6, it_u=6, it_d=3),
    # the V estimate needs dev speakers >> rank_v (a 300-dim eigenvoice
    # space cannot be spanned by 120 speakers — the first full run at
    # n_dev=120 scored EER 0.3 from the rank-deficient V)
    # v_base/u_base: per-dim TOTAL shift std = 4*v_base (speaker) /
    # 2.83*u_base (channel) after rank normalisation in gen_corpus;
    # full is hardened (weak speaker, strong channel, 300-frame tests)
    # so EER grades quality — the rank-normalised corpus at the small
    # scale's 0.6/0.35 anchors saturates at EER 0.0
    "full": dict(k=512, d=39, rv=300, ru=100, n_dev=500, n_spk=40, n_imp=10,
                 sess=4, t_utt=1200, it_v=10, it_u=8, it_d=4,
                 v_base=0.15, u_base=0.9, t_test=300),
    # r5 (VERDICT r4 missing #2): the reference's NIST-scale JFA runs at
    # the K=2048 UBM (ComputeTest.cpp:376 scores frame LLRs against the
    # same UBM family as the i-vector systems); V at 300x2048x39 and
    # the (K,rv,rv) grams (~740 MB) fit one chip — demonstrated here.
    # Utterance lengths scale with K so frames-per-component (the
    # estimation-noise knob) matches the graded K=512 corpus: the first
    # run at t_utt=1200/t_test=300 starved the stats (0.6/0.15 frames
    # per comp) and scored chance (EER 31.8%, minDCF 1.0).  48 s/12 s
    # utterances also match the reference's NIST operating durations
    # (2.5-min conversation sides) far better than 12-s clips did.
    "full2048": dict(k=2048, d=39, rv=300, ru=100, n_dev=500, n_spk=40,
                     n_imp=10, sess=4, t_utt=4800, it_v=10, it_u=8,
                     it_d=4, v_base=0.15, u_base=0.9, t_test=1200),
}


def gen_corpus(d, p, rng):
    """Speaker offsets live in a rank-rv 'voice' subspace, session
    offsets in a rank-ru 'channel' subspace — the JFA generative model
    itself, sampled through a shared diagonal GMM."""
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.io.features import write_feature_file

    k, dim = p["k"], p["d"]
    w = rng.random(k) + 0.5
    w /= w.sum()
    means = rng.standard_normal((k, dim)) * 2.0
    cov = rng.random((k, dim)) * 0.5 + 0.8
    ubm = GmmDiag.create(w, means.astype(np.float32), cov.astype(np.float32))

    # per-ELEMENT scales normalised by rank so the TOTAL speaker/channel
    # shift variance is rank-invariant: at rv the per-dim shift std is
    # scale*sqrt(rv).  r4 root-cause of the full-scale gap: the
    # unnormalised 0.6 gave shift std 0.6*sqrt(300) = 10.4 at rv=300 —
    # speaker offsets dwarfed the UBM (means +-2, cov ~1), the corpus
    # was degenerate (impostor LLRs averaged +12), and no estimator
    # knob (D on/off, scoring mode, it_v, n_dev) moved EER off ~5%.
    # Anchored to the small-scale values (rv=16/ru=8) that behave.
    v_base = p.get("v_base", 0.6)
    u_base = p.get("u_base", 0.35)
    v_true = (rng.standard_normal((p["rv"], k, dim))
              * v_base * np.sqrt(16.0 / p["rv"]))
    u_true = (rng.standard_normal((p["ru"], k, dim))
              * u_base * np.sqrt(8.0 / p["ru"]))

    vy_cache: dict[int, np.ndarray] = {}

    def utt(y, n, spk_id=None):
        # V·y is per-speaker — cache it (the per-utterance einsum was
        # ~2.3 GFlop at full scale × 2000 dev utterances of host numpy)
        if spk_id is not None and spk_id in vy_cache:
            vy = vy_cache[spk_id]
        else:
            vy = np.einsum("r,rkd->kd", y, v_true)
            if spk_id is not None:
                vy_cache[spk_id] = vy
        x_h = rng.standard_normal(p["ru"])
        shift = vy + np.einsum("r,rkd->kd", x_h, u_true)
        comp = rng.choice(k, size=n, p=w)
        x = ((means + shift)[comp]
             + rng.standard_normal((n, dim)) * np.sqrt(cov)[comp])
        return x.astype(np.float32)

    n_all = p["n_dev"] + p["n_spk"] + p["n_imp"]
    ys = rng.standard_normal((n_all, p["rv"]))
    names = {"dev": [], "enroll": [], "test": []}
    for s in range(p["n_dev"]):
        for j in range(p["sess"]):
            nm = f"dev_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(ys[s], p["t_utt"], spk_id=s),
                               fmt="SPRO4")
            names["dev"].append((f"dev{s}", nm))
    for i in range(p["n_spk"] + p["n_imp"]):
        s = p["n_dev"] + i
        tag = f"model{i}" if i < p["n_spk"] else f"imp{i - p['n_spk']}"
        rows = []
        for j in range(2):                      # two enrollment sessions
            nm = f"enr_{tag}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(ys[s], p["t_utt"], spk_id=s),
                               fmt="SPRO4")
            rows.append(nm)
        names["enroll"].append((tag, rows))
        if i < p["n_spk"]:                      # two test sessions each
            for j in range(2):
                nm = f"test_s{i}_{j}"
                write_feature_file(os.path.join(d, nm + ".prm"),
                                   utt(ys[s], p.get("t_test", p["t_utt"] // 2),
                                       spk_id=s),
                                   fmt="SPRO4")
                names["test"].append((i, nm))
    return ubm, names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=list(SCALES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    # --- ablation knobs (round-4 root-cause of the full-scale gap) ---
    ap.add_argument("--noD", action="store_true",
                    help="skip EstimateDMatrix; enroll with V·y only")
    ap.add_argument("--scoring", default="jfa", choices=["jfa", "dot"],
                    help="jfa = channel-compensated frame LLR "
                         "(ComputeTest.cpp:376); dot = supervector "
                         "dot-product (cpp:228)")
    ap.add_argument("--itv", type=int, default=None,
                    help="override V EM iterations")
    ap.add_argument("--ndev", type=int, default=None,
                    help="override dev speaker count")
    args = ap.parse_args()
    p = dict(SCALES[args.scale])
    if args.itv is not None:
        p["it_v"] = args.itv
    if args.ndev is not None:
        p["n_dev"] = args.ndev
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from lia_ral.backend.eval import eer, min_dcf
    from lia_ral.config import Config
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import compute_test, jfa_tools, train_target

    d = args.workdir or tempfile.mkdtemp(prefix="milestone_jfa_")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(20260821)
    from lia_ral.utils.stagemon import StageMonitor
    mon = StageMonitor()
    stage = mon.stage

    with stage("gen_corpus"):
        ubm, names = gen_corpus(d, p, rng)
        ubm.save(os.path.join(d, "wld.gmm"))

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/", "saveVectorFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputWorldFilename": "wld",
        "accsFilename": os.path.join(d, "jfa_accs.npz"),
    }

    write_xlist(os.path.join(d, "dev.ndx"), _group(names["dev"]))

    with stage("eigen_voice"):
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, "dev.ndx")
        cfg["eigenVoiceNumber"] = p["rv"]
        cfg["eigenChannelNumber"] = p["ru"]
        cfg["nbIt"] = p["it_v"]
        cfg["orthonormalizeV"] = "true"
        cfg["eigenVoiceMatrix"] = "EV"
        jfa_tools.eigen_voice_main(cfg)

    with stage("eigen_channel"):
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, "dev.ndx")
        cfg["loadAccs"] = "true"
        cfg["eigenChannelNumber"] = p["ru"]
        cfg["eigenVoiceMatrix"] = "EV"
        cfg["nbIt"] = p["it_u"]
        cfg["eigenChannelMatrix"] = "EC"
        jfa_tools.eigen_channel_main(cfg)

    if not args.noD:
        with stage("estimate_d"):
            cfg = Config(base)
            cfg["ndxFilename"] = os.path.join(d, "dev.ndx")
            cfg["loadAccs"] = "true"
            cfg["eigenVoiceMatrix"] = "EV"
            cfg["eigenChannelMatrix"] = "EC"
            cfg["nbIt"] = p["it_d"]
            cfg["DMatrix"] = "D"
            jfa_tools.estimate_d_matrix_main(cfg)

    with stage("train_target_jfa"):
        write_xlist(os.path.join(d, "targets.ndx"),
                    [[tag] + rows for tag, rows in names["enroll"]])
        cfg = Config(base)
        cfg["targetIdList"] = os.path.join(d, "targets.ndx")
        cfg["channelCompensation"] = "JFA"
        cfg["eigenVoiceMatrix"] = "EV"
        cfg["eigenChannelMatrix"] = "EC"
        if not args.noD:
            cfg["DMatrix"] = "D"
        train_target.main(cfg)

    tgt_models = [t for t, _ in names["enroll"]]
    test_segs = [nm for _, nm in names["test"]]
    with stage("compute_test_jfa"):
        write_xlist(os.path.join(d, "trials.ndx"),
                    [[t] + tgt_models for t in test_segs])
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, "trials.ndx")
        cfg["outputFilename"] = os.path.join(d, "scores_jfa.nist")
        cfg["gender"] = "M"
        cfg["maxTargetLine"] = 1000
        if args.scoring == "dot":
            cfg["computeTestMode"] = "dotProduct"
        else:
            cfg["computeTestMode"] = "jfa"
            cfg["eigenChannelMatrix"] = "EC"
            cfg["topDistribsCount"] = 10
        lines = compute_test.main(cfg)

    tgt, imp = [], []
    for l in lines:
        spk = int(l.seg.split("_s")[1].split("_")[0])
        (tgt if l.model == f"model{spk}" else imp).append(l.score)
    res = {"jfa_eer": eer(np.asarray(tgt), np.asarray(imp)),
           "jfa_mindcf": min_dcf(np.asarray(tgt), np.asarray(imp))}

    import jax
    summary = {
        "milestone": (f"config 4 JFA end-to-end ({args.scale}"
                      + (", noD" if args.noD else "")
                      + (f", scoring={args.scoring}"
                         if args.scoring != "jfa" else "")
                      + (f", itv={args.itv}" if args.itv else "")
                      + (f", ndev={args.ndev}" if args.ndev else "") + ")"),
        "platform": str(jax.devices()[0]),
        "shapes": {"K": p["k"], "D": p["d"], "rank_v": p["rv"],
                   "rank_u": p["ru"], "n_targets": p["n_spk"],
                   "n_trials": len(test_segs) * len(tgt_models)},
        "results": {k: round(float(v), 5) for k, v in res.items()},
        "stage_wall_s": mon.stage_walls,
        "stage_records": mon.records,
        "total_wall_s": round(sum(mon.stage_walls.values()), 1),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


def _group(pairs):
    """[(spk, file)...] → [[spk, f1, f2, ...]] preserving order."""
    by: dict = {}
    for spk, nm in pairs:
        by.setdefault(spk, []).append(nm)
    return [[spk] + files for spk, files in by.items()]


if __name__ == "__main__":
    main()
