"""End-to-end EER milestone driver (BASELINE.md configs 1→3).

Runs the COMPLETE file-DAG through the real CLI tools on synthetic
NIST-SRE-style data, on whatever jax platform is active:

  GMM-UBM path : CMVN (NormFeat, one batched call) → TrainWorld →
                 TrainTarget → ComputeTest (top-10) → ComputeNorm
                 (ztnorm) → EER/minDCF
  i-vector path: TotalVariability → IvExtractor → IvNorm(EFR) →
                 IvTest (cosine + PLDA) → EER/minDCF

Usage:  python scripts/milestone_eer.py [--scale small|full]
            [--tier default|fastStats|fastMath]
            [--ivApprox exact|eigenDecomposition] [--out FILE]

The corpus is calibrated so EER GRADES quality (round-3 verdict weak #1:
the old corpus saturated at EER 0.0 for every tier/mode).  Hardness
knobs live in SCALES: short test utterances, weak per-speaker mean
offsets + near-uniform weight signatures, strong per-session channel,
and >=200 target trials so EER resolution is <=0.5%.

--scale full is the BASELINE milestone shape (K=2048, D=39, R=400,
PLDA rank 150); small is a minutes-scale smoke version of the same DAG.
Emits one JSON line per stage (wall time) and a summary JSON; appends a
line to --out.  Each run records the persistent-compile-cache entry
count at start and a cold|warm label derived from it, so stage walls
are comparable across records (round-3 verdict weak #2).
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
    # model shapes: K, D, R(tv), plda_rank
    # corpus: n_spk(targets), n_imp, dev sessions/spk, frames per
    #   train/dev utt (t_utt), frames per test utt (t_test), test utts
    #   per target (n_test), background frames (bg)
    # hardness: spk_off (per-speaker component-mean offset sigma),
    #   chan (per-session channel offset sigma), noise (frame noise
    #   sigma), alpha (Dirichlet concentration of per-speaker weights:
    #   higher = weaker phonotactic signature)
    "small": dict(k=256, d=24, r=64, plda=32, n_spk=20, n_imp=10,
                  n_dev=100, sess=6, t_utt=600, t_test=300, n_test=10,
                  bg=120_000, ubm_it=4, tv_it=4,
                  spk_off=0.12, chan=0.45, chan_comp=0.18, noise=0.65,
                  alpha=5.0),
    # r5: dev population raised 250x8 -> 300x10 sessions (3000 dev
    # vectors = 20x the PLDA rank) so the PLDA column resolves above
    # its EM noise (VERDICT r4 weak #3); PLDA additionally reports the
    # median of 3 EM init seeds
    "full": dict(k=2048, d=39, r=400, plda=150, n_spk=40, n_imp=12,
                 n_dev=300, sess=10, t_utt=1200, t_test=300, n_test=6,
                 bg=500_000, ubm_it=6, tv_it=5,
                 spk_off=0.08, chan=0.45, chan_comp=0.25, noise=0.65,
                 alpha=8.0),
}


def gen_corpus(d, p, rng, with_dev=True):
    """Synthetic NIST-SRE-style corpus over a shared mixture bed.

    Speaker identity lives in the distribution SHAPE — per-speaker
    component weights (phonotactic preference) plus small per-speaker
    component-mean offsets — NOT in a global mean shift, which
    file-level CMVN would remove exactly.  Sessions add a channel
    offset + noise.  Calibrated hard (see module docstring)."""
    from lia_ral.io.features import write_feature_file

    k, dim = 64, p["d"]
    centers = rng.standard_normal((k, dim)) * 2.0
    # targets, impostors, then a DISJOINT dev population: the PLDA/EFR/
    # TV dev set must not contain the evaluation speakers (NIST
    # protocol), or the backend is graded on memorised identities
    n_all = p["n_spk"] + p["n_imp"] + p["n_dev"]
    spk_weights = rng.dirichlet(np.full(k, p["alpha"]), size=n_all)
    spk_offsets = rng.standard_normal((n_all, k, dim)) * p["spk_off"]

    def utt(spk, n):
        comp = rng.choice(k, size=n, p=spk_weights[spk])
        chan = rng.standard_normal(dim) * p["chan"]
        # per-session per-COMPONENT channel: survives file-level CMVN
        # (which removes the global offset exactly) and confounds with
        # the per-speaker component offsets — this is what keeps the
        # i-vector/PLDA EER off the 0.0 floor (round-3 verdict weak #1)
        chan_c = rng.standard_normal((k, dim)) * p["chan_comp"]
        x = (centers[comp] + spk_offsets[spk, comp] + chan + chan_c[comp]
             + rng.standard_normal((n, dim)) * p["noise"])
        return x.astype(np.float32)

    names = {"dev": [], "enroll": [], "test": [], "imp_enroll": [],
             "imp_test": []}
    write_feature_file(os.path.join(d, "bg.prm"),
                       np.concatenate([utt(s % n_all, p["bg"] // n_all + 1)
                                       for s in range(n_all)])[:p["bg"]],
                       fmt="SPRO4")
    for s in range(p["n_dev"] if with_dev else 0):
        for j in range(p["sess"]):
            nm = f"dev_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(p["n_spk"] + p["n_imp"] + s, p["t_utt"]),
                               fmt="SPRO4")
            names["dev"].append((f"spk{s}", nm))
    for s in range(p["n_spk"]):
        nm = f"enroll_s{s}"
        write_feature_file(os.path.join(d, nm + ".prm"), utt(s, p["t_utt"]),
                           fmt="SPRO4")
        names["enroll"].append((f"model{s}", nm))
        for j in range(p["n_test"]):
            nm = f"test_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(s, p["t_test"]), fmt="SPRO4")
            names["test"].append((s, nm))
    for s in range(p["n_imp"]):
        nm = f"imp_enroll_{s}"
        write_feature_file(os.path.join(d, nm + ".prm"),
                           utt(p["n_spk"] + s, p["t_utt"]), fmt="SPRO4")
        names["imp_enroll"].append((f"imp{s}", nm))
        for j in range(2):
            nm = f"imp_test_{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(p["n_spk"] + s, p["t_test"]),
                               fmt="SPRO4")
            names["imp_test"].append(nm)
    return names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=list(SCALES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--tier", default="default",
                    choices=["default", "fastStats", "fastMath"],
                    help="numerics tier for the GMM statistics "
                         "(fastStats = bf16 S/F sums with f32 "
                         "occupancies; fastMath = bf16 densities)")
    ap.add_argument("--ivApprox", default="exact",
                    choices=["exact", "eigenDecomposition"],
                    help="i-vector extraction mode (IvExtractor.cpp:253 "
                         "eigen-decomposition approximation)")
    args = ap.parse_args()
    p = SCALES[args.scale]

    from lia_ral.backend.eval import eer, min_dcf
    from lia_ral.config import Config
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools import (compute_norm, compute_test, iv_extractor,
                                   iv_test, norm_feat, total_variability,
                                   train_target, train_world)

    d = args.workdir or tempfile.mkdtemp(prefix="milestone_")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(20260820)
    # per-stage wall + compile-activity records (utils/stagemon.py)
    from lia_ral.utils.stagemon import StageMonitor, cache_entries
    cache0 = cache_entries()
    mon = StageMonitor()
    stage = mon.stage

    with stage("device_warmup"):
        # absorb device start-up into its own visible stage instead of
        # polluting the first real stage's wall
        import jax.numpy as jnp
        (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()

    with stage("gen_corpus"):
        names = gen_corpus(d, p, rng)

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "saveVectorFilesPath": d + "/", "loadVectorFilesPath": d + "/",
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
    if args.tier == "fastStats":
        base["fastStats"] = "true"
    elif args.tier == "fastMath":
        base["fastMath"] = "true"

    # ---- CMVN over every feature file: ONE batched NormFeat call ---------
    # (the reference streams per file with zero compile cost, NormFeat.cpp
    # :231; here dispatch is amortised by passing the whole corpus as a
    # list — norm_feat buckets/batches internally)
    all_files = (["bg"] + [n for _, n in names["dev"]]
                 + [n for _, n in names["enroll"]]
                 + [n for _, n in names["test"]]
                 + [n for _, n in names["imp_enroll"]] + names["imp_test"])
    with stage("normfeat_cmvn"):
        with open(os.path.join(d, "allfeat.lst"), "w") as f:
            f.write("\n".join(all_files) + "\n")
        cfg = Config(base)
        cfg["loadFeatureFileExtension"] = ".prm"
        cfg["saveFeatureFileFormat"] = "SPRO4"
        cfg["saveFeatureFileExtension"] = ".norm.prm"
        cfg["inputFeatureFilename"] = os.path.join(d, "allfeat.lst")
        cfg["mode"] = "norm"
        norm_feat.main(cfg)

    # ---- GMM-UBM path ----------------------------------------------------
    with stage("train_world"):
        cfg = Config(base)
        cfg["inputFeatureFilename"] = "bg"
        cfg["outputWorldFilename"] = "wld"
        train_world.main(cfg)

    with stage("train_target"):
        rows = ([[m, f] for m, f in names["enroll"]]
                + [[m, f] for m, f in names["imp_enroll"]])
        write_xlist(os.path.join(d, "targets.ndx"), rows)
        cfg = Config(base)
        cfg["targetIdList"] = os.path.join(d, "targets.ndx")
        cfg["inputWorldFilename"] = "wld"
        cfg["MAPAlgo"] = "MAPOccDep"
        cfg["meanAdapt"] = "true"
        cfg["MAPRegFactorMean"] = 14.0
        cfg["nbTrainIt"] = 3
        train_target.main(cfg)

    tgt_models = [m for m, _ in names["enroll"]]
    imp_models = [m for m, _ in names["imp_enroll"]]
    test_segs = [nm for _, nm in names["test"]]

    def run_ct(tag, segs, models):
        write_xlist(os.path.join(d, f"ndx_{tag}"),
                    [[t] + models for t in segs])
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, f"ndx_{tag}")
        cfg["inputWorldFilename"] = "wld"
        cfg["outputFilename"] = os.path.join(d, f"scores_{tag}.nist")
        cfg["gender"] = "M"
        cfg["topDistribsCount"] = 10
        compute_test.main(cfg)

    with stage("compute_test"):
        run_ct("main", test_segs, tgt_models)
    with stage("compute_test_cohorts"):
        # znorm: target models × impostor segments (per-model stats);
        # tnorm: impostor models × test segments (per-segment stats)
        run_ct("znorm", names["imp_test"], tgt_models)
        run_ct("tnorm", test_segs, imp_models)
        run_ct("ztnorm", names["imp_test"], imp_models)

    def split_scores(lines):
        tgt, imp = [], []
        for l in lines:
            spk = int(l.seg.split("_s")[1].split("_")[0])
            (tgt if l.model == f"model{spk}" else imp).append(l.score)
        return np.asarray(tgt), np.asarray(imp)

    raw = read_nist_scores(os.path.join(d, "scores_main.nist"))
    t, i = split_scores(raw)
    res = {"gmm_raw_eer": eer(t, i), "gmm_raw_mindcf": min_dcf(t, i)}

    with stage("compute_norm_ztnorm"):
        cfg = Config(base)
        cfg["normType"] = "ztnorm"
        cfg["testNistFile"] = os.path.join(d, "scores_main.nist")
        cfg["znormNistFile"] = os.path.join(d, "scores_znorm.nist")
        cfg["tnormNistFile"] = os.path.join(d, "scores_tnorm.nist")
        cfg["ztnormNistFile"] = os.path.join(d, "scores_ztnorm.nist")
        cfg["outputFileBaseName"] = os.path.join(d, "scores_zt.nist")
        compute_norm.main(cfg)
    zt = read_nist_scores(os.path.join(d, "scores_zt.nist"))
    t, i = split_scores(zt)
    res["gmm_ztnorm_eer"] = eer(t, i)
    res["gmm_ztnorm_mindcf"] = min_dcf(t, i)

    # ---- i-vector path ---------------------------------------------------
    dev_sessions = [nm for _, nm in names["dev"]]
    with stage("total_variability"):
        write_xlist(os.path.join(d, "tv.ndx"), [[n] for n in dev_sessions])
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, "tv.ndx")
        cfg["inputWorldFilename"] = "wld"
        cfg["totalVariabilityNumber"] = p["r"]
        cfg["totalVariabilityMatrix"] = "TV"
        cfg["meanEstimate"] = "TVmean"
        cfg["nbIt"] = p["tv_it"]
        cfg["initScale"] = 0.5
        cfg["accsFilename"] = os.path.join(d, "tv_accs.npz")
        if args.ivApprox == "eigenDecomposition":
            cfg["approximationMode"] = "eigenDecomposition"
        total_variability.main(cfg)

    with stage("iv_extractor"):
        everything = (dev_sessions + [f for _, f in names["enroll"]]
                      + test_segs)
        write_xlist(os.path.join(d, "all.ndx"), [[n] for n in everything])
        cfg = Config(base)
        cfg["ndxFilename"] = os.path.join(d, "all.ndx")
        cfg["inputWorldFilename"] = "wld"
        cfg["totalVariabilityMatrix"] = "TV"
        cfg["meanEstimate"] = "TVmean"
        if args.ivApprox == "eigenDecomposition":
            cfg["ivExtractionMode"] = "eigenDecomposition"
        iv_extractor.main(cfg)

    write_xlist(os.path.join(d, "dev.ndx"),
                [[spk, nm] for spk, nm in names["dev"]])
    write_xlist(os.path.join(d, "iv_targets.ndx"),
                [[m, f] for m, f in names["enroll"]])
    write_xlist(os.path.join(d, "iv_trials.ndx"),
                [[t] + tgt_models for t in test_segs])

    def iv_score(mode, extra, tag):
        cfg = Config(base)
        cfg["targetIdList"] = os.path.join(d, "iv_targets.ndx")
        cfg["ndxFilename"] = os.path.join(d, "iv_trials.ndx")
        cfg["backgroundNdxFilename"] = os.path.join(d, "dev.ndx")
        cfg["scoreMode"] = mode
        cfg["outputFilename"] = os.path.join(d, f"scores_iv_{tag}.nist")
        for kk, vv in extra.items():
            cfg[kk] = vv
        lines = iv_test.main(cfg)
        t, i = split_scores(lines)
        return eer(t, i), min_dcf(t, i)

    with stage("iv_test_cosine"):
        res["iv_cosine_eer"], res["iv_cosine_mindcf"] = iv_score(
            "cosine", {"ivNorm": "true", "ivNormIterationNb": 2}, "cos")
    with stage("iv_test_plda"):
        # median of 3 PLDA EM init seeds: rank-150 EM from finite dev
        # data is the noisiest stage of the table (VERDICT r4 weak #3);
        # the median + recorded spread make the tier-table PLDA column
        # readable above that noise
        plda_runs = [iv_score(
            "plda", {"ivNorm": "true", "ivNormIterationNb": 2,
                     "pldaEigenVoiceNumber": p["plda"], "pldaNbIt": 5,
                     "randomSeed": seed}, f"plda_s{seed}")
            for seed in (0, 1, 2)]
        eers = sorted(e for e, _ in plda_runs)
        dcfs = sorted(c for _, c in plda_runs)
        res["iv_plda_eer"] = eers[1]
        res["iv_plda_mindcf"] = dcfs[1]
        res["iv_plda_eer_seed_spread"] = eers[-1] - eers[0]
        res["iv_plda_eer_seeds"] = eers

    import jax
    n_trials = len(test_segs) * len(tgt_models)
    summary = {
        "milestone": (f"configs 1-3 end-to-end ({args.scale}, corpus v2"
                      + (f", {args.tier}" if args.tier != "default" else "")
                      + (f", ivApprox={args.ivApprox}"
                         if args.ivApprox != "exact" else "") + ")"),
        "platform": str(jax.devices()[0]),
        "shapes": {"K": p["k"], "D": p["d"], "R": p["r"],
                   "plda_rank": p["plda"], "n_targets": p["n_spk"],
                   "n_trials": n_trials,
                   "n_target_trials": len(test_segs)},
        "tier": args.tier, "iv_approx": args.ivApprox,
        "cache_entries_at_start": cache0,
        "label": "warm" if cache0 > 0 else "cold",
        "results": {k: ([round(float(x), 5) for x in v]
                        if isinstance(v, (list, tuple))
                        else round(float(v), 5)) for k, v in res.items()},
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
