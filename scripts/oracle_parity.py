"""North-star parity: the JAX pipeline vs the f64 reference-semantics oracle.

BASELINE.md's target is score/EER parity "vs the reference C++
binaries".  The binaries don't build here (ALIZE is an external
dependency), so `native/oracle` re-implements the reference's
end-to-end math in double precision (see its header for the
reproduced algorithms + file:line anchors).  This driver:

  1. runs the REAL pipeline (CLI tools, f32 on the device) on the calibrated
     small milestone corpus (scripts/milestone_eer.py corpus v2,
     same seed),
  2. exports the shared anchors (normalized features, the init GMM,
     the trained UBM, client models, the T matrix + TV mean),
  3. runs the oracle stage-by-stage AND as an independent end-to-end
     f64 chain from the same init,
  4. reports per-stage deviations and the headline
     ``eer_delta_vs_oracle`` numbers, appending a line to --out.

Stage-isolated comparisons (each consumes the PIPELINE's inputs, so a
deviation pins the stage that produced it):
  em     — oracle EM from the pipeline's init model vs pipeline UBM
  map    — oracle MAP from the pipeline's UBM vs pipeline client models
  score  — oracle top-10 LLR with the pipeline's models vs
           scores_main.nist (per-trial max/mean |Δ|)
  ivec   — oracle BW-stats + exact estimateW with the pipeline's T vs
           the pipeline's i-vectors; raw-cosine trial scores both sides
End-to-end: oracle em → map → score with its OWN f64 artifacts → EER;
``eer_delta_vs_oracle`` = |pipeline EER − oracle EER| (GMM raw path and
i-vector cosine path).

Usage: python scripts/oracle_parity.py [--workdir D] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from milestone_eer import SCALES, gen_corpus

ORACLE = os.path.join(os.path.dirname(__file__), "..", "native", "oracle")


def write_bin(path: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, np.float64)
    with open(path, "wb") as f:
        np.asarray([arr.ndim], np.int64).tofile(f)
        np.asarray(arr.shape, np.int64).tofile(f)
        arr.tofile(f)


def read_bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        nd = int(np.fromfile(f, np.int64, 1)[0])
        dims = np.fromfile(f, np.int64, nd)
        return np.fromfile(f, np.float64).reshape(dims)


def gmm_to_rows(g) -> np.ndarray:
    """(K, 2D+1) oracle model layout: [w, mean, cov]."""
    w = np.asarray(g.weights, np.float64)[:, None]
    mu = np.asarray(g.means, np.float64)
    cov = 1.0 / np.asarray(g.cov_inv, np.float64)
    return np.concatenate([w, mu, cov], axis=1)


def rows_to_arrays(rows: np.ndarray):
    d = (rows.shape[1] - 1) // 2
    return rows[:, 0], rows[:, 1:1 + d], rows[:, 1 + d:]


def rel_dev(a: np.ndarray, b: np.ndarray) -> dict:
    """max/mean relative deviation |a-b| / (|b| + scale)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).mean() + 1e-12
    r = np.abs(a - b) / (np.abs(b) + scale)
    return {"max": float(r.max()), "mean": float(r.mean())}


def abs_dev(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()), "mean": float(d.mean())}


def run_oracle(*args: str) -> None:
    r = subprocess.run([ORACLE, *[str(a) for a in args]],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"oracle {args[0]} failed: {r.stderr[-2000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    from lia_ral.backend.eval import eer
    from lia_ral.config import Config
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.io.features import read_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import read_matrix_file
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools import (compute_test, iv_extractor, norm_feat,
                                   total_variability, train_target,
                                   train_world)
    from lia_ral.tools.iv_norm import load_vectors

    # always invoke make: it is mtime-incremental, and an existing stale
    # binary must never silently stand in for edited oracle math (the
    # binary is gitignored — it is a -march=native build of this host)
    subprocess.run(["make", "-C", os.path.dirname(ORACLE), "oracle"],
                   check=True)

    p = SCALES["small"]
    d = args.workdir or tempfile.mkdtemp(prefix="oracle_parity_")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(20260820)
    t0 = time.perf_counter()
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

    # ---- pipeline (identical to milestone_eer stages) --------------------
    all_files = (["bg"] + [n for _, n in names["dev"]]
                 + [n for _, n in names["enroll"]]
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
    cfg["outputInitWorldFilename"] = "wld_init"
    train_world.main(cfg)

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
    test_segs = [nm for _, nm in names["test"]]
    write_xlist(os.path.join(d, "ndx_main"),
                [[t] + tgt_models for t in test_segs])
    cfg = Config(base)
    cfg["ndxFilename"] = os.path.join(d, "ndx_main")
    cfg["inputWorldFilename"] = "wld"
    cfg["outputFilename"] = os.path.join(d, "scores_main.nist")
    cfg["gender"] = "M"
    cfg["topDistribsCount"] = 10
    compute_test.main(cfg)

    dev_sessions = [nm for _, nm in names["dev"]]
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
    total_variability.main(cfg)

    iv_names = [f for _, f in names["enroll"]] + test_segs
    write_xlist(os.path.join(d, "iv.ndx"), [[n] for n in iv_names])
    cfg = Config(base)
    cfg["ndxFilename"] = os.path.join(d, "iv.ndx")
    cfg["inputWorldFilename"] = "wld"
    cfg["totalVariabilityMatrix"] = "TV"
    cfg["meanEstimate"] = "TVmean"
    iv_extractor.main(cfg)
    t_pipeline = time.perf_counter() - t0

    # ---- exports ---------------------------------------------------------
    t0 = time.perf_counter()
    ob = os.path.join(d, "oracle")
    os.makedirs(ob, exist_ok=True)

    def feats(name: str) -> np.ndarray:
        return np.asarray(read_feature_file(
            os.path.join(d, name + ".norm.prm"), fmt="SPRO4").data,
            np.float64)

    bg = feats("bg")
    write_bin(f"{ob}/bg.bin", bg)
    init = GmmDiag.load(os.path.join(d, "wld_init.gmm"))
    write_bin(f"{ob}/init.bin", gmm_to_rows(init))
    wld = GmmDiag.load(os.path.join(d, "wld.gmm"))
    write_bin(f"{ob}/wld.bin", gmm_to_rows(wld))

    enroll_files = {m: f for m, f in names["enroll"]}
    client_rows = np.stack([gmm_to_rows(GmmDiag.load(
        os.path.join(d, m + ".gmm"))) for m in tgt_models])
    write_bin(f"{ob}/clients_pipeline.bin", client_rows)

    test_x = [feats(nm) for nm in test_segs]
    offsets = np.zeros(len(test_x) + 1, np.float64)
    offsets[1:] = np.cumsum([x.shape[0] for x in test_x])
    write_bin(f"{ob}/test_feats.bin", np.concatenate(test_x))
    write_bin(f"{ob}/test_offsets.bin", offsets)

    t_mat = read_matrix_file(os.path.join(d, "TV.matx"))
    k, dim = p["k"], p["d"]
    write_bin(f"{ob}/T.bin", t_mat.reshape(p["r"], k, dim))
    tv_mean = read_matrix_file(os.path.join(d, "TVmean.matx"))
    write_bin(f"{ob}/TVmean.bin", tv_mean.reshape(k, dim))

    iv_x = [feats(nm) for nm in iv_names]
    iv_off = np.zeros(len(iv_x) + 1, np.float64)
    iv_off[1:] = np.cumsum([x.shape[0] for x in iv_x])
    write_bin(f"{ob}/iv_feats.bin", np.concatenate(iv_x))
    write_bin(f"{ob}/iv_offsets.bin", iv_off)

    # ---- oracle stages ---------------------------------------------------
    # EM (stage-isolated: same init, same data)
    run_oracle("em", f"{ob}/bg.bin", f"{ob}/init.bin", p["ubm_it"],
               1.0, 0.5, 10.0, 5.0, args.threads, f"{ob}/wld_oracle.bin")
    ow_w, ow_mu, ow_cov = rows_to_arrays(read_bin(f"{ob}/wld_oracle.bin"))
    res = {"em_weights": rel_dev(np.asarray(wld.weights), ow_w),
           "em_means": rel_dev(np.asarray(wld.means), ow_mu),
           "em_cov": rel_dev(1.0 / np.asarray(wld.cov_inv), ow_cov)}

    # MAP (stage-isolated: pipeline UBM as prior) + oracle-chain MAP
    chain_rows, map_devs = [], []
    for m in tgt_models:
        write_bin(f"{ob}/enr.bin", feats(enroll_files[m]))
        run_oracle("map", f"{ob}/enr.bin", f"{ob}/wld.bin", 14.0, 3,
                   args.threads, f"{ob}/cl.bin")
        _, cmu, _ = rows_to_arrays(read_bin(f"{ob}/cl.bin"))
        pm = GmmDiag.load(os.path.join(d, m + ".gmm"))
        map_devs.append(rel_dev(np.asarray(pm.means), cmu))
        run_oracle("map", f"{ob}/enr.bin", f"{ob}/wld_oracle.bin", 14.0, 3,
                   args.threads, f"{ob}/cl_chain.bin")
        chain_rows.append(read_bin(f"{ob}/cl_chain.bin"))
    res["map_means"] = {
        "max": max(dv["max"] for dv in map_devs),
        "mean": float(np.mean([dv["mean"] for dv in map_devs]))}
    write_bin(f"{ob}/clients_chain.bin", np.stack(chain_rows))

    # scoring (stage-isolated: pipeline world + pipeline clients)
    run_oracle("score", f"{ob}/wld.bin", f"{ob}/clients_pipeline.bin",
               f"{ob}/test_feats.bin", f"{ob}/test_offsets.bin", 10,
               f"{ob}/llr_isolated.bin")
    llr_oracle = read_bin(f"{ob}/llr_isolated.bin")     # (U, C)
    lines = read_nist_scores(os.path.join(d, "scores_main.nist"))
    mod_idx = {m: i for i, m in enumerate(tgt_models)}
    seg_idx = {s: i for i, s in enumerate(test_segs)}
    llr_pipe = np.zeros_like(llr_oracle)
    for l in lines:
        llr_pipe[seg_idx[l.seg], mod_idx[l.model]] = l.score
    res["score_llr"] = abs_dev(llr_pipe, llr_oracle)

    def to_eer(llr: np.ndarray) -> float:
        tgt, imp = [], []
        for si, seg in enumerate(test_segs):
            spk = int(seg.split("_s")[1].split("_")[0])
            for mi, m in enumerate(tgt_models):
                (tgt if m == f"model{spk}" else imp).append(llr[si, mi])
        return float(eer(np.asarray(tgt), np.asarray(imp)))

    # end-to-end oracle chain: own UBM + own clients
    run_oracle("score", f"{ob}/wld_oracle.bin", f"{ob}/clients_chain.bin",
               f"{ob}/test_feats.bin", f"{ob}/test_offsets.bin", 10,
               f"{ob}/llr_chain.bin")
    llr_chain = read_bin(f"{ob}/llr_chain.bin")
    res["gmm_eer_pipeline"] = to_eer(llr_pipe)
    res["gmm_eer_oracle_chain"] = to_eer(llr_chain)
    res["gmm_eer_delta_vs_oracle"] = abs(res["gmm_eer_pipeline"]
                                         - res["gmm_eer_oracle_chain"])
    res["chain_llr"] = abs_dev(llr_pipe, llr_chain)

    # i-vectors: oracle BW stats + exact estimateW with the pipeline's T
    run_oracle("ivec", f"{ob}/wld.bin", f"{ob}/T.bin", f"{ob}/TVmean.bin",
               f"{ob}/iv_feats.bin", f"{ob}/iv_offsets.bin",
               f"{ob}/w_oracle.bin")
    w_oracle = read_bin(f"{ob}/w_oracle.bin")           # (U, R)
    w_pipe = load_vectors(iv_names, Config(base)).astype(np.float64)
    res["ivector"] = abs_dev(w_pipe, w_oracle)
    res["ivector_norm"] = float(np.abs(w_pipe).mean())

    def cosine_eer(w: np.ndarray) -> float:
        wn = w / np.linalg.norm(w, axis=1, keepdims=True)
        en, te = wn[:len(tgt_models)], wn[len(tgt_models):]
        return to_eer(te @ en.T)

    res["iv_cosine_eer_pipeline"] = cosine_eer(w_pipe)
    res["iv_cosine_eer_oracle"] = cosine_eer(w_oracle)
    res["iv_eer_delta_vs_oracle"] = abs(res["iv_cosine_eer_pipeline"]
                                        - res["iv_cosine_eer_oracle"])
    cs_p = (w_pipe / np.linalg.norm(w_pipe, axis=1, keepdims=True))
    cs_o = (w_oracle / np.linalg.norm(w_oracle, axis=1, keepdims=True))
    res["iv_cosine_scores"] = abs_dev(
        cs_p[len(tgt_models):] @ cs_p[:len(tgt_models)].T,
        cs_o[len(tgt_models):] @ cs_o[:len(tgt_models)].T)
    t_oracle = time.perf_counter() - t0

    import jax
    summary = {
        "milestone": "north-star parity vs f64 reference-semantics oracle",
        "platform": str(jax.devices()[0]),
        "shapes": {"K": p["k"], "D": p["d"], "R": p["r"],
                   "n_trials": len(test_segs) * len(tgt_models),
                   "bg_frames": int(bg.shape[0])},
        "results": res,
        "wall_s": {"pipeline": round(t_pipeline, 1),
                   "oracle": round(t_oracle, 1)},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
