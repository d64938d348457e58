"""Milestone config 5 (BASELINE.md): i-vector + 150-dim G-PLDA with
IvNorm on a sharded trial set.

Drives the real IvTest CLI twice over the same 400-dim i-vector corpus:
once single-device, once with numThread=8 (PLDA EM session-sharded over
a ("data",) device mesh — PldaTools.cpp:2647's pthread pool as
shard_map+psum), asserts score equality, and reports EER/minDCF.
Runs on the 8-virtual-device CPU mesh (the multi-host harness shape) or
any platform with ≥2 devices.

Reference anchors: PLDA.cpp:74-99 (train flow), PldaTools.cpp:2647
(threaded E-step), 4061 (threaded scoring), IvTest.cpp:73-706.

Usage: python scripts/milestone_plda.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# corpus v2 (r4): rank-normalised speaker scale so per-dim speaker std
# (f_scale*sqrt(plda)) ~ 0.37 vs within-speaker noise 0.7 — the old
# f_scale=0.9 per ELEMENT gave speaker std ~11 and a saturated EER 0.0;
# dev enlarged so the 400-dim full-cov Sigma is estimable, and 200
# target trials give 0.5% EER resolution
P = dict(r=400, plda=150, n_dev=300, dev_sess=6, n_spk=50, n_imp=0,
         tests_per_spk=4, f_scale=0.03, noise=0.7)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default="cpu",
                    help="cpu (8 virtual devices) or empty for default")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax

    from lia_ral.backend.eval import eer, min_dcf
    from lia_ral.config import Config
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import write_matrix_file
    from lia_ral.tools import iv_test

    d = tempfile.mkdtemp(prefix="milestone_plda_")
    rng = np.random.default_rng(20260822)
    from lia_ral.utils.stagemon import StageMonitor
    mon = StageMonitor()
    stage = mon.stage

    # ---- synthetic i-vector corpus with speaker/channel structure ------
    r, rank = P["r"], P["plda"]
    with stage("gen_vectors"):
        f_true = rng.standard_normal((r, rank)) * P["f_scale"]
        def spk_vecs(h, n):
            return (f_true @ h + rng.standard_normal((n, r)) * P["noise"]
                    ).astype(np.float32)
        dev_rows = []
        for s in range(P["n_dev"]):
            h = rng.standard_normal(rank)
            names = []
            for j in range(P["dev_sess"]):
                nm = f"dev{s}_{j}"
                write_matrix_file(os.path.join(d, nm + ".vect"),
                                  spk_vecs(h, 1)[0][None, :])
                names.append(nm)
            dev_rows.append([f"dspk{s}"] + names)
        enroll_rows, trial_rows, truth = [], [], {}
        test_names = []
        for s in range(P["n_spk"]):
            h = rng.standard_normal(rank)
            nm = f"enr{s}"
            write_matrix_file(os.path.join(d, nm + ".vect"),
                              spk_vecs(h, 1)[0][None, :])
            enroll_rows.append([f"model{s}", nm])
            for j in range(P["tests_per_spk"]):
                tn = f"tst{s}_{j}"
                write_matrix_file(os.path.join(d, tn + ".vect"),
                                  spk_vecs(h, 1)[0][None, :])
                test_names.append(tn)
                truth[tn] = s
        models = [m for m, _ in enroll_rows]
        for tn in test_names:
            trial_rows.append([tn] + models)
        write_xlist(os.path.join(d, "dev.ndx"), dev_rows)
        write_xlist(os.path.join(d, "targets.ndx"), enroll_rows)
        write_xlist(os.path.join(d, "trials.ndx"), trial_rows)

    base = {
        "loadVectorFilesPath": d + "/", "saveVectorFilesPath": d + "/",
        "matrixFilesPath": d + "/",
        "vectorFilesExtension": ".vect",
        "targetIdList": os.path.join(d, "targets.ndx"),
        "ndxFilename": os.path.join(d, "trials.ndx"),
        "backgroundNdxFilename": os.path.join(d, "dev.ndx"),
        "scoreMode": "plda",
        "ivNorm": "true", "ivNormIterationNb": 2,
        "pldaEigenVoiceNumber": rank, "pldaNbIt": 6,
        "gender": "M",
    }

    def run(tag, n_thread):
        cfg = Config(base)
        cfg["outputFilename"] = os.path.join(d, f"scores_{tag}.nist")
        cfg["numThread"] = n_thread
        return iv_test.main(cfg)

    with stage("plda_serial"):
        ser = run("serial", 1)
    with stage("plda_sharded_8dev"):
        shd = run("sharded", 8)

    s_ser = {(l.model, l.seg): l.score for l in ser}
    s_shd = {(l.model, l.seg): l.score for l in shd}
    max_dev = max(abs(s_ser[k] - s_shd[k]) for k in s_ser)
    scale = max(abs(v) for v in s_ser.values())

    tgt, imp = [], []
    for l in shd:
        spk = truth[l.seg]
        (tgt if l.model == f"model{spk}" else imp).append(l.score)
    res = {
        "plda_eer": eer(np.asarray(tgt), np.asarray(imp)),
        "plda_mindcf": min_dcf(np.asarray(tgt), np.asarray(imp)),
        "sharded_vs_serial_max_dev": max_dev,
        "sharded_vs_serial_rel": max_dev / max(scale, 1e-9),
    }
    assert res["sharded_vs_serial_rel"] < 1e-3, res

    summary = {
        "milestone": "config 5 sharded PLDA trial run",
        "platform": f"{jax.devices()[0].platform} x{len(jax.devices())}",
        "shapes": {"R": r, "plda_rank": rank,
                   "n_dev_speakers": P["n_dev"],
                   "n_targets": P["n_spk"],
                   "n_trials": len(test_names) * len(models)},
        "results": {k: round(float(v), 6) for k, v in res.items()},
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
