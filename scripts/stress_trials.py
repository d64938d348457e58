"""Trial-scoring throughput at NIST volume through the ComputeTest CLI.

1000 test segments × 64 target models = 64,000 GMM-UBM top-10 trials
through the real tool (batched line dispatch, parallel native loader,
persistent compile cache).  The reference scores this list line-by-line
with per-frame scalar loops; the record here is trials/s end-to-end
including feature IO.

Usage: python scripts/stress_trials.py [--out FILE] [--k 512]
       [--n-tests 1000] [--n-models 64] [--t-utt 1000]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--d", type=int, default=39)
    ap.add_argument("--n-tests", type=int, default=1000)
    ap.add_argument("--n-models", type=int, default=64)
    ap.add_argument("--t-utt", type=int, default=1000)
    args = ap.parse_args()

    import jax
    from lia_ral.config import Config
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import compute_test

    d = tempfile.mkdtemp(prefix="stress_trials_")
    rng = np.random.default_rng(1)
    k, dim = args.k, args.d
    w = rng.random(k) + 0.5
    w /= w.sum()
    means = rng.standard_normal((k, dim)).astype(np.float32) * 2
    cov = (rng.random((k, dim)) * 0.5 + 0.8).astype(np.float32)
    ubm = GmmDiag.from_cov(w, means, cov)
    ubm.save(os.path.join(d, "wld.gmm"))
    for m in range(args.n_models):
        off = rng.standard_normal((k, dim)).astype(np.float32) * 0.2
        GmmDiag.from_cov(w, means + off, cov).save(
            os.path.join(d, f"model{m}.gmm"), model_id=f"model{m}")

    t0 = time.perf_counter()
    test_names = []
    for i in range(args.n_tests):
        comp = rng.integers(0, k, args.t_utt)
        x = (means[comp]
             + rng.standard_normal((args.t_utt, dim)).astype(np.float32)
             * np.sqrt(cov)[comp])
        nm = f"t{i}"
        write_feature_file(os.path.join(d, nm + ".prm"), x, fmt="SPRO4")
        test_names.append(nm)
    gen_s = time.perf_counter() - t0
    models = [f"model{m}" for m in range(args.n_models)]
    write_xlist(os.path.join(d, "trials.ndx"),
                [[t] + models for t in test_names])

    cfg = Config({
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "ndxFilename": os.path.join(d, "trials.ndx"),
        "inputWorldFilename": "wld",
        "outputFilename": os.path.join(d, "scores.nist"),
        "gender": "M", "topDistribsCount": 10,
        "maxTargetLine": 10000,
    })
    t0 = time.perf_counter()
    lines = compute_test.main(cfg)
    score_s = time.perf_counter() - t0
    n_trials = len(lines)
    summary = {
        "milestone": "trial-throughput stress (ComputeTest top-10)",
        "platform": str(jax.devices()[0]),
        "shapes": {"K": k, "D": dim, "n_tests": args.n_tests,
                   "n_models": args.n_models, "t_utt": args.t_utt,
                   "n_trials": n_trials},
        "results": {
            "trials_per_s": round(n_trials / score_s, 1),
            "audio_s_per_s_scored": round(
                args.n_tests * args.t_utt / 100.0 / score_s, 1),
        },
        "stage_wall_s": {"gen_corpus": round(gen_s, 2),
                         "compute_test": round(score_s, 2)},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
