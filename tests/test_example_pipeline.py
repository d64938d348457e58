"""The examples/ivector_pipeline .cfg files drive a real end-to-end run.

Builds a tiny synthetic corpus in the example's expected layout
(./data, ./lists, ./models, ./vectors), then executes every stage via
``Config.from_cli(["--config", <cfg>, ...overrides])`` — the exact CLI
contract of the reference binaries (TrainWorldMain.cpp:99-103 config
precedence) — and checks the final NIST score file ranks targets above
impostors."""

import os
import shutil

import numpy as np
import pytest

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "ivector_pipeline")


def test_example_cfgs_run_end_to_end(tmp_path, rng, monkeypatch):
    from lia_ral.config import Config
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools import (iv_extractor, iv_test, norm_feat,
                                   total_variability, train_world)

    for sub in ("data", "lists", "models", "vectors"):
        (tmp_path / sub).mkdir()
    for cfg in os.listdir(EXAMPLE):
        if cfg.endswith(".cfg"):
            shutil.copy(os.path.join(EXAMPLE, cfg), tmp_path / cfg)
    monkeypatch.chdir(tmp_path)

    # tiny corpus: speaker identity in component-weight preference
    k_true, d = 8, 10
    centers = rng.standard_normal((k_true, d)) * 2.5
    spk_w = rng.dirichlet(np.full(k_true, 1.2), size=6)

    def utt(s, n):
        comp = rng.choice(k_true, size=n, p=spk_w[s])
        return (centers[comp]
                + rng.standard_normal((n, d)) * 0.5).astype(np.float32)

    names = []
    for s in range(4):
        for j in range(3):
            nm = f"dev{s}_{j}"
            write_feature_file(f"data/{nm}.prm", utt(s, 300), fmt="SPRO4")
            names.append((f"dspk{s}", nm))
    write_feature_file("data/enroll0.prm", utt(0, 300), fmt="SPRO4")
    write_feature_file("data/test_same.prm", utt(0, 200), fmt="SPRO4")
    write_feature_file("data/test_diff.prm", utt(3, 200), fmt="SPRO4")
    all_names = [nm for _, nm in names] + ["enroll0", "test_same",
                                           "test_diff"]
    with open("lists/all.lst", "w") as f:
        f.write("".join(n + "\n" for n in all_names))
    with open("lists/ubm.lst", "w") as f:
        f.write("".join(nm + "\n" for _, nm in names))
    write_xlist("lists/tv.ndx", [[nm] for _, nm in names])
    write_xlist("lists/all_sessions.ndx", [[n] for n in all_names])
    write_xlist("lists/targets.ndx", [["modelA", "enroll0"]])
    write_xlist("lists/trials.ndx", [["test_same", "modelA"],
                                     ["test_diff", "modelA"]])
    write_xlist("lists/plda_dev.ndx",
                [[spk, nm] for spk, nm in names])

    def run(tool, cfg, *overrides):
        tool.main(Config.from_cli(["--config", cfg, *overrides]))

    run(norm_feat, "00_NormFeat.cfg")
    run(train_world, "01_TrainWorld.cfg",
        "--mixtureDistribCount", "16", "--nbTrainIt", "3")
    run(total_variability, "02_TotalVariability.cfg",
        "--totalVariabilityNumber", "8", "--nbIt", "3")
    run(iv_extractor, "03_IvExtractor.cfg",
        "--totalVariabilityNumber", "8")
    run(iv_test, "04_IvTest_plda.cfg",
        "--pldaEigenVoiceNumber", "4", "--pldaNbIt", "4",
        "--ivNormIterationNb", "1")

    scores = {l.seg: l.score for l in read_nist_scores("scores_plda.nist")}
    assert scores["test_same"] > scores["test_diff"], scores
