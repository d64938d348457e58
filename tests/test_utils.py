import os

import numpy as np
import pytest

import jax.numpy as jnp

from lia_ral.config import Config
from lia_ral.gmm import GmmDiag
from lia_ral.io.labels import Segment
from lia_ral.io.nist import ScoreLine, read_nist_scores, write_nist_scores
from lia_ral.utils import (NGramModel, confusion_matrix,
                               fuse_label_files, fuse_scores, gmm_tokenize,
                               max_score_identification, ngram_counts,
                               poly_expand, score_warp, scoring_decisions,
                               sequence_decode, time_cluster_filter)
from lia_ral.utils.polyexp import poly_expansion_size


def test_scoring_decisions():
    lines = [ScoreLine("M", "a", "-", "s1", 1.0),
             ScoreLine("M", "b", "-", "s1", -1.0)]
    out = scoring_decisions(lines, 0.0)
    assert [l.decision for l in out] == ["1", "0"]
    ident = max_score_identification(lines)
    assert len(ident) == 1 and ident[0].model == "a"


def test_fuse_scores():
    a = [ScoreLine("M", "m", "-", "s", 1.0)]
    b = [ScoreLine("M", "m", "-", "s", 3.0)]
    out = fuse_scores([a, b], [0.25, 0.75])
    assert out[0].score == pytest.approx(2.5)


def test_score_warp_gaussianises(rng):
    raw = rng.exponential(2.0, 5000)
    warped = score_warp(raw)
    assert abs(warped.mean()) < 0.05
    assert abs(warped.std() - 1.0) < 0.05
    # monotone
    order = np.argsort(raw)
    assert (np.diff(warped[order]) >= -1e-12).all()


def test_poly_expand(rng):
    x = jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)
    e = np.asarray(poly_expand(x))
    assert e.shape == (4, poly_expansion_size(3))
    assert poly_expansion_size(3) == 20
    np.testing.assert_allclose(e[:, 0], 1.0)           # constant term
    np.testing.assert_allclose(e[:, 1], np.asarray(x)[:, 0], rtol=1e-6)
    # last monomial is x2^3 (i=j=k=D)
    np.testing.assert_allclose(e[:, -1], np.asarray(x)[:, 2] ** 3,
                               rtol=1e-5)


def test_gmm_tokenize(rng):
    g = GmmDiag.create(np.ones(2) / 2, np.asarray([[5.0], [-5.0]]),
                       np.ones((2, 1)))
    x = jnp.asarray(np.asarray([[4.9], [-5.1], [5.2]]), jnp.float32)
    syms = gmm_tokenize(x, g)
    np.testing.assert_array_equal(syms, [0, 1, 0])
    cm = confusion_matrix(np.asarray([0, 1, 0]), syms, 2)
    assert cm[0, 0] == 2 and cm[1, 1] == 1


def test_ngram_model_and_decode():
    seq_a = list("ababababab")
    seq_b = list("aabbaabbaabb")
    models = {"A": NGramModel.train([seq_a], 2),
              "B": NGramModel.train([seq_b], 2)}
    best, scores = sequence_decode(list("abababab"), models)
    assert best == "A"
    best2, _ = sequence_decode(list("aabbaabb"), models)
    assert best2 == "B"
    counts = ngram_counts(seq_a, 2)
    assert counts[("a", "b")] == 5


def test_label_fusion_and_timecluster():
    a = [Segment(0.0, 0.10, "speech")]
    b = [Segment(0.12, 0.20, "speech")]
    fused = fuse_label_files([a, b], 30, 0.01, mode="union", close_gap=5)
    assert len(fused) == 1     # gap of 2 frames closed
    assert fused[0].begin == pytest.approx(0.0)
    inter = fuse_label_files([a, b], 30, 0.01, mode="intersection")
    assert inter == []
    kept = time_cluster_filter([Segment(0, 1, "x"), Segment(0, 0.2, "y")],
                               min_duration=0.5)
    assert [s.label for s in kept] == ["x"]


def test_utils_tool_dispatch(tmp_path):
    from lia_ral.tools import utils_tools
    p = str(tmp_path / "in.nist")
    write_nist_scores(p, [ScoreLine("M", "a", "-", "s", 0.7),
                          ScoreLine("M", "b", "-", "s", -0.2)])
    out_p = str(tmp_path / "out.nist")
    cfg = Config({"utilMode": "scoring", "inputFile": p,
                  "outputFile": out_p, "decisionThreshold": 0.0})
    utils_tools.main(cfg)
    back = read_nist_scores(out_p)
    assert [l.decision for l in back] == ["1", "0"]


def test_svm_tool_roundtrip(tmp_path, rng):
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import write_matrix_file
    from lia_ral.tools import utils_tools
    d = str(tmp_path)
    dim = 8
    target_vec = rng.standard_normal(dim) + 3.0
    for i in range(20):
        write_matrix_file(os.path.join(d, f"bg{i}.vect"),
                          rng.standard_normal(dim)[None, :])
    write_matrix_file(os.path.join(d, "tgt.vect"), target_vec[None, :])
    write_matrix_file(os.path.join(d, "probe_t.vect"),
                      (target_vec + rng.standard_normal(dim) * 0.1)[None, :])
    write_matrix_file(os.path.join(d, "probe_i.vect"),
                      rng.standard_normal(dim)[None, :])
    write_xlist(os.path.join(d, "bg.lst"), [[f"bg{i}"] for i in range(20)])
    write_xlist(os.path.join(d, "targets.ndx"), [["tgt", "tgt"]])
    write_xlist(os.path.join(d, "trials.ndx"),
                [["probe_t", "tgt"], ["probe_i", "tgt"]])
    base = {"vectorFilesPath": d + "/", "vectorFilesExtension": ".vect",
            "targetPenalty": 20.0}
    cfg = Config(base)
    cfg["utilMode"] = "svmTrain"
    cfg["backgroundList"] = os.path.join(d, "bg.lst")
    cfg["targetIdList"] = os.path.join(d, "targets.ndx")
    utils_tools.main(cfg)
    cfg2 = Config(base)
    cfg2["utilMode"] = "svmPredict"
    cfg2["ndxFilename"] = os.path.join(d, "trials.ndx")
    cfg2["outputFilename"] = os.path.join(d, "svm.nist")
    res = utils_tools.main(cfg2)
    by_seg = {r.seg: r.score for r in res}
    assert by_seg["probe_t"] > by_seg["probe_i"]


def test_label_ngram(tmp_path):
    from lia_ral.config import Config
    from lia_ral.io.labels import read_label_file
    from lia_ral.tools import utils_tools
    from lia_ral.utils import label_ngram

    # Runs: 1 1 | 2 | 3 3 3 | 2 | 1  → run symbols [1,2,3,2,1]
    syms = [1, 1, 2, 3, 3, 3, 2, 1]
    codebook = [(1, 2, 3), (3, 2, 1)]
    spans = label_ngram(syms, codebook, 3)
    # window (1,2,3) matches tag 1 over frames [0,6); window (2,3,2) is
    # oov; window (3,2,1) matches tag 2 over frames [3,8).
    assert (0, 6, "1") in spans and (3, 8, "2") in spans
    assert not any(lab == "oov" for _, _, lab in spans)
    # Pure-oov stream
    spans2 = label_ngram([9, 9, 8], codebook, 3)
    assert spans2 == [(0, 3, "oov")]

    d = str(tmp_path)
    with open(os.path.join(d, "u1.sym"), "w") as f:
        f.write(" ".join(str(s) for s in syms))
    with open(os.path.join(d, "cb.3gram"), "w") as f:
        f.write("1 2 3 10\n3 2 1 4\n")
    cfg = Config({"utilMode": "labelNgram", "inputFilename": "u1",
                  "NGramFilename": os.path.join(d, "cb.3gram"),
                  "NGramOrder": 3, "symbolPath": d + "/",
                  "labelOutputPath": d + "/"})
    utils_tools.main(cfg)
    out = read_label_file(os.path.join(d, "u1.sym.lbl"))
    assert [s.label for s in out] == ["1", "2"]
