"""End-to-end i-vector pipeline through the CLI tools:
TrainWorld → TotalVariability → IvExtractor → IvNorm → IvTest (+ComputeNorm)
on synthetic multi-speaker data — BASELINE milestone config 3 in miniature."""

import os

import numpy as np
import pytest

from lia_ral.config import Config
from lia_ral.io.features import write_feature_file
from lia_ral.io.lists import write_xlist
from lia_ral.io.nist import read_nist_scores
from lia_ral.backend.eval import eer
from lia_ral.tools import (compute_norm, iv_extractor, iv_norm, iv_test,
                               plda_tool, total_variability, train_world)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ivpipe"))
    rng = np.random.default_rng(11)
    dim, k, rank = 8, 16, 4
    n_spk, sess_per_spk = 12, 3
    centers = rng.standard_normal((k, dim)) * 2
    spk_shift = rng.standard_normal((n_spk, dim)) * 0.8

    def utt(spk, n=400, noise=0.5):
        comp = rng.integers(0, k, n)
        x = centers[comp] + spk_shift[spk] + rng.standard_normal((n, dim)) * noise
        return x.astype(np.float32)

    # background data
    bg = np.concatenate([utt(s) for s in range(n_spk)])
    write_feature_file(os.path.join(d, "bg.prm"), bg, fmt="SPRO4")
    # dev sessions (for TV + norm + plda), enrollment, test
    dev_entries, enroll_entries, test_names = [], [], []
    for s in range(n_spk):
        for j in range(sess_per_spk):
            name = f"dev_s{s}_{j}"
            write_feature_file(os.path.join(d, name + ".prm"), utt(s),
                               fmt="SPRO4")
            dev_entries.append((f"spk{s}", name))
        ename = f"enroll_s{s}"
        write_feature_file(os.path.join(d, ename + ".prm"), utt(s),
                           fmt="SPRO4")
        enroll_entries.append((f"model{s}", ename))
        tname = f"test_s{s}"
        write_feature_file(os.path.join(d, tname + ".prm"), utt(s),
                           fmt="SPRO4")
        test_names.append(tname)

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "saveVectorFilesPath": d + "/", "loadVectorFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "mixtureDistribCount": k,
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": 4, "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
    }
    # 1. UBM
    cfg = Config(base)
    cfg["inputFeatureFilename"] = "bg"
    cfg["outputWorldFilename"] = "wld"
    train_world.main(cfg)
    # 2. TV training on dev sessions
    all_sessions = [name for _, name in dev_entries]
    write_xlist(os.path.join(d, "tv.ndx"), [[n] for n in all_sessions])
    tv = Config(base)
    tv["ndxFilename"] = os.path.join(d, "tv.ndx")
    tv["inputWorldFilename"] = "wld"
    tv["totalVariabilityNumber"] = rank
    tv["totalVariabilityMatrix"] = "TV"
    tv["meanEstimate"] = "TVmean"
    tv["nbIt"] = 4
    tv["initScale"] = 0.5
    tv["accsFilename"] = os.path.join(d, "tv_accs.npz")
    total_variability.main(tv)
    # 3. extract i-vectors for dev + enroll + test
    everything = all_sessions + [e for _, e in enroll_entries] + test_names
    write_xlist(os.path.join(d, "all.ndx"), [[n] for n in everything])
    ext = Config(base)
    ext["ndxFilename"] = os.path.join(d, "all.ndx")
    ext["inputWorldFilename"] = "wld"
    ext["totalVariabilityMatrix"] = "TV"
    ext["meanEstimate"] = "TVmean"
    vecs = iv_extractor.main(ext)
    assert all(np.isfinite(v).all() for v in vecs.values())
    # 4. iv-norm transforms estimated on dev
    write_xlist(os.path.join(d, "dev.ndx"),
                [[spk, name] for spk, name in dev_entries])
    return d, base, enroll_entries, test_names


def _score(d, base, enroll_entries, test_names, mode, extra=None):
    cfg = Config(base)
    write_xlist(os.path.join(d, "targets.ndx"),
                [[m, f] for m, f in enroll_entries])
    write_xlist(os.path.join(d, "trials.ndx"),
                [[t] + [m for m, _ in enroll_entries] for t in test_names])
    cfg["targetIdList"] = os.path.join(d, "targets.ndx")
    cfg["ndxFilename"] = os.path.join(d, "trials.ndx")
    cfg["backgroundNdxFilename"] = os.path.join(d, "dev.ndx")
    cfg["scoreMode"] = mode
    cfg["outputFilename"] = os.path.join(d, f"scores_{mode}.nist")
    for kk, vv in (extra or {}).items():
        cfg[kk] = vv
    results = iv_test.main(cfg)
    tgt, imp = [], []
    for r in results:
        (tgt if r.model == f"model{r.seg.split('_s')[1]}" else imp).append(
            r.score)
    return eer(np.asarray(tgt), np.asarray(imp)), results


def test_cosine_pipeline(pipeline):
    d, base, enroll, tests = pipeline
    e, _ = _score(d, base, enroll, tests, "cosine",
                  {"ivNorm": "true", "ivNormIterationNb": 2})
    assert e < 0.15, e


def test_two_cov_pipeline(pipeline):
    d, base, enroll, tests = pipeline
    e, _ = _score(d, base, enroll, tests, "2cov")
    assert e < 0.15, e


def test_plda_pipeline_and_ztnorm(pipeline):
    d, base, enroll, tests = pipeline
    e, results = _score(d, base, enroll, tests, "plda",
                        {"pldaEigenVoiceNumber": 4, "pldaNbIt": 5,
                         "ivNorm": "true"})
    assert e < 0.15, e
    # zt-norm pass over the produced score file: use the same scores as
    # impostor surrogates (self-consistency smoke test of ComputeNorm)
    cfg = Config(base)
    cfg["normType"] = "ztnorm"
    cfg["testNistFile"] = os.path.join(d, "scores_plda.nist")
    cfg["znormNistFile"] = os.path.join(d, "scores_plda.nist")
    cfg["tnormNistFile"] = os.path.join(d, "scores_plda.nist")
    cfg["ztnormNistFile"] = os.path.join(d, "scores_plda.nist")
    cfg["outputFileBaseName"] = os.path.join(d, "scores_plda_zt.nist")
    out = compute_norm.main(cfg)
    assert len(out) == len(results)
    normed = read_nist_scores(os.path.join(d, "scores_plda_zt.nist"))
    assert all(np.isfinite(l.score) for l in normed)


def test_plda_tool_standalone(pipeline):
    d, base, _, _ = pipeline
    cfg = Config(base)
    cfg["backgroundNdxFilename"] = os.path.join(d, "dev.ndx")
    cfg["pldaEigenVoiceNumber"] = 4
    cfg["pldaEigenChannelNumber"] = 2
    cfg["pldaNbIt"] = 3
    cfg["pldaModelFilename"] = os.path.join(d, "plda_model.npz")
    model = plda_tool.main(cfg)
    assert model.rank_f == 4 and model.rank_g == 2
    assert os.path.isfile(os.path.join(d, "plda_model.npz"))


def test_iv_norm_tool(pipeline):
    d, base, enroll, tests = pipeline
    cfg = Config(base)
    cfg["backgroundNdxFilename"] = os.path.join(d, "dev.ndx")
    cfg["ivNormIterationNb"] = 2
    write_xlist(os.path.join(d, "normin.ndx"), [[t] for t in tests])
    cfg["inputVectorFilename"] = os.path.join(d, "normin.ndx")
    cfg["saveVectorFilesPath"] = d + "/"
    out = iv_norm.main(cfg)
    assert len(out) == len(tests)
    for v in out.values():
        np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-4)


def test_iv_test_load_matrices_and_binary_output(pipeline):
    """2cov scoring: estimate+save matrices, then reload with
    load2covMatrix and binary score output — same decisions
    (IvTest.cpp:243-253, 369-379, 441-465)."""
    d, base, enroll, tests = pipeline
    e1, res1 = _score(d, base, enroll, tests, "2cov",
                      {"ivNorm": "true", "ivNormIterationNb": 2,
                       "TwoCovFilename": "2covtest"})
    assert os.path.isfile(os.path.join(d, "2covtest_W.matx"))
    # reload path: EFR params + 2cov matrices from disk, no dev estimation
    e2, res2 = _score(d, base, enroll, tests, "2cov",
                      {"ivNorm": "true", "ivNormIterationNb": 2,
                       "ivNormLoadParam": "true",
                       "TwoCovFilename": "2covtest",
                       "load2covMatrix": "true",
                       "outputScoreFormat": "binary",
                       "outputFilename": os.path.join(d, "scores_bin")})
    assert os.path.isfile(os.path.join(d, "scores_bin_model.txt"))
    assert os.path.isfile(os.path.join(d, "scores_bin.matx"))
    from lia_ral.io.matrix import read_matrix_file
    mat = read_matrix_file(os.path.join(d, "scores_bin.matx"))
    assert mat.shape == (len(enroll), len(tests))
    assert e2 <= e1 + 0.1


def test_plda_reference_matrix_roundtrip_and_warm_start(pipeline):
    """PLDA saves the reference's five-matrix file set and warm-starts EM
    from them (pldaLoadInitMatrices, PldaTools.cpp:2074-2108)."""
    d, base, enroll, tests = pipeline
    cfg = Config(base)
    cfg["backgroundNdxFilename"] = os.path.join(d, "dev.ndx")
    cfg["pldaEigenVoiceNumber"] = 3
    cfg["pldaNbIt"] = 3
    cfg["pldaModelFilename"] = os.path.join(d, "plda_ref.npz")
    m1 = plda_tool.main(cfg)
    for name in ("pldaMeanVec", "pldaEigenVoiceMatrix", "pldaSigmaMatrix",
                 "pldaMinDivMean"):
        assert os.path.isfile(os.path.join(d, name + ".matx")), name
    from lia_ral.backend.plda import PldaModel
    back = PldaModel.load_reference(
        os.path.join(d, "pldaMeanVec.matx"),
        os.path.join(d, "pldaEigenVoiceMatrix.matx"), None,
        os.path.join(d, "pldaSigmaMatrix.matx"))
    np.testing.assert_allclose(np.asarray(back.f), np.asarray(m1.f),
                               atol=1e-6)
    # warm start: one more EM iteration from the saved matrices
    cfg["pldaLoadInitMatrices"] = "true"
    cfg["pldaEigenVoiceMatrixInit"] = "pldaEigenVoiceMatrix"
    cfg["pldaSigmaMatrixInit"] = "pldaSigmaMatrix"
    cfg["pldaMeanVecInit"] = "pldaMeanVec"
    cfg["pldaNbIt"] = 1
    m2 = plda_tool.main(cfg)
    assert np.isfinite(np.asarray(m2.f)).all()
