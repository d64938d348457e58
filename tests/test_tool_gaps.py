"""Round-2 tool-surface gaps (VERDICT.md item 6): TrainTarget NAP/SV
output, NormFeat featNAP, ModelToSv normSv, CovIntra CLI, ComputeTest
skipExistingOutput, HTK feature format."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from lia_ral.config import Config
from lia_ral.gmm.model import GmmDiag
from lia_ral.io.features import read_feature_file, write_feature_file
from lia_ral.io.gmm_io import write_gmm_file
from lia_ral.io.matrix import read_matrix_file, write_matrix_file


def _mk_gmm(rng, k=8, d=4):
    w = rng.random(k) + 0.1
    w /= w.sum()
    m = rng.standard_normal((k, d))
    ci = rng.random((k, d)) + 0.5
    return w, m, ci


def test_htk_feature_roundtrip(tmp_path, rng):
    x = rng.standard_normal((40, 13)).astype(np.float32)
    p = str(tmp_path / "u.htk")
    write_feature_file(p, x, fmt="HTK", rate=100.0)
    ff = read_feature_file(p, fmt="HTK")
    np.testing.assert_array_equal(ff.data, x)
    assert ff.rate == pytest.approx(100.0)
    # header sanity: big-endian nSamples/sampSize
    raw = open(p, "rb").read()
    assert int.from_bytes(raw[0:4], "big") == 40
    assert int.from_bytes(raw[8:10], "big") == 13 * 4


def test_model_to_sv_norm_sv(tmp_path, rng):
    """normSv multiplies by √(w·covInv) of the UBM (getMeanNorm,
    ModelToSvMain.cpp:58-68); weightSv norm = 1/√w (cpp:70-75)."""
    from lia_ral.tools.utils_tools import model_to_sv_main

    d = str(tmp_path)
    w, m, ci = _mk_gmm(rng)
    write_gmm_file(os.path.join(d, "ubm.gmm"), w, m, ci)
    write_gmm_file(os.path.join(d, "cl.gmm"), w, m + 1.0, ci)
    base = {"mixtureFilesPath": d + "/", "loadMixtureFileExtension": ".gmm",
            "vectorFilesPath": d + "/", "vectorFilesExtension": ".vect",
            "inputModelFilename": "cl", "inputWorldFilename": "ubm"}
    cfg = Config(dict(base, meanSv="true", normSv="true"))
    out = model_to_sv_main(cfg)
    expect = (m + 1.0).ravel() * np.sqrt((w[:, None] * ci).ravel())
    np.testing.assert_allclose(out["cl"], expect, rtol=1e-6)
    back = read_matrix_file(os.path.join(d, "cl.vect")).ravel()
    np.testing.assert_allclose(back, expect, rtol=1e-6)
    cfg2 = Config(dict(base, weightSv="true", meanSv="false", normSv="true"))
    out2 = model_to_sv_main(cfg2)
    np.testing.assert_allclose(out2["cl"], w / np.sqrt(w), rtol=1e-6)


def test_cov_intra_cli(tmp_path, rng):
    """CovIntra CLI: session .vect list → NAP matrix file; the trained
    subspace captures the within-speaker (channel) direction."""
    from lia_ral.tools.utils_tools import cov_intra_main

    d = str(tmp_path)
    dim = 16
    channel = rng.standard_normal(dim)
    channel /= np.linalg.norm(channel)
    names = []
    with open(os.path.join(d, "ndx"), "w") as f:
        for spk in range(4):
            base = rng.standard_normal(dim) * 3
            line = []
            for sess in range(5):
                n = f"s{spk}_{sess}"
                v = base + channel * rng.standard_normal() * 2.0 \
                    + rng.standard_normal(dim) * 0.01
                write_matrix_file(os.path.join(d, n + ".vect"), v[None, :])
                line.append(n)
                names.append(n)
            f.write(" ".join(line) + "\n")
    cfg = Config({"utilMode": "covIntra", "ndx": os.path.join(d, "ndx"),
                  "vectorFilesPath": d + "/", "vectorFilesExtension": ".vect",
                  "nbEigenVectors": 1,
                  "channelMatrix": os.path.join(d, "U.mat")})
    nap = cov_intra_main(cfg)
    assert nap.shape == (1, dim)
    u = read_matrix_file(os.path.join(d, "U.mat"))
    np.testing.assert_allclose(u, nap, rtol=1e-6)
    # the leading within-class eigenvector ≈ the planted channel direction
    assert abs(float(np.dot(u[0], channel))) > 0.99


def test_train_target_nap_and_sv_output(tmp_path, rng):
    """TrainTarget optional NAP (TrainTarget.cpp:154-157) and
    outputAdaptParam supervector output (cpp:158-169)."""
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import train_target

    d = str(tmp_path)
    k, dim = 8, 6
    w, m, ci = _mk_gmm(rng, k, dim)
    write_gmm_file(os.path.join(d, "wld.gmm"), w, m, ci)
    x = (m[rng.integers(0, k, 500)] + 0.3
         + rng.standard_normal((500, dim)) * 0.3).astype(np.float32)
    write_feature_file(os.path.join(d, "spk1.prm"), x, fmt="SPRO4")
    write_xlist(os.path.join(d, "ndx"), [["spk1", "spk1"]])
    u = np.zeros((2, k * dim))
    u[0, 0], u[1, 1] = 1.0, 1.0
    write_matrix_file(os.path.join(d, "U.mat"), u)
    base = {"featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
            "labelFilesPath": d + "/",
            "loadFeatureFileFormat": "SPRO4",
            "loadFeatureFileExtension": ".prm",
            "loadMixtureFileExtension": ".gmm",
            "saveMixtureFileExtension": ".gmm",
            "addDefaultLabel": "true", "defaultLabel": "speech",
            "labelSelectedFrames": "speech",
            "targetIdList": os.path.join(d, "ndx"),
            "inputWorldFilename": "wld", "MAPAlgo": "MAPOccDep",
            "meanAdapt": "true", "nbTrainIt": 1}
    # NAP: adapted supervector has zero components along U rows
    cfg = Config(dict(base, NAP="true",
                      NAPChannelMatrix=os.path.join(d, "U.mat")))
    out = train_target.main(cfg)
    sv = np.asarray(out["spk1"].means).ravel()
    assert abs(sv[0]) < 1e-5 and abs(sv[1]) < 1e-5
    # outputAdaptParam: writes a KL supervector .vect, not a model
    cfg2 = Config(dict(base, outputAdaptParam="true",
                       saveVectorFilesPath=d + "/",
                       vectorFilesExtension=".vect", superVector="KL"))
    out2 = train_target.main(cfg2)
    sv_file = read_matrix_file(os.path.join(d, "spk1.vect")).ravel()
    expect = (np.asarray(out2["spk1"].means).ravel()
              * np.sqrt((w[:, None] * ci).ravel()))
    np.testing.assert_allclose(sv_file, expect, rtol=2e-4, atol=1e-5)


def test_norm_feat_nap_mode(tmp_path, rng):
    """normFeatNAP: x −= γ(x)·(UᵀU·sv_ubm reshaped) per frame
    (NormFeat.cpp:724, featureChannelCompNAP cpp:213-229)."""
    from lia_ral.backend.supervector import model_to_sv, project_on_subspace
    from lia_ral.gmm.kernels import llk_and_posteriors
    from lia_ral.tools import norm_feat

    d = str(tmp_path)
    k, dim = 6, 5
    w, m, ci = _mk_gmm(rng, k, dim)
    write_gmm_file(os.path.join(d, "wld.gmm"), w, m, ci)
    x = (m[rng.integers(0, k, 200)]
         + rng.standard_normal((200, dim)) * 0.4).astype(np.float32)
    write_feature_file(os.path.join(d, "u1.prm"), x, fmt="SPRO4")
    u = rng.standard_normal((3, k * dim)).astype(np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    write_matrix_file(os.path.join(d, "U.mat"), u)
    cfg = Config({
        "mode": "featNAP", "featureFilesPath": d + "/",
        "labelFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveFeatureFileFormat": "SPRO4", "saveFeatureFileExtension": ".n.prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputFeatureFilename": "u1", "inputWorldFilename": "wld",
        "initChannelMatrix": os.path.join(d, "U.mat"),
    })
    out = norm_feat.main(cfg)
    gmm = GmmDiag.create(w, m, ci)
    offset = np.asarray(project_on_subspace(
        model_to_sv(gmm), jnp.asarray(u, jnp.float32))).reshape(k, dim)
    _, occ = llk_and_posteriors(jnp.asarray(x), gmm)
    expect = x - np.asarray(occ) @ offset
    np.testing.assert_allclose(out["u1"], expect, rtol=2e-4, atol=2e-4)


def test_compute_test_skip_existing_output(tmp_path):
    from lia_ral.tools import compute_test

    d = str(tmp_path)
    out_p = os.path.join(d, "scores.nist")
    with open(out_p, "w") as f:
        f.write("M spk1 1 seg1 2.5\n")
    cfg = Config({"outputFilename": out_p, "skipExistingOutput": "true",
                  "ndxFilename": "/nonexistent"})
    res = compute_test.main(cfg)   # must not touch the missing ndx
    assert len(res) == 1 and res[0].score == 2.5


def test_compute_test_warns_and_continues_on_bad_line(tmp_path, rng, capsys):
    """A missing test segment or missing model must not abort the NDX run
    (reference per-line alize::Exception catch; TrainWorld.cpp:187-189)."""
    import jax
    from lia_ral.gmm import TrainCfg, mixture_init, train_model
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import compute_test

    d = str(tmp_path)
    dim, k = 6, 4
    x = (rng.standard_normal((2000, dim)) * 2).astype(np.float32)
    xj = jnp.asarray(x)
    w = jnp.ones(2000, jnp.float32)
    world = train_model(jax.random.key(0), xj, w,
                        mixture_init(jax.random.key(1), xj, w, k),
                        TrainCfg(nb_train_it=2))
    world.save(os.path.join(d, "wld.gmm"))
    world.save(os.path.join(d, "spk1.gmm"))
    write_feature_file(os.path.join(d, "seg1.prm"), x[:300], fmt="SPRO4")
    # line 1: missing feature file; line 2: good seg, one missing model
    write_xlist(os.path.join(d, "ndx"),
                [["missing_seg", "spk1"], ["seg1", "ghost", "spk1"]])
    cfg = Config({
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "ndxFilename": os.path.join(d, "ndx"),
        "inputWorldFilename": "wld",
        "outputFilename": os.path.join(d, "scores.nist"),
    })
    res = compute_test.main(cfg)
    outtxt = capsys.readouterr().out
    assert "missing_seg" in outtxt and "ghost" in outtxt
    assert len(res) == 1 and res[0].model == "spk1" and res[0].seg == "seg1"
