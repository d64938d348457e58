"""JFA tool pipeline: ComputeJFAStats → EigenVoice → EigenChannel →
EstimateDMatrix through the file DAG (BASELINE milestone config 4 in
miniature)."""

import os

import numpy as np
import pytest

from lia_ral.config import Config
from lia_ral.io.features import write_feature_file
from lia_ral.io.lists import write_xlist
from lia_ral.io.matrix import read_matrix_file
from lia_ral.tools import jfa_tools, train_world


def test_jfa_tool_pipeline(tmp_path, rng):
    d = str(tmp_path)
    dim, k = 6, 8
    n_spk, sess = 6, 3
    centers = rng.standard_normal((k, dim)) * 2
    spk_shift = rng.standard_normal((n_spk, dim)) * 0.7

    def utt(s, n=300):
        comp = rng.integers(0, k, n)
        return (centers[comp] + spk_shift[s]
                + rng.standard_normal((n, dim)) * 0.5).astype(np.float32)

    write_feature_file(os.path.join(d, "bg.prm"),
                       np.concatenate([utt(s) for s in range(n_spk)]),
                       fmt="SPRO4")
    lines = []
    for s in range(n_spk):
        files = []
        for j in range(sess):
            nm = f"s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"), utt(s),
                               fmt="SPRO4")
            files.append(nm)
        lines.append([f"spk{s}"] + files)
    write_xlist(os.path.join(d, "jfa.ndx"), lines)

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
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
        "ndxFilename": os.path.join(d, "jfa.ndx"),
        "inputWorldFilename": "wld",
        "accsFilename": os.path.join(d, "jfa_accs.npz"),
    }
    cfg = Config({k_: v_ for k_, v_ in base.items()
                  if k_ != "inputWorldFilename"})
    cfg["inputFeatureFilename"] = "bg"
    cfg["outputWorldFilename"] = "wld"
    train_world.main(cfg)

    st = Config(base)
    st["jfaMode"] = "stats"
    jfa_tools.main(st)
    assert os.path.isfile(os.path.join(d, "jfa_accs.npz"))

    ev = Config(base)
    ev["jfaMode"] = "eigenVoice"
    ev["loadAccs"] = "true"
    ev["eigenVoiceNumber"] = 2
    ev["nbIt"] = 5
    ev["eigenVoiceMatrix"] = "EV"
    ev["initScale"] = 0.3
    jfa_tools.main(ev)
    v = read_matrix_file(os.path.join(d, "EV.matx"))
    assert v.shape == (2, k * dim)
    assert np.isfinite(v).all() and np.abs(v).mean() > 1e-4

    ec = Config(base)
    ec["jfaMode"] = "eigenChannel"
    ec["loadAccs"] = "true"
    ec["eigenChannelNumber"] = 2
    ec["nbIt"] = 4
    ec["eigenVoiceMatrix"] = "EV"
    ec["eigenChannelMatrix"] = "EC"
    ec["initScale"] = 0.3
    jfa_tools.main(ec)
    u = read_matrix_file(os.path.join(d, "EC.matx"))
    assert u.shape == (2, k * dim)

    dm = Config(base)
    dm["jfaMode"] = "estimateD"
    dm["loadAccs"] = "true"
    dm["eigenVoiceMatrix"] = "EV"
    dm["eigenChannelMatrix"] = "EC"
    dm["DMatrix"] = "D"
    dm["nbIt"] = 3
    jfa_tools.main(dm)
    dmat = read_matrix_file(os.path.join(d, "D.matx"))
    assert dmat.shape == (1, k * dim)
    assert np.isfinite(dmat).all()
