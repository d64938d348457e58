"""End-to-end tool pipeline tests, driven by the reference test fixtures
(copied into tmp at runtime) and the reference's own config files."""

import os
import shutil

import numpy as np
import pytest

from lia_ral.config import Config
from lia_ral.io import read_gmm_file, read_label_file, read_nist_scores
from lia_ral.io.features import read_feature_file, write_feature_file
from lia_ral.io.labels import Segment, write_label_file
from lia_ral.io.lists import write_xlist
from lia_ral.tools import (compute_test, energy_detector, norm_feat,
                               train_target, train_world)
from tests.conftest import REFERENCE, requires_reference

FIX = os.path.join(REFERENCE, "LIA_SpkDet")


@requires_reference
def test_energy_detector_on_reference_fixture(tmp_path):
    """Run the EnergyDetector tool with the reference's own config file on
    the reference's fixture features, compare against the golden label."""
    d = str(tmp_path)
    shutil.copy(os.path.join(FIX, "EnergyDetector/test/test1.prm"), d)
    shutil.copy(os.path.join(FIX, "EnergyDetector/test/test1.lbl"), d)
    cfg = Config.load(os.path.join(FIX, "EnergyDetector/test/EnergyDetector.cfg"))
    for k in ("featureFilesPath", "mixtureFilesPath", "labelFilesPath", "lstPath"):
        cfg[k] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    out = energy_detector.main(cfg)
    got = read_label_file(os.path.join(d, "test1.enr.lbl"))
    golden = read_label_file(os.path.join(
        FIX, "EnergyDetector/test/test1.validate.enr.lbl"))
    # golden: exactly one speech segment 0.21-0.26 inside the 0-0.25 'male'
    # region; EM trajectories differ so require overlap, not identity
    assert len(got) >= 1
    assert all(g.label == "speech" for g in got)
    v0 = golden[0]
    best_overlap = max(min(g.end, v0.end) - max(g.begin, v0.begin)
                       for g in got)
    assert best_overlap > 0, (got, golden)
    del out


@requires_reference
def test_train_world_on_reference_fixture(tmp_path):
    d = str(tmp_path)
    shutil.copy(os.path.join(FIX, "TrainWorld/test/test1.prm"), d)
    shutil.copy(os.path.join(FIX, "TrainWorld/test/test1.lbl"), d)
    write_xlist(os.path.join(d, "seg_app.lst"), [["test1"], ["test1"]])
    cfg = Config.load(os.path.join(FIX, "TrainWorld/test/TrainWorld.cfg"))
    for k in ("featureFilesPath", "mixtureFilesPath", "labelFilesPath", "lstPath"):
        cfg[k] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    cfg["nbTrainIt"] = 5
    world = train_world.main(cfg)
    # golden wld.validate is a 10-comp model from a different cfg; here we
    # check structural parity of our 20-comp result + file round-trip
    w, m, ci = read_gmm_file(os.path.join(d, "wld.gmm"))
    assert w.shape == (20,) and m.shape == (20, 32)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-5)
    assert np.isfinite(m).all() and (ci > 0).all()
    del world


@requires_reference
def test_full_pipeline_train_target_compute_test(tmp_path):
    """TrainWorld → TrainTarget → ComputeTest on synthetic two-speaker data:
    the full reference file-DAG through our tools."""
    d = str(tmp_path)
    rng = np.random.default_rng(7)
    dim, k = 10, 16
    c_a = rng.standard_normal((k, dim)) * 2
    def utt(shift, n):
        return (c_a[rng.integers(0, k, n)] + shift
                + rng.standard_normal((n, dim)) * 0.5).astype(np.float32)
    write_feature_file(os.path.join(d, "bg.prm"), utt(0, 8000), fmt="SPRO4")
    write_feature_file(os.path.join(d, "spk1.prm"), utt(1.0, 2000), fmt="SPRO4")
    write_feature_file(os.path.join(d, "spk2.prm"), utt(-1.0, 2000), fmt="SPRO4")
    write_feature_file(os.path.join(d, "test_spk1.prm"), utt(1.0, 800),
                       fmt="SPRO4")
    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "mixtureDistribCount": k,
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": 5, "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
    }
    cfg = Config(base)
    cfg["inputFeatureFilename"] = "bg"
    cfg["outputWorldFilename"] = "wld"
    train_world.main(cfg)

    write_xlist(os.path.join(d, "trainNdx"),
                [["spk1", "spk1"], ["spk2", "spk2"]])
    tcfg = Config(base)
    tcfg["targetIdList"] = os.path.join(d, "trainNdx")
    tcfg["inputWorldFilename"] = "wld"
    tcfg["MAPAlgo"] = "MAPOccDep"
    tcfg["meanAdapt"] = "true"
    tcfg["MAPRegFactorMean"] = 14.0
    tcfg["nbTrainIt"] = 2
    train_target.main(tcfg)

    write_xlist(os.path.join(d, "testNdx"), [["test_spk1", "spk1", "spk2"]])
    scfg = Config(base)
    scfg["ndxFilename"] = os.path.join(d, "testNdx")
    scfg["inputWorldFilename"] = "wld"
    scfg["outputFilename"] = os.path.join(d, "scores.nist")
    scfg["gender"] = "M"
    scfg["topDistribsCount"] = 10
    compute_test.main(scfg)

    scores = read_nist_scores(os.path.join(d, "scores.nist"))
    assert len(scores) == 2
    by_model = {s.model: s.score for s in scores}
    assert by_model["spk1"] > by_model["spk2"]
    assert by_model["spk1"] > 0


def test_norm_feat_tool(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((300, 8)) * 4 + 7).astype(np.float32)
    write_feature_file(os.path.join(d, "u1.prm"), x, fmt="SPRO4")
    cfg = Config({
        "featureFilesPath": d + "/", "labelFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveFeatureFileFormat": "SPRO4",
        "saveFeatureFileExtension": ".norm.prm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputFeatureFilename": "u1", "mode": "norm",
    })
    norm_feat.main(cfg)
    y = read_feature_file(os.path.join(d, "u1.norm.prm"), fmt="SPRO4").data
    np.testing.assert_allclose(y.mean(0), 0, atol=1e-3)
    np.testing.assert_allclose(y.std(0), 1, atol=1e-2)


@requires_reference
def test_norm_feat_window_on_reference_fixture(tmp_path):
    d = str(tmp_path)
    shutil.copy(os.path.join(FIX, "NormFeat/test/test1.prm"), d)
    cfg = Config({
        "featureFilesPath": d + "/", "labelFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO3", "loadFeatureFileExtension": ".prm",
        "saveFeatureFileFormat": "SPRO4",
        "saveFeatureFileExtension": ".norm.prm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputFeatureFilename": "test1", "mode": "norm",
        "segmentalMode": "window", "windowDuration": 0.2,
    })
    out = norm_feat.main(cfg)
    assert out["test1"].shape == (50, 34)
    assert np.isfinite(out["test1"]).all()


def test_spk_adapt_tool_modes(tmp_path):
    """SpkAdapt CLI: WMAP / REGRESS / Oracle weighting modes + TNORM score
    normalization over a small trial sequence (reference SpkAdaptMain.cpp
    keys WMAP/REGRESS/Oracle/TNORM)."""
    import jax
    import jax.numpy as jnp
    from lia_ral.gmm import TrainCfg, mixture_init, train_model
    from lia_ral.io.nist import ScoreLine, write_nist_scores
    from lia_ral.tools import spk_adapt

    d = str(tmp_path)
    rng = np.random.default_rng(3)
    dim, k = 8, 8
    bg = (rng.standard_normal((6000, dim)) * 2).astype(np.float32)
    xj = jnp.asarray(bg)
    w = jnp.ones(6000, jnp.float32)
    init = mixture_init(jax.random.key(0), xj, w, k)
    world = train_model(jax.random.key(1), xj, w, init,
                        TrainCfg(nb_train_it=3))
    world.save(os.path.join(d, "wld.gmm"))

    def utt(shift, n, name):
        x = (bg[rng.integers(0, 6000, n)] + shift).astype(np.float32)
        write_feature_file(os.path.join(d, name + ".prm"), x, fmt="SPRO4")
    utt(1.5, 1200, "enroll")
    utt(1.5, 600, "t_tar")     # true target trial
    utt(-1.5, 600, "t_imp")    # impostor trial
    write_xlist(os.path.join(d, "targets.ndx"),
                [["spk1", "enroll"]])
    write_xlist(os.path.join(d, "trials.ndx"),
                [["t_tar", "spk1"], ["t_imp", "spk1"]])

    base = dict(featureFilesPath=d + "/", mixtureFilesPath=d + "/",
                labelFilesPath=d + "/", inputWorldFilename="wld",
                targetIdList=os.path.join(d, "targets.ndx"),
                ndxFilename=os.path.join(d, "trials.ndx"),
                loadFeatureFileExtension=".prm",
                addDefaultLabel="true",
                saveMixtureFileFormat="RAW")

    def run(extra, out):
        cfg = Config(dict(base, outputFilename=os.path.join(d, out),
                          **extra))
        return spk_adapt.main(cfg)

    res_wmap = run({}, "wmap.nist")
    assert res_wmap[0].score > res_wmap[1].score  # target > impostor

    res_reg = run({"REGRESS": "true", "THETA": "0", "BETA": "2"},
                  "regress.nist")
    assert res_reg[0].score > res_reg[1].score

    # Oracle mode: ground-truth target list marks only spk1×t_tar
    write_xlist(os.path.join(d, "target_tests.lst"),
                [["spk1", "x", "t_tar"]])
    res_orc = run({"Oracle": "true",
                   "targetTests": os.path.join(d, "target_tests.lst")},
                  "oracle.nist")
    assert res_orc[0].score > res_orc[1].score

    # TNORM mode: impostor res file centred at each test's own score makes
    # both normed scores finite and ordering preserved
    write_nist_scores(os.path.join(d, "imp.res"), [
        ScoreLine("M", "i1", "0", "t_tar", 0.5),
        ScoreLine("M", "i2", "0", "t_tar", -0.5),
        ScoreLine("M", "i1", "0", "t_imp", 0.5),
        ScoreLine("M", "i2", "0", "t_imp", -0.5)])
    res_tn = run({"TNORM": "true",
                  "tnormResFilename": os.path.join(d, "imp.res")},
                 "tnorm.nist")
    assert res_tn[0].score > res_tn[1].score
    assert np.isfinite([r.score for r in res_tn]).all()


@requires_reference
def test_train_world_num_thread_sharded(tmp_path):
    """numThread > 1 maps to data-parallel sharded stats (the reference's
    pthread pool, AccumulateStat.cpp:236) and converges to the same kind
    of model as the serial path."""
    d = str(tmp_path)
    shutil.copy(os.path.join(FIX, "TrainWorld/test/test1.prm"), d)
    shutil.copy(os.path.join(FIX, "TrainWorld/test/test1.lbl"), d)
    cfg = Config.load(os.path.join(FIX, "TrainWorld/test/TrainWorld.cfg"))
    for k in ("featureFilesPath", "mixtureFilesPath", "labelFilesPath",
              "lstPath"):
        cfg[k] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    cfg["inputFeatureFilename"] = "test1"
    cfg["nbTrainIt"] = 3
    cfg["baggedFrameProbability"] = "1.0"
    import numpy as np
    w_serial = train_world.main(cfg)
    cfg["numThread"] = "4"
    cfg["outputWorldFilename"] = "wld_mt"
    w_shard = train_world.main(cfg)
    np.testing.assert_allclose(np.asarray(w_shard.means),
                               np.asarray(w_serial.means),
                               rtol=5e-3, atol=5e-3)


def test_spk_adapt_online_znorm(tmp_path):
    """ZNORM + impCohortFile (SpkAdapt.cpp:146-219): per-model-STATE
    Z-norm — the cohort is re-scored against the CURRENT adapted model
    whenever it changed, so the impostor score distribution stays
    centred as the model absorbs trial data (the drift the reference
    approximates with a frame-count shift table, cpp:717-733)."""
    import jax
    import jax.numpy as jnp
    from lia_ral.backend.unsupervised import online_znorm_params
    from lia_ral.gmm import TrainCfg, mixture_init, train_model
    from lia_ral.tools import spk_adapt

    d = str(tmp_path)
    rng = np.random.default_rng(5)
    dim, k = 8, 8
    bg = (rng.standard_normal((6000, dim)) * 2).astype(np.float32)
    xj = jnp.asarray(bg)
    w = jnp.ones(6000, jnp.float32)
    init = mixture_init(jax.random.key(0), xj, w, k)
    world = train_model(jax.random.key(1), xj, w, init,
                        TrainCfg(nb_train_it=3))
    world.save(os.path.join(d, "wld.gmm"))

    def utt(shift, n, name):
        x = (bg[rng.integers(0, 6000, n)] + shift).astype(np.float32)
        write_feature_file(os.path.join(d, name + ".prm"), x, fmt="SPRO4")
        return x

    utt(1.0, 1200, "enroll")
    for j in range(4):
        utt(1.0, 600, f"t_tar{j}")
    utt(-1.0, 600, "t_imp")
    for c in range(4):
        utt(rng.standard_normal(dim) * 0.8, 500, f"coh{c}")
    with open(os.path.join(d, "cohort.lst"), "w") as f:
        f.write("\n".join(f"coh{c}" for c in range(4)) + "\n")

    # online_znorm_params itself: unadapted model → params match a
    # direct cohort scoring; adapted model → mean shifts
    from lia_ral.io.features import read_feature_file
    zp0 = online_znorm_params(
        world, world,
        jnp.asarray(np.stack([read_feature_file(
            os.path.join(d, f"coh{c}.prm"), fmt="SPRO4").data
            for c in range(4)])),
        jnp.ones((4, 500), jnp.float32))
    assert abs(zp0.mu) < 1e-5          # world vs world → LLR exactly 0
    assert zp0.sigma >= 1e-6

    write_xlist(os.path.join(d, "targets.ndx"), [["spk1", "enroll"]])
    write_xlist(os.path.join(d, "trials.ndx"),
                [[f"t_tar{j}", "spk1"] for j in range(4)]
                + [["t_imp", "spk1"]])
    cfg = Config(dict(
        featureFilesPath=d + "/", mixtureFilesPath=d + "/",
        labelFilesPath=d + "/", inputWorldFilename="wld",
        targetIdList=os.path.join(d, "targets.ndx"),
        ndxFilename=os.path.join(d, "trials.ndx"),
        loadFeatureFileExtension=".prm", addDefaultLabel="true",
        saveMixtureFileFormat="RAW",
        ZNORM="true", impCohortFile=os.path.join(d, "cohort.lst"),
        outputFilename=os.path.join(d, "zn.nist"),
        WMAPtarMean=3.0, WMAPtarStd=1.0, WMAPimpMean=0.0, WMAPimpStd=1.0,
        WMAPtarPrior=0.3))
    res = spk_adapt.main(cfg)
    scores = {ln.seg: ln.score for ln in res}
    # znormed target trials stay well separated from the impostor even
    # as the model adapts (the un-normalised scores drift upward)
    assert min(scores[f"t_tar{j}"] for j in range(4)) > scores["t_imp"]
    # and the final target score is not runaway-inflated: znorm bounds
    # the drift to impostor-sigma units
    assert scores["t_tar3"] < 50.0
