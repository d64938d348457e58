"""LFA engine, TopGauss cache, and ComputeTest variant modes."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.config import Config
from lia_ral.fa.jfa import JfaStats
from lia_ral.fa.lfa import (compensate_features, compensate_model,
                                estimate_channel, lfa_model, lfa_train)
from lia_ral.fa.stats import bw_stats_batch
from lia_ral.fa.topgauss import TopGauss, compute_topgauss, topgauss_llk
from lia_ral.gmm import GmmDiag
from lia_ral.gmm.kernels import frame_llk


def random_gmm(rng, k=8, d=5):
    w = rng.random(k) + 0.5
    w /= w.sum()
    return GmmDiag.create(w, rng.standard_normal((k, d)) * 2,
                          rng.random((k, d)) * 0.5 + 0.8)


def test_topgauss_cache_roundtrip(tmp_path, rng):
    gmm = random_gmm(rng)
    x = jnp.asarray(rng.standard_normal((50, 5)), jnp.float32)
    tg = compute_topgauss(x, gmm, top=4)
    # reconstructed full llk == direct llk
    np.testing.assert_allclose(tg.frame_llk(),
                               np.asarray(frame_llk(x, gmm)),
                               rtol=1e-4, atol=1e-4)
    p = str(tmp_path / "tg.npz")
    tg.save(p)
    tg2 = TopGauss.load(p)
    np.testing.assert_array_equal(tg.indices, tg2.indices)
    # topgauss_llk with the same model ≈ full llk
    llk = np.asarray(topgauss_llk(x, gmm, tg2))
    np.testing.assert_allclose(llk, np.asarray(frame_llk(x, gmm)),
                               rtol=1e-4, atol=1e-4)


def test_lfa_channel_compensation(rng):
    k, d, ru = 6, 4, 2
    gmm = random_gmm(rng, k, d)
    u_true = rng.standard_normal((ru, k, d)) * 0.8
    # sessions of one speaker with different channel offsets
    n_sess, frames = 10, 400
    xs, x_true = [], []
    for _ in range(n_sess):
        xh = rng.standard_normal(ru)
        shift = np.einsum("r,rkd->kd", xh, u_true)
        comp = rng.integers(0, k, frames)
        xs.append((np.asarray(gmm.means) + shift)[comp]
                  + rng.standard_normal((frames, d)) / np.sqrt(
                      np.asarray(gmm.cov_inv))[comp])
        x_true.append(xh)
    feats = jnp.asarray(np.stack(xs), jnp.float32)
    sess = bw_stats_batch(feats, jnp.ones(feats.shape[:2]), gmm)
    stats = JfaStats.from_sessions(sess, np.zeros(n_sess, np.int64), 1)
    model = lfa_train(jax.random.key(0), stats, gmm, ru, nb_it=6, tau=50.0)
    # estimated channel factors span the true channel space
    x_est = estimate_channel(sess, model)
    xh = np.asarray(x_est)
    cc = np.linalg.svd(np.linalg.qr(xh)[0].T
                       @ np.linalg.qr(np.stack(x_true))[0],
                       compute_uv=False)
    assert cc.min() > 0.7, cc
    # feature compensation moves frames back toward the clean model:
    # llk under the UBM increases after compensation
    x0 = feats[0]
    comp_feats = compensate_features(x0, gmm, model, x_est[0])
    llk_before = float(jnp.mean(frame_llk(x0, gmm)))
    llk_after = float(jnp.mean(frame_llk(comp_feats, gmm)))
    assert llk_after > llk_before
    # model compensation shifts means by Ux
    m2 = compensate_model(gmm, model, x_est[0])
    assert not np.allclose(np.asarray(m2.means), np.asarray(gmm.means))


@pytest.fixture()
def trial_setup(tmp_path, rng):
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import train_target, train_world
    d = str(tmp_path)
    dim, k = 6, 8
    centers = rng.standard_normal((k, dim)) * 2

    def utt(shift, n=600):
        comp = rng.integers(0, k, n)
        return (centers[comp] + shift
                + rng.standard_normal((n, dim)) * 0.5).astype(np.float32)

    write_feature_file(os.path.join(d, "bg.prm"), utt(0, 4000), fmt="SPRO4")
    write_feature_file(os.path.join(d, "spk1.prm"), utt(0.8), fmt="SPRO4")
    write_feature_file(os.path.join(d, "spk2.prm"), utt(-0.8), fmt="SPRO4")
    write_feature_file(os.path.join(d, "test1.prm"), utt(0.8, 400),
                       fmt="SPRO4")
    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech", "mixtureDistribCount": k,
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": 3, "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
    }
    cfg = Config(base)
    cfg["inputFeatureFilename"] = "bg"
    cfg["outputWorldFilename"] = "wld"
    train_world.main(cfg)
    write_xlist(os.path.join(d, "targets.ndx"),
                [["spk1", "spk1"], ["spk2", "spk2"]])
    tcfg = Config(base)
    tcfg["targetIdList"] = os.path.join(d, "targets.ndx")
    tcfg["inputWorldFilename"] = "wld"
    tcfg["MAPAlgo"] = "MAPOccDep"
    tcfg["meanAdapt"] = "true"
    tcfg["MAPRegFactorMean"] = 14.0
    train_target.main(tcfg)
    write_xlist(os.path.join(d, "trials.ndx"), [["test1", "spk1", "spk2"]])
    base["ndxFilename"] = os.path.join(d, "trials.ndx")
    base["inputWorldFilename"] = "wld"
    return d, base


def _run_mode(d, base, mode, extra=None):
    from lia_ral.tools import compute_test
    cfg = Config(base)
    cfg["computeTestMode"] = mode
    cfg["outputFilename"] = os.path.join(d, f"scores_{mode}.nist")
    for k_, v_ in (extra or {}).items():
        cfg[k_] = v_
    return compute_test.main(cfg)


def test_dot_product_mode(trial_setup):
    d, base = trial_setup
    res = _run_mode(d, base, "dotProduct")
    by = {r.model: r.score for r in res}
    assert by["spk1"] > by["spk2"]


def test_nap_mode(trial_setup, rng):
    from lia_ral.io.matrix import write_matrix_file
    d, base = trial_setup
    u = np.linalg.qr(rng.standard_normal((48, 2)))[0].T
    write_matrix_file(os.path.join(d, "nap.matx"), u)
    res = _run_mode(d, base, "nap", {"napMatrix": os.path.join(d, "nap.matx")})
    by = {r.model: r.score for r in res}
    assert by["spk1"] > by["spk2"]


def test_by_label_mode(trial_setup):
    d, base = trial_setup
    res = _run_mode(d, base, "byLabel")
    assert all(r.seg.startswith("test1.") for r in res)
    by = {r.model: r.score for r in res}
    assert by["spk1"] > by["spk2"]


def test_histo_mode(trial_setup):
    d, base = trial_setup
    res = _run_mode(d, base, "histo", {"scoreType": "mean"})
    by = {r.model: r.score for r in res}
    assert by["spk1"] > by["spk2"]
    res_e = _run_mode(d, base, "histo", {"scoreType": "entropy"})
    assert all(np.isfinite(r.score) for r in res_e)


def test_lfa_mode(trial_setup, rng):
    from lia_ral.io.matrix import write_matrix_file
    d, base = trial_setup
    # a small random channel matrix (rank 2 over K*D=48)
    u = rng.standard_normal((2, 48)) * 0.01
    write_matrix_file(os.path.join(d, "EC.matx"), u)
    res = _run_mode(d, base, "lfa", {"eigenChannelMatrix": "EC"})
    by = {r.model: r.score for r in res}
    assert by["spk1"] > by["spk2"]
