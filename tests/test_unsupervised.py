import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.backend.unsupervised import (UnsupervisedAdapter, windowed_llr,
                                              wmap, wmap_gmm)
from lia_ral.gmm import (GmmDiag, MapCfg, TrainCfg, mixture_init,
                             train_model)
from lia_ral.gmm.em import reduce_model, train_model_streams
from lia_ral.gmm.map_adapt import compute_mllr
from lia_ral.gmm.kernels import em_stats
from lia_ral.gmm.em import m_step


def test_wmap_posterior_behaviour():
    scores = np.asarray([-3.0, 0.0, 3.0])
    p = wmap(scores, tar_mean=2.0, tar_std=1.0, imp_mean=-2.0, imp_std=1.0,
             prior_tar=0.5)
    assert p[0] < 0.1 and p[2] > 0.9
    assert 0.3 < p[1] < 0.7
    # GMM-based variant agrees for single-component models
    tar = GmmDiag.create(np.ones(1), np.asarray([[2.0]]), np.ones((1, 1)))
    imp = GmmDiag.create(np.ones(1), np.asarray([[-2.0]]), np.ones((1, 1)))
    pg = wmap_gmm(scores, tar, imp, prior_tar=0.5)
    np.testing.assert_allclose(pg, p, atol=1e-4)


def test_windowed_llr():
    llr = np.r_[np.zeros(50), np.ones(50)]
    starts, means = windowed_llr(llr, window=20, step=10)
    assert means[0] == 0.0 and means[-1] == 1.0
    assert starts[0] == 0 and starts[-1] == 80
    # too-short input
    s, m = windowed_llr(np.ones(5), 10, 5)
    assert s.size == 0


def test_unsupervised_adapter_improves(rng):
    d, k = 4, 8
    centers = rng.standard_normal((k, d)) * 2
    spk = rng.standard_normal(d)

    def utt(shift, n=800):
        comp = rng.integers(0, k, n)
        return jnp.asarray(centers[comp] + shift
                           + rng.standard_normal((n, d)) * 0.5, jnp.float32)

    bg = utt(0.0, 6000)
    w = jnp.ones(bg.shape[0], jnp.float32)
    init = mixture_init(jax.random.key(0), bg, w, k, 1.0)
    world = train_model(jax.random.key(1), bg, w, init, TrainCfg(nb_train_it=3))
    ad = UnsupervisedAdapter(world=world,
                             map_cfg=MapCfg(method="MAPOccDep",
                                            mean_adapt=True, mean_r=14.0))
    enroll = utt(spk, 300)    # short enrollment
    ad.enroll(enroll, jnp.ones(300))
    test = utt(spk, 500)
    s_before = ad.score(test, jnp.ones(500))
    # feed several matched trials with high WMAP weight
    for _ in range(3):
        ad.process_trial(utt(spk, 500), jnp.ones(500), 0.9)
    s_after = ad.score(test, jnp.ones(500))
    assert s_after > s_before


def test_mllr_shifts_means_toward_data(rng):
    d, k = 3, 4
    world = GmmDiag.create(np.ones(k) / k, rng.standard_normal((k, d)),
                           np.ones((k, d)))
    x = jnp.asarray(np.asarray(world.means)[rng.integers(0, k, 2000)] + 1.5
                    + rng.standard_normal((2000, d)) * 0.3, jnp.float32)
    st = em_stats(x, jnp.ones(2000), world)
    em_model = m_step(st)
    adapted, w_mat = compute_mllr(world, em_model, st.count)
    assert w_mat.shape == (d, d + 1)
    # adapted means closer to the shifted data than the world's
    d_world = np.abs(np.asarray(world.means) + 1.5
                     - np.asarray(em_model.means)).mean()
    d_mllr = np.abs(np.asarray(adapted.means)
                    - np.asarray(em_model.means)).mean()
    assert d_mllr < np.abs(np.asarray(world.means)
                           - np.asarray(em_model.means)).mean()
    del d_world


def test_reduce_model():
    g = GmmDiag.create(np.asarray([0.5, 0.3, 0.15, 0.05]),
                       np.arange(8).reshape(4, 2).astype(float),
                       np.ones((4, 2)))
    r = reduce_model(g, 2)
    assert r.n_components == 2
    np.testing.assert_allclose(float(jnp.sum(r.weights)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r.weights),
                               [0.625, 0.375], rtol=1e-5)


def test_train_model_streams(rng):
    d, k = 3, 4
    x1 = jnp.asarray(rng.standard_normal((1000, d)) + 2, jnp.float32)
    x2 = jnp.asarray(rng.standard_normal((1000, d)) - 2, jnp.float32)
    w = jnp.ones(1000, jnp.float32)
    init = mixture_init(jax.random.key(0),
                        jnp.concatenate([x1, x2]),
                        jnp.ones(2000, jnp.float32), k, 1.0)
    cfg = TrainCfg(nb_train_it=3)
    # heavily weight stream 1 → model mass concentrates near +2
    gmm = train_model_streams(jax.random.key(1), [(x1, w), (x2, w)],
                              [10.0, 0.1], init, cfg)
    mean_of_means = float(jnp.sum(gmm.weights[:, None] * gmm.means) / d)
    assert mean_of_means > 0.5, mean_of_means


def test_window_llr_compute_test_mode(tmp_path, rng):
    from lia_ral.config import Config
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.tools import compute_test, train_target, train_world
    d = str(tmp_path)
    dim, k = 4, 8
    centers = rng.standard_normal((k, dim)) * 2

    def utt(shift, n):
        comp = rng.integers(0, k, n)
        return (centers[comp] + shift
                + rng.standard_normal((n, dim)) * 0.5).astype(np.float32)

    write_feature_file(os.path.join(d, "bg.prm"), utt(0, 3000), fmt="SPRO4")
    write_feature_file(os.path.join(d, "spk1.prm"), utt(1.0, 800),
                       fmt="SPRO4")
    # test file: half spk1, half impostor
    write_feature_file(os.path.join(d, "test1.prm"),
                       np.concatenate([utt(1.0, 300), utt(-1.0, 300)]),
                       fmt="SPRO4")
    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
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
    write_xlist(os.path.join(d, "t.ndx"), [["spk1", "spk1"]])
    tcfg = Config(base)
    tcfg["targetIdList"] = os.path.join(d, "t.ndx")
    tcfg["inputWorldFilename"] = "wld"
    tcfg["MAPAlgo"] = "MAPOccDep"
    tcfg["meanAdapt"] = "true"
    tcfg["MAPRegFactorMean"] = 14.0
    train_target.main(tcfg)
    write_xlist(os.path.join(d, "trials.ndx"), [["test1", "spk1"]])
    scfg = Config(base)
    scfg["ndxFilename"] = os.path.join(d, "trials.ndx")
    scfg["inputWorldFilename"] = "wld"
    scfg["outputFilename"] = os.path.join(d, "win.nist")
    scfg["windowLLR"] = "true"
    scfg["windowLLRSize"] = 100
    scfg["windowLLRDec"] = 100
    res = compute_test.main(scfg)
    assert len(res) == 6     # 600 frames / 100
    # first windows (target half) score higher than last windows
    assert np.mean([r.score for r in res[:3]]) > \
        np.mean([r.score for r in res[3:]])


# ---------------------------------------------------------------------------
# UnsupervisedTools completion (UnsupervisedTools.cpp:847-1757)
# ---------------------------------------------------------------------------

def test_expand_llr_logistic():
    from lia_ral.backend.unsupervised import expand_llr
    s = np.asarray([-5.0, 0.0, 5.0])
    p = expand_llr(s, theta=0.0, beta=1.0)
    assert p[0] < 0.01 and abs(p[1] - 0.5) < 1e-9 and p[2] > 0.99
    # beta scales steepness, theta shifts
    assert expand_llr(np.asarray([1.0]), theta=-1.0, beta=1.0)[0] == \
        pytest.approx(0.5)


def test_compute_priors_sequence():
    from lia_ral.backend.unsupervised import compute_priors
    dec = np.asarray([0.0, 2.0, -1.0, 3.0])  # elt 0 = enrollment
    pt, pi = compute_priors(dec, init_prior_tar=1.0, init_prior_imp=1.0,
                            optimal_score=0.5)
    assert pt[1] == pytest.approx(2 / 3)       # one target seen
    assert pt[2] == pytest.approx(2 / 4)       # then one impostor
    assert pt[3] == pytest.approx(3 / 5)
    np.testing.assert_allclose(pt + pi, 1.0)


def test_oracle_modes():
    from lia_ral.backend.unsupervised import oracle
    tt = [("spk1", "t1"), ("spk2", "t9")]
    assert oracle("spk1", "t1", 2.0, tt) == 1.0
    assert oracle("spk1", "t2", 2.0, tt) == 0.0
    tar = GmmDiag.create(np.ones(1), np.asarray([[2.0]]), np.ones((1, 1)))
    imp = GmmDiag.create(np.ones(1), np.asarray([[-2.0]]), np.ones((1, 1)))
    wv = oracle("spk1", "t1", 2.0, tt, wmap_type=True, classical_type=False,
                tar=tar, imp=imp)
    assert 0.9 < wv <= 1.0   # WMAP posterior of a high score


def test_tnorm_cache_and_normalize():
    from lia_ral.backend.unsupervised import (load_tnorm_param,
                                                  normalize_score)
    res = [("imp1", "tA", 1.0), ("imp2", "tA", 3.0),
           ("imp1", "tB", -1.0), ("imp2", "tB", 1.0)]
    cache = load_tnorm_param(["tA", "tB"], res)
    assert cache["tA"].mu == pytest.approx(2.0)
    assert cache["tA"].sigma == pytest.approx(1.0)
    assert normalize_score("tA", 4.0, cache) == pytest.approx(2.0)
    assert normalize_score("unknown", 4.0, cache) == 4.0
    assert normalize_score("tA", 4.0, cache, shift=1.0) == pytest.approx(1.0)
    # znorm layout keys by model
    zc = load_tnorm_param(["imp1"], res, field="model")
    assert zc["imp1"].mu == pytest.approx(0.0)


def test_search_llr_and_fuse_map_means():
    from lia_ral.backend.unsupervised import (fuse_map_means,
                                                  search_llr_from_res_file)
    res = [("s1", "t1", 0.5), ("s1", "t2", -0.5)]
    assert search_llr_from_res_file(res, "s1", "t2") == -0.5
    assert search_llr_from_res_file(res, "s2", "t1") is None
    m1 = GmmDiag.create(np.ones(1), np.asarray([[0.0, 0.0]]),
                        np.ones((1, 2)))
    m2 = GmmDiag.create(np.ones(1), np.asarray([[2.0, 4.0]]),
                        np.ones((1, 2)))
    f = fuse_map_means(m1, 3.0, m2, 1.0)
    np.testing.assert_allclose(np.asarray(f.means), [[0.5, 1.0]])


def _small_world(rng, k=8, d=4):
    x = rng.standard_normal((4000, d)).astype(np.float32) * 2
    xj = jnp.asarray(x)
    w = jnp.ones(4000, jnp.float32)
    init = mixture_init(jax.random.key(0), xj, w, k)
    return train_model(jax.random.key(1), xj, w, init,
                       TrainCfg(nb_train_it=3)), x


def test_znorm_param_online(rng):
    from lia_ral.backend.unsupervised import (
        compute_and_store_znorm_param)
    world, x = _small_world(rng)
    client_data = jnp.asarray(x[:800] + 1.0)
    from lia_ral.gmm.map_adapt import adapt_model
    client = adapt_model(jax.random.key(2), client_data,
                         jnp.ones(800, jnp.float32), world,
                         MapCfg(method="MAPOccDep", mean_adapt=True))
    imp_utts = [(jnp.asarray(x[i * 500:(i + 1) * 500]),
                 jnp.ones(500, jnp.float32)) for i in range(4, 8)]
    p = compute_and_store_znorm_param(client, world, imp_utts)
    assert np.isfinite(p.mu) and p.sigma > 0
    # impostor scores against an adapted client should skew negative
    assert p.mu < 0.5


def test_cross_valid_selects_split(rng):
    from lia_ral.backend.unsupervised import cross_valid
    world, x = _small_world(rng)
    xe = jnp.asarray(x[:1500] + 1.0)
    w = jnp.ones(1500, jnp.float32)
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True)
    em_model, sel, llr = cross_valid(jax.random.key(5), xe, w, world, cfg,
                                     selected_train=0.7, average_it=3)
    assert np.isfinite(llr)
    frac = float(jnp.sum(sel)) / 1500
    assert 0.4 < frac < 0.95          # bagged selection near 70%
    assert em_model.means.shape == world.means.shape
