import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.fa.jfa import (JfaModel, JfaStats, estimate_x, estimate_y,
                                estimate_z_map, jfa_dot_product_scores,
                                jfa_train, jfa_u_iteration, jfa_v_iteration)
from lia_ral.fa.stats import BwStats, bw_stats_batch
from lia_ral.gmm import GmmDiag


def random_gmm(rng, k, d):
    w = rng.random(k) + 0.5
    w /= w.sum()
    return GmmDiag.create(w, rng.standard_normal((k, d)) * 2,
                          rng.random((k, d)) * 0.5 + 0.8)


def synth_jfa_data(rng, n_spk=12, sess_per_spk=4, k=8, d=5, rv=2, ru=2,
                   frames=300, v_scale=1.0, u_scale=0.5):
    gmm = random_gmm(rng, k, d)
    v_true = rng.standard_normal((rv, k, d)) * v_scale
    u_true = rng.standard_normal((ru, k, d)) * u_scale
    y_true = rng.standard_normal((n_spk, rv))
    xs, sess_spk, x_true = [], [], []
    for s in range(n_spk):
        for _ in range(sess_per_spk):
            x_h = rng.standard_normal(ru)
            shift = (np.einsum("r,rkd->kd", y_true[s], v_true)
                     + np.einsum("r,rkd->kd", x_h, u_true))
            comp = rng.integers(0, k, frames)
            x = ((np.asarray(gmm.means) + shift)[comp]
                 + rng.standard_normal((frames, d)) / np.sqrt(
                     np.asarray(gmm.cov_inv))[comp])
            xs.append(x)
            sess_spk.append(s)
            x_true.append(x_h)
    feats = jnp.asarray(np.stack(xs), jnp.float32)
    sess = bw_stats_batch(feats, jnp.ones(feats.shape[:2]), gmm)
    stats = JfaStats.from_sessions(sess, np.asarray(sess_spk), n_spk)
    return gmm, stats, v_true, u_true, y_true, np.stack(x_true)


def test_speaker_stats_aggregation(rng):
    gmm, stats, *_ = synth_jfa_data(rng, n_spk=3, sess_per_spk=2)
    np.testing.assert_allclose(
        np.asarray(stats.spk.n).sum(), np.asarray(stats.sess.n).sum(),
        rtol=1e-5)
    # speaker 0 stats = sum of its sessions
    np.testing.assert_allclose(
        np.asarray(stats.spk.n[0]),
        np.asarray(stats.sess.n[np.asarray(stats.sess_spk) == 0]).sum(0),
        rtol=1e-4)


def test_v_training_recovers_subspace(rng):
    gmm, stats, v_true, u_true, y_true, _ = synth_jfa_data(
        rng, u_scale=0.0)   # no channel effect: pure eigenvoice case
    rv = v_true.shape[0]
    model, y, x, z = jfa_train(jax.random.key(0), stats, gmm,
                               rank_v=rv, rank_u=2, nb_it_v=8, nb_it_u=0)

    def gap(t_est, t_ref):
        a = t_est.reshape(t_est.shape[0], -1).T
        b = t_ref.reshape(t_ref.shape[0], -1).T
        qa, _ = np.linalg.qr(a)
        qb, _ = np.linalg.qr(b)
        return 1 - np.linalg.svd(qa.T @ qb, compute_uv=False).min()

    g = gap(np.asarray(model.v), v_true)
    assert g < 0.1, g
    # y estimates correlate with truth (up to rotation): check via
    # canonical correlation of the two sets
    yh = np.asarray(y)
    cc = np.linalg.svd(np.linalg.qr(yh)[0].T @ np.linalg.qr(y_true)[0],
                       compute_uv=False)
    assert cc.min() > 0.8, cc


def test_u_iteration_reduces_channel_residual(rng):
    gmm, stats, v_true, u_true, y_true, x_true = synth_jfa_data(rng)
    model, y, x, z = jfa_train(jax.random.key(1), stats, gmm,
                               rank_v=2, rank_u=2, nb_it_v=6, nb_it_u=6)
    assert np.isfinite(np.asarray(model.u)).all()
    # estimated x should correlate with true channel factors
    xh = np.asarray(x)
    cc = np.linalg.svd(np.linalg.qr(xh)[0].T @ np.linalg.qr(x_true)[0],
                       compute_uv=False)
    assert cc.min() > 0.5, cc


def test_d_iteration_and_z(rng):
    gmm, stats, *_ = synth_jfa_data(rng, n_spk=6, sess_per_spk=3)
    model, y, x, z = jfa_train(jax.random.key(2), stats, gmm,
                               rank_v=2, rank_u=2, nb_it_v=4, nb_it_u=3,
                               nb_it_d=3)
    assert np.isfinite(np.asarray(model.d)).all()
    assert np.isfinite(np.asarray(z)).all()
    zz = estimate_z_map(stats, model, y, x, tau=10.0)
    assert zz.shape == z.shape


def test_supervector_synthesis(rng):
    gmm = random_gmm(rng, 4, 3)
    model = JfaModel.init(jax.random.key(3), 2, 2, gmm, scale=0.1)
    y = jnp.asarray(rng.standard_normal(2), jnp.float32)
    x = jnp.asarray(rng.standard_normal(2), jnp.float32)
    z = jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)
    sv = np.asarray(model.supervector(y, x, z))
    manual = (np.asarray(gmm.means)
              + np.einsum("r,rkd->kd", np.asarray(y), np.asarray(model.v))
              + np.einsum("r,rkd->kd", np.asarray(x), np.asarray(model.u))
              + np.asarray(model.d) * np.asarray(z))
    np.testing.assert_allclose(sv, manual, rtol=1e-5)
    spk = model.speaker_gmm(y, z, gmm.weights)
    assert isinstance(spk, GmmDiag)


def test_dot_product_scoring_discriminates(rng):
    gmm, stats, v_true, u_true, y_true, _ = synth_jfa_data(
        rng, n_spk=8, sess_per_spk=4, u_scale=0.3)
    model, y, x, z = jfa_train(jax.random.key(4), stats, gmm,
                               rank_v=2, rank_u=2, nb_it_v=6, nb_it_u=4)
    # make fresh test sessions per speaker
    k, d = np.asarray(gmm.means).shape
    xs = []
    for s in range(8):
        shift = np.einsum("r,rkd->kd", y_true[s], v_true)
        comp = rng.integers(0, k, 300)
        xs.append((np.asarray(gmm.means) + shift)[comp]
                  + rng.standard_normal((300, d)) / np.sqrt(
                      np.asarray(gmm.cov_inv))[comp])
    feats = jnp.asarray(np.stack(xs), jnp.float32)
    test_stats = bw_stats_batch(feats, jnp.ones(feats.shape[:2]), gmm)
    x_test, _ = estimate_x(
        JfaStats.from_sessions(test_stats, np.arange(8), 8),
        model, jnp.zeros((8, 2)), jnp.zeros((8, k, d)))
    scores = np.asarray(jfa_dot_product_scores(test_stats, model, y,
                                               x_test))
    # diagonal (same speaker) should beat off-diagonal on average
    tgt = np.diag(scores).mean()
    imp = scores[~np.eye(8, dtype=bool)].mean()
    assert tgt > imp, (tgt, imp)


def test_jfa_verify_em_llk_improves(rng):
    """verifyEMLK parity (AccumulateJFAStat.cpp:4803-4860): evidence LLK of
    sessions under synthesised m+Vy+Ux+Dz models rises over JFA training."""
    from lia_ral.fa.jfa import jfa_verify_em_llk, jfa_train, JfaModel
    from lia_ral.fa.jfa import JfaStats
    from lia_ral.fa.stats import bw_stats_batch
    k, d, rv, ru = 4, 3, 2, 2
    n_spk, sess_per, frames = 6, 3, 250
    gmm = random_gmm(rng, k, d)
    v_true = rng.standard_normal((rv, k, d))
    u_true = rng.standard_normal((ru, k, d)) * 0.5
    xs, sess_spk = [], []
    for s in range(n_spk):
        y = rng.standard_normal(rv)
        for _ in range(sess_per):
            xx = rng.standard_normal(ru)
            mu = (np.asarray(gmm.means) + np.einsum("r,rkd->kd", y, v_true)
                  + np.einsum("r,rkd->kd", xx, u_true))
            comp = rng.integers(0, k, frames)
            xs.append(mu[comp] + rng.standard_normal((frames, d)) * 0.7)
            sess_spk.append(s)
    x_frames = jnp.asarray(np.stack(xs), jnp.float32)
    mask = jnp.ones(x_frames.shape[:2], jnp.float32)
    sess = bw_stats_batch(x_frames, mask, gmm)
    stats = JfaStats.from_sessions(sess, sess_spk, n_spk)
    key = jax.random.key(0)
    model0 = JfaModel.init(key, rv, ru, gmm)
    h = len(xs)
    y0 = jnp.zeros((n_spk, rv)); x0 = jnp.zeros((h, ru))
    z0 = jnp.zeros((n_spk, k, d))
    llk0 = jfa_verify_em_llk(x_frames, mask, stats, model0, gmm.weights,
                             y0, x0, z0, max_sessions=5)
    model, y, x, z = jfa_train(key, stats, gmm, rv, ru,
                               nb_it_v=5, nb_it_u=5, nb_it_d=2)
    llk1 = jfa_verify_em_llk(x_frames, mask, stats, model, gmm.weights,
                             y, x, z, max_sessions=5)
    assert llk1 > llk0 + 0.5, (llk0, llk1)


def test_orthonormalize_v_gram_schmidt(rng):
    """QR-based orthonormalize_v == reference Gram-Schmidt semantics
    (AccumulateJFAStat.cpp:4700): orthonormal rows, same leading span,
    positive projection of each original row on its own image."""
    from lia_ral.fa.jfa import orthonormalize_v
    gmm = random_gmm(rng, 8, 5)
    model = JfaModel.init(jax.random.key(4), 3, 2, gmm, scale=1.0)
    om = orthonormalize_v(model)
    v = np.asarray(om.v).reshape(3, -1)
    np.testing.assert_allclose(v @ v.T, np.eye(3), atol=1e-5)
    v0 = np.asarray(model.v).reshape(3, -1)
    # Gram-Schmidt keeps row 1 direction exactly
    np.testing.assert_allclose(v[0], v0[0] / np.linalg.norm(v0[0]),
                               atol=1e-5)
    # and every row keeps a positive component along its original self
    assert (np.einsum("rk,rk->r", v, v0) > 0).all()


def test_store_restore_and_npz_accs(rng, tmp_path):
    from lia_ral.fa.jfa import (load_accs_npz, restore_accs,
                                    save_accs_npz, store_accs)
    gmm, stats, *_ = synth_jfa_data(rng, n_spk=3, sess_per_spk=2)
    snap = store_accs(stats)
    back = restore_accs(snap)
    np.testing.assert_array_equal(np.asarray(back.spk.n),
                                  np.asarray(stats.spk.n))
    p = str(tmp_path / "accs.npz")
    save_accs_npz(p, stats)
    loaded = load_accs_npz(p)
    np.testing.assert_allclose(np.asarray(loaded.sess.f),
                               np.asarray(stats.sess.f), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(loaded.sess_spk),
                                  np.asarray(stats.sess_spk))


def test_joint_yx_enrollment_matches_separate(rng):
    """Joint (y,x) over [V;U] (TrainTarget.cpp:529 estimateYX) agrees
    with the separate y estimate when U ≈ 0, and discriminates speakers
    when channels are live."""
    from lia_ral.fa.jfa import enroll_targets_joint, estimate_yx_joint
    gmm, stats, v_true, u_true, y_true, _ = synth_jfa_data(
        rng, u_scale=0.0)
    model, y_sep, x, z = jfa_train(jax.random.key(5), stats, gmm,
                                   rank_v=2, rank_u=2, nb_it_v=6,
                                   nb_it_u=0)
    zed = jnp.zeros_like(stats.spk.f)
    y_joint, x_joint, cov = estimate_yx_joint(stats, model, zed)
    assert cov.shape == (y_joint.shape[0], 4, 4)
    # U was random-init tiny, so joint y ≈ separate y
    np.testing.assert_allclose(np.asarray(y_joint), np.asarray(y_sep),
                               atol=0.05)
    yj, xj, zj = enroll_targets_joint(stats, model, tau=1.0)
    assert np.isfinite(np.asarray(zj)).all()
    cc = np.linalg.svd(
        np.linalg.qr(np.asarray(yj))[0].T @ np.linalg.qr(y_true)[0],
        compute_uv=False)
    assert cc.min() > 0.8, cc


def test_train_target_jfa_tool(rng, tmp_path):
    """channelCompensation JFA end-to-end through the TrainTarget CLI:
    client model = m + V·y + D·z, supervector + y/x/z side files."""
    from lia_ral.config import Config
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import read_matrix_file, write_matrix_file
    from lia_ral.tools import train_target

    k, d, rv, ru = 8, 5, 2, 2
    gmm = random_gmm(rng, k, d)
    gmm.save(str(tmp_path / "wld.gmm"))
    v = rng.standard_normal((rv, k * d)) * 0.8
    u = rng.standard_normal((ru, k * d)) * 0.3
    write_matrix_file(str(tmp_path / "EV.matx"), v)
    write_matrix_file(str(tmp_path / "EC.matx"), u)
    rows = []
    for s in range(3):
        y_s = rng.standard_normal(rv)
        shift = np.einsum("r,rk->k", y_s, v).reshape(k, d)
        for j in range(2):
            comp = rng.integers(0, k, 400)
            x = ((np.asarray(gmm.means) + shift)[comp]
                 + rng.standard_normal((400, d)) * 0.5).astype(np.float32)
            write_feature_file(str(tmp_path / f"s{s}_{j}.prm"), x,
                               fmt="SPRO4")
        rows.append([f"spk{s}", f"s{s}_0", f"s{s}_1"])
    write_xlist(str(tmp_path / "targets.ndx"), rows)
    cfg = Config({
        "featureFilesPath": str(tmp_path) + "/",
        "mixtureFilesPath": str(tmp_path) + "/",
        "matrixFilesPath": str(tmp_path) + "/",
        "saveVectorFilesPath": str(tmp_path) + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW",
        "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "targetIdList": str(tmp_path / "targets.ndx"),
        "inputWorldFilename": "wld",
        "channelCompensation": "JFA",
        "eigenVoiceMatrix": "EV", "eigenChannelMatrix": "EC",
        "saveY": "true", "saveX": "true", "saveZ": "true",
    })
    out = train_target.main(cfg)
    assert set(out) == {"spk0", "spk1", "spk2"}
    m0 = GmmDiag.load(str(tmp_path / "spk0.gmm"))
    assert np.isfinite(np.asarray(m0.means)).all()
    # enrolled model moved away from the world
    assert float(np.abs(np.asarray(m0.means)
                        - np.asarray(gmm.means)).mean()) > 1e-3
    sv = read_matrix_file(str(tmp_path / "spk0.vect"))
    assert sv.shape == (1, k * d)
    assert read_matrix_file(str(tmp_path / "spk0.y")).shape == (1, rv)
    assert read_matrix_file(str(tmp_path / "spk0.x")).shape == (1, ru)
    assert read_matrix_file(str(tmp_path / "spk0.z")).shape == (1, k * d)
