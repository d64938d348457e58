import numpy as np

import jax
import jax.numpy as jnp

from lia_ral.gmm import GmmDiag, em_stats_chunked, train_model, TrainCfg, mixture_init
from lia_ral.parallel import make_mesh, sharded_em_stats, sharded_stats_fn


def random_gmm(rng, k, d):
    w = rng.random(k) + 0.1
    w /= w.sum()
    return GmmDiag.create(w, rng.standard_normal((k, d)),
                          rng.random((k, d)) + 0.5)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_equals_serial(rng):
    """psum-merged sharded stats == single-device stats (the reference's
    threaded==unthreaded oracle, SURVEY.md §4)."""
    k, d, n = 6, 5, 1000
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    serial = em_stats_chunked(x, w, gmm, chunk=128)
    shard = sharded_em_stats(mesh, x, w, gmm, chunk=128)
    for a, b in zip(jax.tree.leaves(serial), jax.tree.leaves(shard)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_unpadded_frame_count(rng):
    """n not divisible by n_shards: pad frames must not change stats."""
    k, d, n = 4, 3, 1001   # 1001 % 8 != 0
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones(n, jnp.float32)
    mesh = make_mesh()
    st = sharded_em_stats(mesh, x, w, gmm, chunk=64)
    assert abs(float(st.count) - n) < 0.5


def test_train_model_with_sharded_stats(rng):
    """Full EM loop with the mesh-sharded accumulator converges the same
    direction as the serial one."""
    d, k, n = 4, 8, 4000
    centers = rng.standard_normal((k, d)) * 3
    x = jnp.asarray(centers[rng.integers(0, k, n)]
                    + rng.standard_normal((n, d)) * 0.5, jnp.float32)
    w = jnp.ones(n, jnp.float32)
    mesh = make_mesh()
    cfg = TrainCfg(nb_train_it=3, bagged_frame_probability=1.0)
    init = mixture_init(jax.random.key(0), x, w, k, 1.0)
    serial = train_model(jax.random.key(1), x, w, init, cfg)
    sharded = train_model(jax.random.key(1), x, w, init, cfg,
                          stats_fn=sharded_stats_fn(mesh, chunk=512))
    np.testing.assert_allclose(np.asarray(serial.means),
                               np.asarray(sharded.means),
                               rtol=5e-3, atol=5e-3)


def test_2d_sharded_equals_serial(rng):
    """data x model 2-D sharding == serial stats (components sharded,
    softmax normalisation via cross-axis collectives)."""
    from lia_ral.parallel import make_mesh, sharded_em_stats_2d
    from lia_ral.gmm import em_stats_chunked
    k, d, n = 8, 5, 1000
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    mesh = make_mesh(n_data=4, n_model=2)
    serial = em_stats_chunked(x, w, gmm, chunk=128)
    shard = sharded_em_stats_2d(mesh, x, w, gmm, chunk=128)
    for a, b in zip(jax.tree.leaves(serial), jax.tree.leaves(shard)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


def test_sharded_tv_e_step_equals_serial(rng):
    """Speaker-sharded TV E-step psum == serial (the reference's threaded
    estimateAandC under mutexes, AccumulateTVStat.cpp:1944)."""
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import TvModel, init_t, tv_e_step
    from lia_ral.parallel.sharding import sharded_tv_e_step

    k, d, r, s = 4, 3, 2, 16
    gmm = random_gmm(rng, k, d)
    model = init_t(jax.random.PRNGKey(0), r, gmm)
    stats = BwStats(
        n=jnp.asarray(rng.random((s, k)) * 20 + 1, jnp.float32),
        f=jnp.asarray(rng.standard_normal((s, k, d)) * 5, jnp.float32))
    mesh = make_mesh()
    w_ser, acc_ser = tv_e_step(stats, model, chunk=4)
    w_sh, acc_sh = sharded_tv_e_step(mesh, stats, model, chunk=2)
    np.testing.assert_allclose(np.asarray(w_sh), np.asarray(w_ser),
                               rtol=2e-3, atol=2e-3)
    for a, b in zip(jax.tree.leaves(acc_ser), jax.tree.leaves(acc_sh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)


def test_sharded_jfa_iterations_equal_serial(rng):
    """Speaker/session-sharded JFA V/U EM == serial (the threaded
    estimateVEVT/estimateYandV merge property, AccumulateJFAStat.cpp)."""
    import jax
    import jax.numpy as jnp
    from tests.test_jfa import synth_jfa_data
    from lia_ral.fa.jfa import jfa_u_iteration, jfa_v_iteration
    from lia_ral.parallel import make_mesh
    from lia_ral.parallel.sharding import (sharded_jfa_u_iteration,
                                               sharded_jfa_v_iteration)
    gmm, stats, *_ = synth_jfa_data(rng, n_spk=11, sess_per_spk=3)
    from lia_ral.fa.jfa import JfaModel
    model = JfaModel.init(jax.random.key(0), 2, 2, gmm, scale=0.1)
    s = stats.spk.n.shape[0]
    h = stats.sess.n.shape[0]
    x = jnp.asarray(rng.standard_normal((h, 2)), jnp.float32) * 0.1
    z = jnp.zeros_like(stats.spk.f)
    y0 = jnp.asarray(rng.standard_normal((s, 2)), jnp.float32) * 0.1
    mesh = make_mesh()
    mv_ser, y_ser = jfa_v_iteration(stats, model, x, z)
    mv_shd, y_shd = sharded_jfa_v_iteration(mesh, stats, model, x, z)
    np.testing.assert_allclose(np.asarray(mv_shd.v), np.asarray(mv_ser.v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(y_shd), np.asarray(y_ser),
                               rtol=2e-4, atol=2e-5)
    mu_ser, x_ser = jfa_u_iteration(stats, model, y0, z)
    mu_shd, x_shd = sharded_jfa_u_iteration(mesh, stats, model, y0, z)
    np.testing.assert_allclose(np.asarray(mu_shd.u), np.asarray(mu_ser.u),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(x_shd), np.asarray(x_ser),
                               rtol=2e-4, atol=2e-5)


def test_sharded_plda_em_and_scoring_equal_serial(rng):
    """Session-sharded PLDA EM and model-sharded scoring == serial (the
    threaded getExpectedValues / scoring merge, PldaTools.cpp:2647/4061)."""
    import jax
    import jax.numpy as jnp
    from lia_ral.backend.ivnorm import DevSet
    from lia_ral.backend.plda import (PldaModel, plda_em_iteration,
                                          plda_llr, plda_train)
    from lia_ral.parallel import make_mesh
    from lia_ral.parallel.sharding import (sharded_plda_em_iteration,
                                               sharded_plda_llr)
    r, rf, rg, n_spk, sess = 20, 6, 3, 13, 3
    h = rng.standard_normal((n_spk, rf))
    vecs, labels = [], []
    f_true = rng.standard_normal((r, rf))
    g_true = rng.standard_normal((r, rg)) * 0.5
    for s_ in range(n_spk):
        for _ in range(sess):
            vecs.append(f_true @ h[s_] + g_true @ rng.standard_normal(rg)
                        + rng.standard_normal(r) * 0.3)
            labels.append(f"s{s_}")
    dev = DevSet.from_labels(np.asarray(vecs, np.float32), labels)
    model = PldaModel.init(jax.random.key(1), r, rf, rg,
                           data_mean=np.mean(vecs, 0),
                           data_cov=np.cov(np.asarray(vecs).T))
    mesh = make_mesh()
    ser = plda_em_iteration(model, dev)
    shd = sharded_plda_em_iteration(mesh, model, dev)
    for a, b in zip(jax.tree.leaves(shd), jax.tree.leaves(ser)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-5)
    # scoring: 7 models (pads to 8) x 9 tests
    plda = plda_train(jax.random.key(2), dev, rf, rg, n_iterations=4)
    enroll = jnp.asarray(rng.standard_normal((7, r)), jnp.float32)
    ns = jnp.asarray(rng.integers(1, 4, 7), jnp.float32)
    test = jnp.asarray(rng.standard_normal((9, r)), jnp.float32)
    s_ser = np.asarray(plda_llr(plda, enroll, ns, test))
    s_shd = np.asarray(sharded_plda_llr(mesh, plda, enroll, ns, test))
    np.testing.assert_allclose(s_shd, s_ser, rtol=2e-4, atol=2e-4)


def test_tools_numthread_sharded_equal_serial(rng, tmp_path):
    """numThread reaches TV (and PLDA) through the tools: an 8-way mesh
    run produces the same T matrix as single-device (SURVEY §2.6)."""
    import jax.numpy as jnp
    from lia_ral.config import Config
    from lia_ral.gmm import GmmDiag
    from lia_ral.io.features import write_feature_file
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import read_matrix_file
    from lia_ral.tools import total_variability

    k, d = 8, 5
    w = rng.random(k) + 0.5
    w /= w.sum()
    gmm = GmmDiag.create(w, rng.standard_normal((k, d)) * 2,
                         rng.random((k, d)) * 0.5 + 0.8)
    gmm.save(str(tmp_path / "wld.gmm"))
    rows = []
    for s_ in range(10):
        nm = f"sess{s_}"
        comp = rng.integers(0, k, 300)
        x = (np.asarray(gmm.means)[comp]
             + rng.standard_normal((300, d)) * 0.6).astype(np.float32)
        write_feature_file(str(tmp_path / (nm + ".prm")), x, fmt="SPRO4")
        rows.append([nm])
    write_xlist(str(tmp_path / "tv.ndx"), rows)
    base = {
        "featureFilesPath": str(tmp_path) + "/",
        "mixtureFilesPath": str(tmp_path) + "/",
        "matrixFilesPath": str(tmp_path) + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "ndxFilename": str(tmp_path / "tv.ndx"),
        "inputWorldFilename": "wld",
        "totalVariabilityNumber": 4, "nbIt": 3, "initScale": 0.5,
    }
    c1 = Config(dict(base, totalVariabilityMatrix="TV1"))
    total_variability.main(c1)
    c8 = Config(dict(base, totalVariabilityMatrix="TV8", numThread=8))
    total_variability.main(c8)
    t1 = read_matrix_file(str(tmp_path / "TV1.matx"))
    t8 = read_matrix_file(str(tmp_path / "TV8.matx"))
    np.testing.assert_allclose(t8, t1, rtol=2e-3, atol=2e-4)


def test_sharded_estimate_w_equals_serial(rng):
    """Utterance-sharded i-vector extraction == serial (the reference's
    estimateWThreaded file-list split, AccumulateTVStat.cpp:2103) for
    both solvers; the PCG preconditioner basis is computed from the
    replicated global stats so every iterate matches the serial path."""
    import jax
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import estimate_w, init_t
    from lia_ral.parallel import make_mesh
    from lia_ral.parallel.sharding import sharded_estimate_w

    k, d, r, s = 12, 5, 6, 19          # 19 pads to 24 over 8 shards
    gmm = random_gmm(rng, k, d)
    model = init_t(jax.random.key(4), r, gmm)
    stats = BwStats(
        n=jnp.asarray(rng.random((s, k)) * 30 + 0.5, jnp.float32),
        f=jnp.asarray(rng.standard_normal((s, k, d)) * 4, jnp.float32))
    mesh = make_mesh()
    for solver in ("pcg", "cholesky"):
        w_ser = np.asarray(estimate_w(stats, model, chunk=4,
                                      solver=solver))
        w_shd = np.asarray(sharded_estimate_w(mesh, stats, model, chunk=2,
                                              solver=solver))
        np.testing.assert_allclose(w_shd, w_ser, rtol=2e-4, atol=2e-5)


def test_sharded_tv_e_step_2d_equals_serial(rng):
    """(speakers x components) 2-D sharded TV E-step == serial — the
    >HBM T-matrix case (SURVEY §2.6; PERF.md §8 single-chip boundary):
    only the (B,R,R) L build and (B,R) aux cross the component axis,
    psum-merged, so the replicated solve matches the serial path."""
    import jax
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import init_t, tv_e_step, tv_m_step
    from lia_ral.parallel import make_mesh
    from lia_ral.parallel.sharding import sharded_tv_e_step_2d
    from tests.test_gmm_kernels import random_gmm

    k, d, r, s = 8, 3, 4, 11          # k divisible by n_model=2
    gmm = random_gmm(rng, k, d)
    model = init_t(jax.random.key(7), r, gmm)
    stats = BwStats(
        n=jnp.asarray(rng.random((s, k)) * 25 + 1, jnp.float32),
        f=jnp.asarray(rng.standard_normal((s, k, d)) * 4, jnp.float32))
    mesh = make_mesh(n_data=4, n_model=2)
    w_ser, acc_ser = tv_e_step(stats, model, chunk=4)
    w_shd, acc_shd = sharded_tv_e_step_2d(mesh, stats, model, chunk=2)
    np.testing.assert_allclose(np.asarray(w_shd), np.asarray(w_ser),
                               rtol=2e-3, atol=2e-3)
    for a, b in zip(jax.tree.leaves(acc_shd), jax.tree.leaves(acc_ser)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)
    # the M-step consumes the sharded accums directly
    m_ser = tv_m_step(model, acc_ser)
    m_shd = tv_m_step(model, acc_shd)
    np.testing.assert_allclose(np.asarray(m_shd.t), np.asarray(m_ser.t),
                               rtol=5e-3, atol=5e-3)
