import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.gmm import (
    EmStats, GmmDiag, MapCfg, TrainCfg, adapt_model, compute_test_llr,
    em_stats, em_stats_chunked, frame_llk, global_mean_cov,
    llk_and_posteriors, m_step, map_adapt, mixture_init, train_model,
    variance_control,
)
from lia_ral.gmm.scoring import stack_gmms


def naive_logdens(x, w, m, ci):
    """Scalar-loop oracle for the matmul formulation."""
    n, d = x.shape
    k = m.shape[0]
    out = np.zeros((n, k))
    for t in range(n):
        for c in range(k):
            diff = x[t] - m[c]
            out[t, c] = (-0.5 * (d * np.log(2 * np.pi) - np.log(ci[c]).sum())
                         - 0.5 * np.sum(diff * diff * ci[c]))
    return out + np.log(w)[None, :]


def random_gmm(rng, k, d):
    w = rng.random(k) + 0.1
    w /= w.sum()
    m = rng.standard_normal((k, d))
    ci = rng.random((k, d)) * 2 + 0.3
    return GmmDiag.create(w, m, ci)


def test_logdens_matches_naive(rng):
    k, d, n = 6, 5, 17
    gmm = random_gmm(rng, k, d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    llk, post = llk_and_posteriors(jnp.asarray(x), gmm)
    ref = naive_logdens(x.astype(np.float64), np.asarray(gmm.weights),
                        np.asarray(gmm.means), np.asarray(gmm.cov_inv))
    ref_llk = np.log(np.exp(ref - ref.max(1, keepdims=True)).sum(1)) + ref.max(1)
    np.testing.assert_allclose(np.asarray(llk), ref_llk,
                               rtol=2e-5, atol=2e-5)
    ref_post = np.exp(ref - ref_llk[:, None])
    np.testing.assert_allclose(np.asarray(post), ref_post,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(post).sum(1), 1.0,
                               rtol=1e-5)


def test_em_stats_weighting(rng):
    k, d, n = 4, 3, 50
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray((rng.random(n) > 0.4), jnp.float32)
    st = em_stats(x, w, gmm)
    # stats of the weighted set == stats of the selected subset
    sel = np.asarray(w) > 0
    st2 = em_stats(x[sel], jnp.ones(int(sel.sum()), jnp.float32), gmm)
    np.testing.assert_allclose(np.asarray(st.n), np.asarray(st2.n), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(st.sum_x), np.asarray(st2.sum_x),
                               rtol=1e-4, atol=1e-5)
    assert float(st.count) == float(sel.sum())


def test_chunked_equals_plain(rng):
    k, d, n = 5, 4, 103   # deliberately not a chunk multiple
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    a = em_stats(x, w, gmm)
    b = em_stats_chunked(x, w, gmm, chunk=16)
    for fa, fb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   rtol=5e-5, atol=5e-5)


def test_merge_associativity(rng):
    """Stat merge is the psum: split-merge == whole (SURVEY §4 property)."""
    k, d, n = 4, 3, 60
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones(n, jnp.float32)
    whole = em_stats(x, w, gmm)
    parts = EmStats.zeros(k, d)
    for i in range(0, n, 20):
        parts = parts.merge(em_stats(x[i:i+20], w[i:i+20], gmm))
    for fa, fb in zip(jax.tree.leaves(whole), jax.tree.leaves(parts)):
        np.testing.assert_allclose(np.asarray(fa), np.asarray(fb),
                                   rtol=5e-5, atol=5e-5)


def test_em_monotonic_llk(rng):
    """EM likelihood must be non-decreasing (reference verifyEMLK check)."""
    d, k, n = 4, 8, 2000
    centers = rng.standard_normal((k, d)) * 3
    x = (centers[rng.integers(0, k, n)]
         + rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    x = jnp.asarray(x)
    w = jnp.ones(n, jnp.float32)
    gmm = mixture_init(jax.random.key(0), x, w, k,
                       bagged_probability_init=1.0)
    llks = []
    for _ in range(8):
        st = em_stats(x, w, gmm)
        llks.append(float(st.mean_llk()))
        gmm = m_step(st)
    assert all(b >= a - 1e-4 for a, b in zip(llks, llks[1:])), llks


def test_variance_control(rng):
    gmm = random_gmm(rng, 4, 3)
    gcov = jnp.ones(3)
    out = variance_control(gmm, 0.9, 1.1, gcov)
    cov = np.asarray(1.0 / out.cov_inv)
    assert (cov >= 0.9 - 1e-6).all() and (cov <= 1.1 + 1e-6).all()


def test_train_model_runs(rng):
    d, k, n = 3, 4, 500
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones(n, jnp.float32)
    cfg = TrainCfg(nb_train_it=3, bagged_frame_probability=0.8)
    init = mixture_init(jax.random.key(1), x, w, k, 0.5)
    gmm = train_model(jax.random.key(2), x, w, init, cfg)
    assert np.isfinite(np.asarray(gmm.means)).all()
    np.testing.assert_allclose(float(jnp.sum(gmm.weights)), 1.0, rtol=1e-5)


def test_map_occdep_limits(rng):
    """r→∞ keeps the world; r→0 takes the EM estimate."""
    world = random_gmm(rng, 4, 3)
    em_model = random_gmm(rng, 4, 3)
    n_frames = jnp.asarray(1000.0)
    keep = map_adapt(world, em_model, n_frames,
                     MapCfg(method="MAPOccDep", mean_r=1e12))
    np.testing.assert_allclose(np.asarray(keep.means),
                               np.asarray(world.means), atol=1e-5)
    take = map_adapt(world, em_model, n_frames,
                     MapCfg(method="MAPOccDep", mean_r=1e-12))
    np.testing.assert_allclose(np.asarray(take.means),
                               np.asarray(em_model.means), atol=1e-4)


def test_adapt_model_moves_towards_data(rng):
    d, k, n = 3, 4, 400
    world = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)) + 2.0, jnp.float32)
    w = jnp.ones(n, jnp.float32)
    client = adapt_model(jax.random.key(0), x, w, world,
                         MapCfg(method="MAPOccDep", mean_r=5.0))
    # client means should move toward the (shifted) data
    d_world = np.abs(np.asarray(world.means).mean() - 2.0)
    d_client = np.abs(np.asarray(client.means).mean() - 2.0)
    assert d_client < d_world


def test_compute_test_llr_discriminates(rng):
    """Target model scores higher on its own data than an impostor."""
    d, k, n = 4, 8, 300
    world = random_gmm(rng, k, d)
    target = world.replace(means=world.means + 0.8)
    impostor = world.replace(means=world.means - 0.8)
    x = jnp.asarray(np.asarray(target.means)[rng.integers(0, k, n)]
                    + rng.standard_normal((n, d)) * 0.3, jnp.float32)
    w = jnp.ones(n, jnp.float32)
    llr = compute_test_llr(x, w, world, stack_gmms([target, impostor]),
                           top_k=k)   # top_k = K → exact scoring
    llr = np.asarray(llr)
    assert llr[0] > llr[1]
    assert llr[0] > 0


def test_top_k_approximation_close(rng):
    """top-10-of-32 with world residual ≈ exact LLR."""
    d, k, n = 4, 32, 200
    world = random_gmm(rng, k, d)
    target = world.replace(means=world.means * 1.1)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones(n, jnp.float32)
    clients = stack_gmms([target])
    exact = np.asarray(compute_test_llr(x, w, world, clients, top_k=k))
    approx = np.asarray(compute_test_llr(x, w, world, clients, top_k=10))
    np.testing.assert_allclose(approx, exact, atol=0.05)


def test_global_mean_cov(rng):
    x = jnp.asarray(rng.standard_normal((500, 3)) * 2 + 1, jnp.float32)
    w = jnp.ones(500, jnp.float32)
    mean, cov = global_mean_cov(x, w)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(x).mean(0),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cov), np.asarray(x).var(0),
                               rtol=1e-3, atol=1e-3)


def test_likelihood_gd_matches_scalar_oracle():
    """Scalar oracle for reference likelihoodGD (GeneralTools.cpp:816-855)."""
    from lia_ral.gmm.scoring import likelihood_gd, set_decision
    rng = np.random.default_rng(3)
    K, D = 6, 5
    mk = lambda: GmmDiag.create(
        rng.dirichlet(np.ones(K)), rng.standard_normal((K, D)),
        1.0 / (rng.random((K, D)) + 0.3))
    data, model = mk(), mk()
    d_cov = 1.0 / np.asarray(data.cov_inv)
    m_cov = 1.0 / np.asarray(model.cov_inv)
    m_cst = (2 * np.pi) ** (-D / 2) * np.prod(m_cov, axis=1) ** -0.5
    expected = 0.0
    for a in range(K):
        lk = 0.0
        for b in range(K):
            diff = np.asarray(data.means)[a] - np.asarray(model.means)[b]
            part = np.sum((d_cov[a] + diff ** 2) / m_cov[b])
            lk += float(model.weights[b]) * m_cst[b] * np.exp(-0.5 * part)
        expected += float(data.weights[a]) * np.log(lk)
    got = float(likelihood_gd(data, model))
    assert abs(got - expected) < 1e-3 * abs(expected)
    # top-N selection path compiles and runs
    got_top = float(likelihood_gd(data, model, top_data=3, top_model=4))
    assert np.isfinite(got_top)
    assert int(set_decision(0.5, 0.2)) == 1
    assert int(set_decision(0.1, 0.2)) == 0
