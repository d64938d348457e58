import numpy as np
import pytest

import jax.numpy as jnp

from lia_ral.backend.supervector import (
    compute_nap, fisher_weight_vector, get_supervector, kl_vector,
    model_to_sv, nap_project_vectors, project_on_subspace, sv_to_model,
    train_nap_subspace,
)
from lia_ral.backend.svm import SvmModel, default_c, svm_train
from lia_ral.gmm import GmmDiag


def random_gmm(rng, k=4, d=3):
    w = rng.random(k) + 0.5
    w /= w.sum()
    return GmmDiag.create(w, rng.standard_normal((k, d)),
                          rng.random((k, d)) + 0.5)


def test_sv_roundtrip(rng):
    g = random_gmm(rng)
    sv = model_to_sv(g)
    assert sv.shape == (12,)
    g2 = sv_to_model(sv + 1.0, g)
    np.testing.assert_allclose(np.asarray(g2.means),
                               np.asarray(g.means) + 1.0, rtol=1e-6)


def test_nap_removes_subspace_component(rng):
    d = 12
    u = np.linalg.qr(rng.standard_normal((d, 2)))[0].T  # (2, d) orthonormal
    g = random_gmm(rng, 4, 3)
    g2 = compute_nap(g, jnp.asarray(u, jnp.float32))
    sv2 = np.asarray(model_to_sv(g2))
    # projection of the napped vector onto U is ~0
    np.testing.assert_allclose(u @ sv2, 0.0, atol=1e-4)
    # idempotent
    g3 = compute_nap(g2, jnp.asarray(u, jnp.float32))
    np.testing.assert_allclose(np.asarray(model_to_sv(g3)), sv2, atol=1e-5)


def test_fisher_and_kl_vectors(rng):
    w = random_gmm(rng)
    c = random_gmm(rng)
    f = np.asarray(fisher_weight_vector(w, c))
    np.testing.assert_allclose(f, np.asarray(c.weights) / np.asarray(w.weights),
                               rtol=1e-6)
    k = np.asarray(kl_vector(c))
    assert k.shape == (12,)
    np.testing.assert_allclose(
        np.asarray(get_supervector("KL", w, c)), k)
    with pytest.raises(ValueError):
        get_supervector("nope", w, c)


def test_train_nap_subspace_finds_channel_direction(rng):
    d, n_spk, sess = 20, 10, 8
    channel_dir = rng.standard_normal(d)
    channel_dir /= np.linalg.norm(channel_dir)
    spk_means = rng.standard_normal((n_spk, d)) * 2
    vecs, ids = [], []
    for s in range(n_spk):
        for _ in range(sess):
            vecs.append(spk_means[s]
                        + channel_dir * rng.standard_normal() * 3.0
                        + rng.standard_normal(d) * 0.1)
            ids.append(s)
    u = np.asarray(train_nap_subspace(
        jnp.asarray(np.stack(vecs), jnp.float32),
        jnp.asarray(np.asarray(ids)), n_spk, rank=1))
    cos = abs(float(u[0] @ channel_dir))
    assert cos > 0.95, cos
    # projecting out the nuisance leaves speaker structure intact
    napped = np.asarray(nap_project_vectors(
        jnp.asarray(np.stack(vecs), jnp.float32), jnp.asarray(u)))
    assert float(np.abs(napped @ channel_dir).mean()) < 1.0


def test_svm_linear_separable(rng):
    n, d = 60, 5
    w_true = rng.standard_normal(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sign(x @ w_true + 0.1).astype(np.float32)
    model = svm_train(x, y, c=10.0, n_iter=800)
    dec = np.asarray(model.decision(jnp.asarray(x)))
    acc = (np.sign(dec) == y).mean()
    assert acc > 0.95, acc


def test_svm_one_vs_cohort(rng):
    """The NIST setup: one target supervector vs background cohort."""
    d = 10
    cohort = rng.standard_normal((50, d)).astype(np.float32)
    target = (rng.standard_normal(d) * 0.2 + 2.0).astype(np.float32)
    x = np.vstack([target[None, :], cohort])
    y = np.r_[1.0, -np.ones(50)].astype(np.float32)
    model = svm_train(x, y, target_penalty=50.0, n_iter=800)
    # target-like test vectors score higher than cohort-like ones
    t_test = target + rng.standard_normal((5, d)).astype(np.float32) * 0.2
    i_test = rng.standard_normal((5, d)).astype(np.float32)
    dt = np.asarray(model.decision(jnp.asarray(t_test)))
    di = np.asarray(model.decision(jnp.asarray(i_test)))
    assert dt.mean() > di.mean()


def test_svm_rbf(rng):
    # XOR-ish problem: not linearly separable
    x = np.array([[0, 0], [1, 1], [0, 1], [1, 0]] * 10, np.float32) \
        + rng.standard_normal((40, 2)).astype(np.float32) * 0.05
    y = np.array([1, 1, -1, -1] * 10, np.float32)
    model = svm_train(x, y, c=10.0, kind="rbf", gamma=2.0, n_iter=1000)
    acc = (np.sign(np.asarray(model.decision(jnp.asarray(x)))) == y).mean()
    assert acc > 0.9, acc


def test_default_c(rng):
    x = rng.standard_normal((30, 4))
    c = default_c(x)
    assert abs(c - 1.0 / np.mean(np.sum(x * x, 1))) < 1e-9
