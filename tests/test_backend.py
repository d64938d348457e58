import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.backend import (
    DevSet, PldaModel, apply_efr, compute_cov_matrices, compute_lda,
    compute_mahalanobis, compute_wccn, cosine_scores, efr_iterations,
    length_norm, mahalanobis_scores, plda_llr, plda_train, tnorm,
    two_cov_scores, znorm, ztnorm,
)
from lia_ral.backend.eval import eer, min_dcf


def make_ivectors(rng, n_spk=20, sess_per_spk=6, r=16, between=1.0,
                  within=0.4):
    spk_means = rng.standard_normal((n_spk, r)) * between
    vecs, labels = [], []
    for s in range(n_spk):
        for _ in range(sess_per_spk):
            vecs.append(spk_means[s] + rng.standard_normal(r) * within)
            labels.append(f"spk{s}")
    return np.asarray(vecs, np.float32), labels, spk_means


def test_cov_matrices_decomposition(rng):
    vecs, labels, _ = make_ivectors(rng)
    dev = DevSet.from_labels(vecs, labels)
    sigma, w, b = (np.asarray(m) for m in compute_cov_matrices(dev))
    # total = within + between (exact by construction of the estimators)
    np.testing.assert_allclose(sigma, w + b, rtol=1e-3, atol=1e-4)
    assert np.all(np.linalg.eigvalsh(w) > -1e-5)


def test_length_norm(rng):
    x = jnp.asarray(rng.standard_normal((10, 5)), jnp.float32)
    y = np.asarray(length_norm(x))
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), 1.0, rtol=1e-5)


def test_efr_whitens_and_applies(rng):
    vecs, labels, _ = make_ivectors(rng)
    dev = DevSet.from_labels(vecs, labels)
    out, params = efr_iterations(dev, n_iterations=2, mode="EFR")
    out = np.asarray(out)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    # applying recorded transforms to the same data reproduces the result
    re = np.asarray(apply_efr(dev.vectors, params))
    np.testing.assert_allclose(re, out, rtol=1e-4, atol=1e-5)
    # covariance after EFR is closer to spherical
    c = np.cov(out.T)
    ratio = np.linalg.eigvalsh(c).max() / max(np.linalg.eigvalsh(c).min(), 1e-9)
    c0 = np.cov(vecs.T)
    ratio0 = np.linalg.eigvalsh(c0).max() / np.linalg.eigvalsh(c0).min()
    assert ratio < ratio0


def test_lda_improves_separation(rng):
    vecs, labels, _ = make_ivectors(rng, between=1.0, within=0.6)
    dev = DevSet.from_labels(vecs, labels)
    proj = compute_lda(dev, rank=8)
    assert np.asarray(proj).shape == (8, 16)
    y = np.asarray(dev.vectors @ proj.T)
    dev2 = DevSet.from_labels(y, labels)
    _, w2, b2 = (np.asarray(m) for m in compute_cov_matrices(dev2))
    _, w1, b1 = (np.asarray(m) for m in compute_cov_matrices(dev))
    fisher_before = np.trace(b1) / np.trace(w1)
    fisher_after = np.trace(b2) / np.trace(w2)
    assert fisher_after > fisher_before


def _trial_scores(rng, score_fn):
    """Build enroll/test split and return (target_scores, impostor_scores)."""
    vecs, labels, spk_means = make_ivectors(rng, n_spk=15, sess_per_spk=8)
    dev = DevSet.from_labels(vecs, labels)
    # unseen sessions of the same speakers
    enroll = spk_means + rng.standard_normal(spk_means.shape) * 0.15
    test = spk_means + rng.standard_normal(spk_means.shape) * 0.4
    s = np.asarray(score_fn(dev, jnp.asarray(enroll, jnp.float32),
                            jnp.asarray(test, jnp.float32)))
    tgt = np.diag(s)
    imp = s[~np.eye(s.shape[0], dtype=bool)]
    return tgt, imp


def test_cosine_discriminates(rng):
    def fn(dev, e, t):
        return cosine_scores(e, t, wccn=compute_wccn(dev))
    tgt, imp = _trial_scores(rng, fn)
    assert eer(tgt, imp) < 0.05


def test_mahalanobis_discriminates(rng):
    def fn(dev, e, t):
        return mahalanobis_scores(e, t, compute_mahalanobis(dev))
    tgt, imp = _trial_scores(rng, fn)
    assert eer(tgt, imp) < 0.05


def test_two_cov_discriminates(rng):
    def fn(dev, e, t):
        _, w, b = compute_cov_matrices(dev)
        mean = jnp.mean(dev.vectors, axis=0)
        return two_cov_scores(e - mean, t - mean, w, b)
    tgt, imp = _trial_scores(rng, fn)
    assert eer(tgt, imp) < 0.05


def test_plda_train_and_score(rng):
    def fn(dev, e, t):
        model = plda_train(jax.random.key(0), dev, rank_f=8,
                           n_iterations=8)
        ns = jnp.ones((e.shape[0],))
        return plda_llr(model, e, ns, t)
    tgt, imp = _trial_scores(rng, fn)
    assert eer(tgt, imp) < 0.05
    assert tgt.mean() > imp.mean()


def test_plda_with_channel_subspace(rng):
    vecs, labels, _ = make_ivectors(rng, n_spk=12, sess_per_spk=10)
    dev = DevSet.from_labels(vecs, labels)
    model = plda_train(jax.random.key(1), dev, rank_f=6, rank_g=4,
                       n_iterations=5)
    assert np.isfinite(np.asarray(model.f)).all()
    assert np.isfinite(np.asarray(model.g)).all()
    assert model.rank_g == 4


def test_plda_multisession_enrollment_helps(rng):
    """More enrollment sessions → better separation (n_sessions matters)."""
    vecs, labels, spk_means = make_ivectors(rng, n_spk=15, sess_per_spk=8,
                                            within=0.6)
    dev = DevSet.from_labels(vecs, labels)
    model = plda_train(jax.random.key(2), dev, rank_f=8, n_iterations=6)
    n_spk = spk_means.shape[0]
    test = jnp.asarray(spk_means + rng.standard_normal(spk_means.shape) * 0.6,
                       jnp.float32)
    for n_enroll, eers in ((1, []), ):
        pass
    def run(n_e):
        enr = spk_means + rng.standard_normal(spk_means.shape) * 0.6 / np.sqrt(n_e)
        s = np.asarray(plda_llr(model, jnp.asarray(enr, jnp.float32),
                                jnp.full((n_spk,), float(n_e)), test))
        return eer(np.diag(s), s[~np.eye(n_spk, dtype=bool)])
    assert run(8) <= run(1) + 0.02


def test_score_normalization(rng):
    m, t, i, z = 6, 8, 10, 12
    scores = jnp.asarray(rng.standard_normal((m, t)) + 2.0, jnp.float32)
    imp_seg = jnp.asarray(rng.standard_normal((m, z)) * 2 + 1, jnp.float32)
    imp_mod = jnp.asarray(rng.standard_normal((i, t)) * 2 + 1, jnp.float32)
    imp_cross = jnp.asarray(rng.standard_normal((i, z)) * 2 + 1, jnp.float32)
    zn = np.asarray(znorm(scores, imp_seg))
    assert zn.shape == (m, t)
    tn = np.asarray(tnorm(scores, imp_mod))
    # t-normed impostor scores should be ~N(0,1) per segment
    tn_imp = np.asarray(tnorm(imp_mod, imp_mod))
    np.testing.assert_allclose(tn_imp.mean(0), 0, atol=1e-4)
    np.testing.assert_allclose(tn_imp.std(0), 1, atol=1e-3)
    zt = np.asarray(ztnorm(scores, imp_seg, imp_mod, imp_cross))
    assert np.isfinite(zt).all()
    del tn


def test_eer_min_dcf_sanity(rng):
    tgt = rng.standard_normal(1000) + 2.0
    imp = rng.standard_normal(5000)
    e = eer(tgt, imp)
    assert 0.10 < e < 0.25   # ~15.9% for unit-var gaussians 2 apart
    d = min_dcf(tgt, imp, p_target=0.01)
    assert 0.0 < d <= 1.0
    # perfect separation
    assert eer(imp + 100.0, imp) == 0.0


def test_norm_percentile_trim_and_median_reference_semantics():
    """Oracle for DistribNorm::computeMeanStd (ComputeNorm.cpp:121-159):
    drop size*percentH highest + size*percentL lowest after descending
    sort; meanMode 1 = median location + mean-absolute-deviation scale."""
    from lia_ral.backend.norm import _stats
    rng = np.random.default_rng(0)
    sc = rng.standard_normal((4, 20))

    def oracle(row, ph, pl, median):
        srt = np.sort(row)[::-1]
        n = len(row)
        dh, dl = int(n * ph), int(n * pl)
        kept = srt[dh:n - dl]
        if median:
            mu = kept[len(kept) // 2]
            return mu, np.mean(np.abs(kept - mu))
        return np.mean(kept), np.std(kept)

    mu, sd = _stats(jnp.asarray(sc), axis=1, percent_h=0.1, percent_l=0.2)
    for i in range(4):
        m, s = oracle(sc[i], 0.1, 0.2, False)
        assert abs(float(mu[i]) - m) < 1e-5
        assert abs(float(sd[i]) - s) < 1e-5
    mu, sd = _stats(jnp.asarray(sc), axis=1, use_median=True,
                    percent_h=0.1, percent_l=0.1)
    for i in range(4):
        m, s = oracle(sc[i], 0.1, 0.1, True)
        # jnp.median interpolates on even counts; kept size here is odd (16)
        assert abs(float(sd[i]) - np.mean(np.abs(
            np.sort(sc[i])[::-1][2:18] - float(mu[i])))) < 1e-5


def test_ragged_impostor_normalization(rng):
    """Masked (ragged) impostor statistics — sparse trial matrices must
    normalise exactly as per-entity ragged lists (reference DistribNorm,
    ComputeNorm.cpp:96-365), never via a fill value."""
    m, t, z = 4, 5, 9
    scores = jnp.asarray(rng.standard_normal((m, t)) + 2.0, jnp.float32)
    imp = rng.standard_normal((m, z)).astype(np.float32) * 2 + 1
    mask = rng.random((m, z)) > 0.35
    mask[:, 0] = True                      # ≥1 present per row
    # hand-computed per-row masked stats
    zn = np.asarray(znorm(scores, jnp.asarray(np.where(mask, imp, np.nan)),
                          impostor_mask=jnp.asarray(mask)))
    for r in range(m):
        vals = imp[r][mask[r]].astype(np.float64)
        mu, sd = vals.mean(), vals.std()
        np.testing.assert_allclose(
            zn[r], (np.asarray(scores)[r] - mu) / sd, rtol=2e-4, atol=2e-4)
    # dense mask == unmasked path
    full = jnp.asarray(imp)
    ones = jnp.ones((m, z), bool)
    np.testing.assert_allclose(
        np.asarray(znorm(scores, full, impostor_mask=ones)),
        np.asarray(znorm(scores, full)), rtol=1e-5, atol=1e-5)
    # median + trimming on the masked path: lower-median element + MAD
    zn_med = np.asarray(znorm(scores, jnp.asarray(imp),
                              impostor_mask=jnp.asarray(mask),
                              use_median=True, percent_h=0.2))
    for r in range(m):
        vals = np.sort(imp[r][mask[r]].astype(np.float64))[::-1]
        dh = int(np.floor(len(vals) * 0.2))
        kept = vals[dh:]
        med = kept[(len(kept) - 1) // 2]
        mad = np.abs(kept - med).mean()
        np.testing.assert_allclose(
            zn_med[r], (np.asarray(scores)[r] - med) / mad,
            rtol=2e-4, atol=2e-4)


def test_compute_norm_tool_sparse_matrix(tmp_path, rng):
    """ComputeNorm tool end-to-end with a sparse impostor score file:
    NaN-fill distortion is gone; matches hand z-norm."""
    import os
    from lia_ral.config import Config
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools import compute_norm
    d = str(tmp_path)
    models = ["m1", "m2"]
    segs = ["s1", "s2", "s3"]
    with open(os.path.join(d, "test.nist"), "w") as f:
        for mi, mm in enumerate(models):
            for si, ss in enumerate(segs):
                f.write(f"M {mm} - {ss} {1.0 + mi + 0.1 * si}\n")
    # ragged impostor-seg scores: m1 has 3 impostor trials, m2 only 2
    imp = {("m1", "z1"): 0.5, ("m1", "z2"): 1.5, ("m1", "z3"): 2.5,
           ("m2", "z1"): -1.0, ("m2", "z3"): 3.0}
    with open(os.path.join(d, "imp.nist"), "w") as f:
        for (mm, ss), v in imp.items():
            f.write(f"M {mm} - {ss} {v}\n")
    cfg = Config({
        "normType": "znorm",
        "testNistFile": os.path.join(d, "test.nist"),
        "znormNistFile": os.path.join(d, "imp.nist"),
        "outputFileBaseName": os.path.join(d, "out.nist"),
    })
    compute_norm.main(cfg)
    out = {(l.model, l.seg): l.score
           for l in read_nist_scores(os.path.join(d, "out.nist"))}
    for mi, mm in enumerate(models):
        vals = np.array([v for (m2_, _), v in imp.items() if m2_ == mm])
        mu, sd = vals.mean(), vals.std()
        for si, ss in enumerate(segs):
            raw = 1.0 + mi + 0.1 * si
            np.testing.assert_allclose(out[(mm, ss)], (raw - mu) / sd,
                                       rtol=1e-4, atol=1e-4)


def test_efr_rank_deficient_dev_preserves_separation(rng):
    """EFR from a dev set SMALLER than the vector dimension must not
    destroy speaker separation: the singular covariance's null space is
    floored at the mean eigenvalue instead of being amplified by 1/sqrt(eps)
    (observed: cosine EER 0 -> 0.5 before the guard)."""
    import jax.numpy as jnp
    from lia_ral.backend.eval import eer
    from lia_ral.backend.ivnorm import (DevSet, apply_efr,
                                            efr_iterations)
    from lia_ral.backend.scoring import cosine_scores

    r, n_spk = 48, 8                       # 24 dev vectors << 48 dims
    spk_dir = rng.standard_normal((n_spk, r)) * 2.0
    def draw(s, n):
        return (spk_dir[s][None, :]
                + rng.standard_normal((n, r))).astype(np.float32)
    dev_v = np.concatenate([draw(s, 3) for s in range(n_spk)])
    dev = DevSet.from_labels(dev_v, [f"s{s}" for s in range(n_spk)
                                     for _ in range(3)])
    _, params = efr_iterations(dev, 2, "EFR")
    enroll = jnp.asarray(np.concatenate([draw(s, 1) for s in range(n_spk)]))
    test = jnp.asarray(np.concatenate([draw(s, 2) for s in range(n_spk)]))
    s_mat = np.asarray(cosine_scores(apply_efr(enroll, params),
                                     apply_efr(test, params)))
    tgt = [s_mat[i, j] for i in range(n_spk) for j in range(2 * n_spk)
           if j // 2 == i]
    imp = [s_mat[i, j] for i in range(n_spk) for j in range(2 * n_spk)
           if j // 2 != i]
    assert eer(np.asarray(tgt), np.asarray(imp)) < 0.1


def test_eer_negative_control(rng):
    """EER sanity: identical target/impostor distributions score ~0.5
    (chance), separated ones score the analytic overlap — guards the
    milestone EER records against an eval-code artifact."""
    from lia_ral.backend.eval import eer, min_dcf
    same_t = rng.standard_normal(4000)
    same_i = rng.standard_normal(4000)
    e_chance = eer(same_t, same_i)
    assert 0.45 < e_chance < 0.55, e_chance
    # N(1.66,1) vs N(-1.66,1): EER = Phi(-1.66) ~ 4.85%
    sep_t = rng.standard_normal(4000) + 1.66
    sep_i = rng.standard_normal(4000) - 1.66
    e_sep = eer(sep_t, sep_i)
    assert 0.035 < e_sep < 0.065, e_sep
    assert 0.0 <= min_dcf(sep_t, sep_i) <= min_dcf(same_t, same_i) <= 1.0


def test_der_metric():
    """DER: optimal mapping, miss/fa/confusion accounting, collar."""
    from lia_ral.backend.eval import der
    ref = np.asarray([0, 0, 0, 1, 1, 1, -1, -1])
    # permuted labels are error-free under optimal mapping
    assert der(ref, np.asarray([5, 5, 5, 2, 2, 2, -1, -1])) == 0.0
    # one confused frame out of 6 speech frames
    assert der(ref, np.asarray([5, 5, 2, 2, 2, 2, -1, -1])) == \
        pytest.approx(1 / 6)
    # miss and false alarm
    assert der(ref, np.asarray([5, 5, 5, 2, 2, -1, -1, 2])) == \
        pytest.approx(2 / 6)
    # collar absolves boundary frames
    assert der(ref, np.asarray([5, 5, 2, 2, 2, 2, -1, -1]),
               collar_frames=1) == 0.0
