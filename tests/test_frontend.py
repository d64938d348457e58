import numpy as np

import jax.numpy as jnp

from lia_ral.frontend import (
    EnergyDetectorCfg, MfccCfg, add_deltas, cmvn_global, cmvn_segmental,
    cmvn_window, energy_detector, feature_warping, mfcc,
    shifted_delta_cepstra,
)


def test_cmvn_global(rng):
    x = jnp.asarray(rng.standard_normal((500, 6)) * 3 + 5, jnp.float32)
    w = jnp.ones(500, jnp.float32)
    y = np.asarray(cmvn_global(x, w))
    np.testing.assert_allclose(y.mean(0), 0, atol=1e-4)
    np.testing.assert_allclose(y.std(0), 1, atol=1e-3)
    # cms-only keeps variance
    y2 = np.asarray(cmvn_global(x, w, cms_only=True))
    np.testing.assert_allclose(y2.mean(0), 0, atol=1e-4)
    np.testing.assert_allclose(y2.std(0), np.asarray(x).std(0), rtol=1e-4)


def test_cmvn_global_respects_mask(rng):
    x = rng.standard_normal((100, 3)).astype(np.float32)
    w = (rng.random(100) > 0.5).astype(np.float32)
    y = np.asarray(cmvn_global(jnp.asarray(x), jnp.asarray(w)))
    sel = w > 0
    np.testing.assert_allclose((y[sel]).mean(0), 0, atol=1e-4)


def test_cmvn_segmental(rng):
    x = np.concatenate([rng.standard_normal((50, 2)) + 10,
                        rng.standard_normal((50, 2)) - 10]).astype(np.float32)
    ids = np.repeat([0, 1], 50)
    y = np.asarray(cmvn_segmental(jnp.asarray(x), jnp.asarray(ids),
                                  jnp.ones(100), 2))
    np.testing.assert_allclose(y[:50].mean(0), 0, atol=1e-3)
    np.testing.assert_allclose(y[50:].mean(0), 0, atol=1e-3)


def test_cmvn_window_matches_naive(rng):
    n, d, win = 60, 2, 11
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.asarray(cmvn_window(jnp.asarray(x), jnp.ones(n), win,
                               global_fallback=False))
    half = win // 2
    for t in (0, 17, 30, n - 1):
        lo, hi = max(t - half, 0), min(t + half + 1, n)
        seg = x[lo:hi]
        exp = (x[t] - seg.mean(0)) / np.sqrt(
            np.maximum(seg.var(0), 1e-8))
        np.testing.assert_allclose(y[t], exp, rtol=1e-3, atol=1e-3)


def test_feature_warping_gaussianises(rng):
    # strongly skewed input → output approx N(0,1) per coeff
    x = (rng.exponential(1.0, (2000, 3)) ** 2).astype(np.float32)
    y = np.asarray(feature_warping(jnp.asarray(x), jnp.ones(2000), 301))
    assert abs(y.mean()) < 0.1
    assert abs(y.std() - 1.0) < 0.15
    # monotone within a window: higher input rank → higher output
    assert y.shape == x.shape


def test_energy_detector_separates(rng):
    # bimodal energy: silence around -1.5, speech around +1.5
    n = 2000
    is_speech = rng.random(n) > 0.4
    energy = np.where(is_speech, 1.5 + 0.3 * rng.standard_normal(n),
                      -1.5 + 0.3 * rng.standard_normal(n))
    # alpha=1.0: with variance flooring at 0.5x the (bimodal) global
    # variance the component sigma is ~1, so mean-alpha*sigma lands between
    # the modes
    mask = energy_detector(energy.astype(np.float32), np.ones(n, np.float32),
                           EnergyDetectorCfg(nb_train_it=8, alpha=1.0,
                                             mixture_distrib_count=3))
    agree = (mask == is_speech).mean()
    assert agree > 0.95, agree


def test_energy_detector_weight_mode(rng):
    n = 2000
    is_speech = rng.random(n) > 0.5
    energy = np.where(is_speech, 2.0 + 0.3 * rng.standard_normal(n),
                      -2.0 + 0.3 * rng.standard_normal(n))
    mask = energy_detector(
        energy.astype(np.float32), np.ones(n, np.float32),
        EnergyDetectorCfg(nb_train_it=8, threshold_mode="weight"))
    agree = (mask == is_speech).mean()
    assert agree > 0.9, agree


def test_mfcc_shapes(rng):
    sig = rng.standard_normal(8000).astype(np.float32)  # 1 s @ 8 kHz
    feats = np.asarray(mfcc(jnp.asarray(sig), MfccCfg(n_ceps=19)))
    assert feats.shape == (99, 20)  # 19 ceps + energy
    assert np.isfinite(feats).all()
    both = np.asarray(add_deltas(jnp.asarray(feats)))
    assert both.shape == (99, 40)


def test_mfcc_detects_tone_frequency(rng):
    # a pure tone should produce stable (low-variance) cepstra vs noise
    t = np.arange(16000) / 8000.0
    tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    f_tone = np.asarray(mfcc(jnp.asarray(tone)))
    noise = rng.standard_normal(16000).astype(np.float32)
    f_noise = np.asarray(mfcc(jnp.asarray(noise)))
    assert f_tone[:, :19].std(0).mean() < f_noise[:, :19].std(0).mean()


def test_sdc_shape_and_edges(rng):
    x = jnp.asarray(rng.standard_normal((100, 12)), jnp.float32)
    y = np.asarray(shifted_delta_cepstra(x, n=7, d=1, p=3, k=7))
    assert y.shape == (100, 49)
    assert np.isfinite(y).all()
