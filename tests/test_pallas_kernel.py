"""Fused GMM statistics kernel (gmm/stats_kernel.py) against a float64
NumPy oracle and XLA's plain path.

The kernel runs here in Pallas interpret mode through the public
statistics path (gmm/stats_path.py); on the card the same checks run
compiled in chip_smoke.py.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.gmm import GmmDiag, em_stats
from lia_ral.gmm import stats_kernel, stats_path


@pytest.fixture
def kernel_path(monkeypatch):
    """Route gmm.stats_path to the fused kernel, interpreted on the host."""
    monkeypatch.setattr(stats_path, "use_kernel", lambda: True)
    monkeypatch.setattr(stats_kernel, "segment_stats", functools.partial(
        stats_kernel.segment_stats, interpret=True))


def random_gmm(rng, k, d):
    w = rng.random(k) + 0.5
    return GmmDiag.create(w / w.sum(), rng.standard_normal((k, d)),
                          rng.random((k, d)) + 0.5)


def oracle(x, w, gmm):
    """float64 (n, sum_x, sum_xx, llk) over the frame axis (-2)."""
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    m = np.asarray(gmm.means, np.float64)
    iv = np.asarray(gmm.cov_inv, np.float64)
    cst = (-0.5 * (m.shape[1] * np.log(2 * np.pi) - np.log(iv).sum(-1))
           + np.log(np.asarray(gmm.weights, np.float64))
           - 0.5 * np.sum(m * m * iv, -1))
    ld = (x * x) @ (-0.5 * iv.T) + x @ (m * iv).T + cst
    top = ld.max(-1, keepdims=True)
    lse = top[..., 0] + np.log(np.exp(ld - top).sum(-1))
    p = np.exp(ld - lse[..., None]) * w[..., None]
    pt = np.swapaxes(p, -1, -2)
    return p.sum(-2), pt @ x, pt @ (x * x), (lse * w).sum(-1)


def assert_stats(st, ref, occ=1e-4, sums=1e-4, llk=1e-5):
    n, sx, sxx, ll = ref
    np.testing.assert_allclose(np.asarray(st.n), n, rtol=occ, atol=occ)
    np.testing.assert_allclose(np.asarray(st.sum_x), sx, rtol=sums,
                               atol=sums * max(np.abs(sx).max(), 1.0))
    np.testing.assert_allclose(np.asarray(st.sum_xx), sxx, rtol=sums,
                               atol=sums * max(np.abs(sxx).max(), 1.0))
    np.testing.assert_allclose(float(st.llk), ll, rtol=llk)


@pytest.mark.parametrize("n,k,d", [(96, 8, 5), (130, 16, 7)])
def test_fused_matches_reference(rng, kernel_path, n, k, d):
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    st = stats_path.em_stats(x, w, gmm)
    assert_stats(st, oracle(x, w, gmm))
    np.testing.assert_allclose(float(st.count), float(jnp.sum(w)),
                               rtol=1e-6)


def test_fused_padding(rng, kernel_path):
    """Frames that fill no whole tile and components that fill no whole
    tile are padded with zero weights and empty components."""
    k, d, n = 5, 3, 45
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones(n, jnp.float32)
    st = stats_path.em_stats(x, w, gmm)
    assert float(st.count) == 45.0
    assert st.n.shape == (k,) and st.sum_x.shape == (k, d)
    np.testing.assert_allclose(float(jnp.sum(st.n)), 45.0, rtol=1e-5)
    assert_stats(st, oracle(x, w, gmm))


def test_fused_bf16_close_to_f32(rng, kernel_path):
    """The fastMath tier (one bf16 pass for the density product) stays
    within bf16 tolerance of the f32 tier: same posteriors up to ~1e-2."""
    n, k, d = 128, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    ref = stats_path.em_stats(x, w, gmm)
    fast = stats_path.em_stats(x, w, gmm, fast_math=True)
    np.testing.assert_allclose(np.asarray(fast.n), np.asarray(ref.n),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(np.asarray(fast.sum_x),
                               np.asarray(ref.sum_x), rtol=0.05, atol=0.1)
    np.testing.assert_allclose(np.asarray(fast.sum_xx),
                               np.asarray(ref.sum_xx), rtol=0.05, atol=0.1)
    np.testing.assert_allclose(float(fast.llk), float(ref.llk), rtol=5e-3)
    np.testing.assert_allclose(float(fast.count), float(ref.count),
                               rtol=1e-3)
    # the tier really rounds: the posteriors moved
    assert float(jnp.max(jnp.abs(fast.n - ref.n))) > 1e-6


def test_fused_bf16_em_converges_close(rng, kernel_path):
    """fastMath EM must track f32-grade EM on a properly floored
    training loop.

    Without variance flooring this toy (K=8, D=5) converges to a
    degenerate var≈1e-8 spike whose ~1e8-scale logits bf16 cannot
    represent — exactly the singularity varianceControl exists to
    prevent (TrainTools.cpp:567-592); every real training path floors.
    With flooring, bf16 EM stays within 1 % llk of the f32 path."""
    from lia_ral.gmm.em import m_step, variance_control
    n, k, d = 512, 8, 5
    centers = rng.standard_normal((k, d)) * 3.0
    lab = rng.integers(0, k, n)
    x = jnp.asarray(centers[lab] + rng.standard_normal((n, d)), jnp.float32)
    w = jnp.ones((n,), jnp.float32)
    gcov = jnp.var(x, axis=0)
    em = jax.jit(stats_path.em_stats, static_argnames=("fast_math",))
    gmm32 = gmm16 = GmmDiag.create(
        np.full(k, 1.0 / k), rng.standard_normal((k, d)),
        rng.random((k, d)) + 0.5)
    for _ in range(20):
        gmm32 = variance_control(m_step(em(x, w, gmm32)), 0.01, 10.0, gcov)
        gmm16 = variance_control(m_step(em(x, w, gmm16, fast_math=True)),
                                 0.01, 10.0, gcov)
    llk32 = float(em(x, w, gmm32).llk)
    llk16 = float(em(x, w, gmm16).llk)
    assert abs(llk32 - llk16) / abs(llk32) < 1e-2, (llk32, llk16)


def test_fused_bf16x3_matches_f32(rng, kernel_path):
    """The kernel's f32 tier (bf16×3 products on the tensor cores) stays
    within ~2^-16-level tolerance of XLA's f32 products."""
    n, k, d = 128, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    ref = em_stats(x, w, gmm)
    x3 = stats_path.em_stats(x, w, gmm)
    np.testing.assert_allclose(np.asarray(x3.n), np.asarray(ref.n),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(x3.sum_x),
                               np.asarray(ref.sum_x), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(x3.sum_xx),
                               np.asarray(ref.sum_xx), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(x3.llk), float(ref.llk), rtol=1e-5)


def test_fused_fast_stats_tier(rng, kernel_path):
    """fastStats: occupancies and llk stay f32-exact (same as the f32
    tier); only the first/second-order sums carry bf16 rounding."""
    n, k, d = 256, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    ref = stats_path.em_stats(x, w, gmm)
    fs = stats_path.em_stats(x, w, gmm, fast_stats=True)
    np.testing.assert_allclose(np.asarray(fs.n), np.asarray(ref.n),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(fs.llk), float(ref.llk), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(fs.sum_x), np.asarray(ref.sum_x),
                               rtol=2e-2, atol=2e-2)
    assert float(jnp.max(jnp.abs(fs.sum_x - ref.sum_x))) > 1e-6


def test_bw_stats_fused_matches_xla(rng, kernel_path):
    """Per-utterance BW statistics with ragged masks: kernel vs the
    vmapped XLA path and the f64 oracle, llk per utterance included."""
    from lia_ral.gmm.kernels import accumulate_bw_stats, frame_llk

    s, t, d, k = 5, 70, 7, 16
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((s, t, d)), jnp.float32)
    lens = np.asarray([70, 64, 33, 1, 50])
    mask = jnp.asarray((np.arange(t)[None] < lens[:, None])
                       & (rng.random((s, t)) > 0.3), jnp.float32)
    n, f = stats_path.bw_stats(x, mask, gmm)
    ref_n, ref_f = jax.vmap(
        lambda a, b: accumulate_bw_stats(a, b, gmm))(x, mask)
    np.testing.assert_allclose(np.asarray(n), np.asarray(ref_n),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(f), np.asarray(ref_f),
                               rtol=1e-3, atol=1e-3)
    on, of, _, ollk = oracle(x, mask, gmm)
    np.testing.assert_allclose(np.asarray(n), on, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(f), of, rtol=1e-3, atol=1e-3)
    _, _, _, llk = stats_kernel.segment_stats(x, mask, gmm)
    for i in range(s):
        want = float(jnp.sum(frame_llk(x[i], gmm) * mask[i]))
        np.testing.assert_allclose(float(llk[i]), want, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(float(llk[i]), ollk[i], rtol=1e-5,
                                   atol=1e-4)


def test_bw_stats_fused_default_block_paths(rng, kernel_path):
    """Utterance lengths on, off and beyond a whole number of frame
    tiles (64, 61, 2060) agree with the XLA path."""
    from lia_ral.gmm.kernels import accumulate_bw_stats

    d, k = 5, 16
    gmm = random_gmm(rng, k, d)
    for t in (64, 61, 2060):
        x = jnp.asarray(rng.standard_normal((3, t, d)), jnp.float32)
        mask = jnp.asarray(rng.random((3, t)) > 0.3, jnp.float32)
        n, f = stats_path.bw_stats(x, mask, gmm)
        ref_n, ref_f = jax.vmap(
            lambda a, b: accumulate_bw_stats(a, b, gmm))(x, mask)
        f_scale = max(float(np.max(np.abs(np.asarray(ref_f)))), 1.0)
        np.testing.assert_allclose(np.asarray(n), np.asarray(ref_n),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(f), np.asarray(ref_f),
                                   rtol=1e-3, atol=1e-3 * f_scale)


# (fast_math, fast_stats): the f32-grade default, each flag, both
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("fast_math,fast_stats,occ,sums",
                         [(False, False, 1e-4, 1e-4),
                          (False, True, 1e-4, 2e-2),
                          (True, False, 0.1, 0.1),
                          (True, True, 0.1, 0.1)])
def test_xla_tiers_match_oracle(rng, fast_math, fast_stats, occ, sums):
    """XLA's plain path (every non-GPU backend) honours the same
    precision flags: each within its stated rounding of the f64 oracle."""
    from lia_ral.gmm.kernels import em_stats_chunked

    n, k, d = 300, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    st = em_stats_chunked(x, w, gmm, chunk=128, fast_math=fast_math,
                          fast_stats=fast_stats)
    assert_stats(st, oracle(x, w, gmm), occ=occ, sums=sums,
                 llk=1e-2 if fast_math else 1e-5)


@pytest.mark.parametrize("fast_math,fast_stats", FLAGS)
def test_kernel_tiers_match_xla_tiers(rng, kernel_path, fast_math,
                                      fast_stats):
    """Each pair of precision flags means the same arithmetic on both
    paths."""
    from lia_ral.gmm.kernels import em_stats_chunked

    n, k, d = 200, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    flags = dict(fast_math=fast_math, fast_stats=fast_stats)
    kern = stats_path.em_stats(x, w, gmm, **flags)
    xla = em_stats_chunked(x, w, gmm, chunk=64, **flags)
    tol = 3e-2 if fast_math or fast_stats else 1e-4
    np.testing.assert_allclose(np.asarray(kern.n), np.asarray(xla.n),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(kern.sum_x), np.asarray(xla.sum_x),
                               rtol=tol, atol=tol)


def test_fused_under_shard_map(rng, kernel_path):
    """numThread sharding runs the kernel on every shard inside
    shard_map and psums the statistics: sharded == one device."""
    from lia_ral.parallel import make_mesh
    from lia_ral.parallel.sharding import sharded_stats_fn

    n, k, d = 1000, 16, 7
    gmm = random_gmm(rng, k, d)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    want = stats_path.em_stats(x, w, gmm)
    got = sharded_stats_fn(make_mesh(n_data=4))(x, w, gmm)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
