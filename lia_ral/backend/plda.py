"""Gaussian PLDA: x = μ + F·h + G·u + ε,  ε ~ N(0, Σ).

JAX equivalent of reference ``PldaModel`` (PldaTools.cpp:2043-2948):
initTrain (cpp:2043), em_iteration (cpp:2329), getExpectedValues
(cpp:2346-2789 — the joint (h, u_i) posterior with per-session-count
grouping), mStep (cpp:2790 — [F G] update + minimum divergence), and
pldaNativeScoring (cpp:4489-4610 — per-session-count constants + batched
bilinear forms).

The per-speaker E-step loop of the reference becomes a vmap over speakers
(session sums precomputed with one-hot matmuls); the per-session-count
caching of L⁻¹ becomes a batched solve with n as data.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..pytree import dataclass as pytree_dataclass
from .ivnorm import DevSet


@pytree_dataclass
class PldaModel:
    mean: jax.Array    # (R,)
    f: jax.Array       # (R, rankF) eigenvoices
    g: jax.Array       # (R, rankG) eigenchannels (rankG may be 0)
    sigma: jax.Array   # (R, R) residual covariance (full)

    @property
    def rank_f(self) -> int:
        return self.f.shape[1]

    @property
    def rank_g(self) -> int:
        return self.g.shape[1]

    def within_cov(self) -> jax.Array:
        """W̃ = G·Gᵀ + Σ — the effective within-speaker covariance."""
        return self.g @ self.g.T + self.sigma

    def save(self, path: str) -> None:
        np.savez(path, mean=np.asarray(self.mean), f=np.asarray(self.f),
                 g=np.asarray(self.g), sigma=np.asarray(self.sigma))

    @classmethod
    def load(cls, path: str) -> "PldaModel":
        z = np.load(path)
        return cls(mean=jnp.asarray(z["mean"]), f=jnp.asarray(z["f"]),
                   g=jnp.asarray(z["g"]), sigma=jnp.asarray(z["sigma"]))

    # -- reference on-disk format (PldaModel::saveModel, PldaTools.cpp:
    # 2816-2948): five .matx files — mean (R,1), F (R,rankF), G (R,rankG),
    # Sigma (R,R), minDivMean (R,1) ----------------------------------------
    def save_reference(self, mean_path: str, f_path: str, g_path: str,
                       sigma_path: str, min_div_mean_path: str) -> None:
        from ..io.matrix import write_matrix_file
        write_matrix_file(mean_path, np.asarray(self.mean,
                                                np.float64)[:, None])
        write_matrix_file(f_path, np.asarray(self.f, np.float64))
        write_matrix_file(g_path, np.asarray(self.g, np.float64))
        write_matrix_file(sigma_path, np.asarray(self.sigma, np.float64))
        write_matrix_file(min_div_mean_path,
                          np.asarray(self.mean, np.float64)[:, None])

    @classmethod
    def load_reference(cls, mean_path: str, f_path: str, g_path: str | None,
                       sigma_path: str) -> "PldaModel":
        from ..io.matrix import read_matrix_file
        mean = read_matrix_file(mean_path).ravel()
        f = read_matrix_file(f_path)
        sigma = read_matrix_file(sigma_path)
        g = (read_matrix_file(g_path) if g_path
             else np.zeros((f.shape[0], 0)))
        if g.ndim == 1:
            g = g.reshape(f.shape[0], -1)
        return cls(mean=jnp.asarray(mean, jnp.float32),
                   f=jnp.asarray(f, jnp.float32),
                   g=jnp.asarray(g, jnp.float32),
                   sigma=jnp.asarray(sigma, jnp.float32))

    @classmethod
    def init(cls, key: jax.Array, dim: int, rank_f: int, rank_g: int = 0,
             data_mean=None, data_cov=None) -> "PldaModel":
        """Random init (reference initTrain, cpp:2043: F/G random from the
        observed distribution, Σ = observed covariance)."""
        kf, kg = jax.random.split(key)
        f = jax.random.normal(kf, (dim, rank_f), jnp.float32) * 0.1
        g = jax.random.normal(kg, (dim, rank_g), jnp.float32) * 0.1
        mean = (jnp.zeros((dim,), jnp.float32) if data_mean is None
                else jnp.asarray(data_mean, jnp.float32))
        sigma = (jnp.eye(dim, dtype=jnp.float32) if data_cov is None
                 else jnp.asarray(data_cov, jnp.float32))
        return cls(mean=mean, f=f, g=g, sigma=sigma)


def _speaker_layout(dev: DevSet):
    """one-hot (N,S), per-speaker session counts (S,)."""
    one_hot = jax.nn.one_hot(dev.spk_ids, dev.n_speakers, dtype=jnp.float32)
    counts = one_hot.sum(axis=0)
    return one_hot, counts


def plda_em_core(model: PldaModel, x_raw: jax.Array, spk_ids: jax.Array,
                 n_speakers: int, w: jax.Array | None = None,
                 reduce_fn=None) -> PldaModel:
    """One EM iteration over a (possibly LOCAL SHARD of the) session set.

    ``x_raw`` (N,R) session vectors, ``spk_ids`` (N,) speaker index,
    ``w`` (N,) 1/0 session weights (0 = padding row), ``reduce_fn``
    merges cross-session sums across shards (identity when serial,
    ``lax.psum`` inside shard_map — the device shape of the reference's
    threaded getExpectedValues with mutex-guarded accumulators,
    PldaTools.cpp:2647-2664).  The speaker-level solves are replicated:
    they are (S,rf,rf) batched inverses, identical on every shard, so
    sharded == serial exactly."""
    if w is None:
        w = jnp.ones(x_raw.shape[0], x_raw.dtype)
    if reduce_fn is None:
        def reduce_fn(v):
            return v
    x = (x_raw - model.mean[None, :]) * w[:, None]   # pad rows → 0
    r = x.shape[1]
    rf, rg = model.rank_f, model.rank_g
    n_tot = reduce_fn(jnp.sum(w))
    inv_sigma = jnp.linalg.inv(model.sigma)
    ftw = model.f.T @ inv_sigma                     # (rf, R)
    gtw = model.g.T @ inv_sigma                     # (rg, R)
    ftwf = ftw @ model.f
    ftwg = ftw @ model.g                            # (rf, rg)
    q = jnp.linalg.inv(jnp.eye(rg) + gtw @ model.g) if rg else jnp.zeros((0, 0))
    s = q @ ftwg.T if rg else jnp.zeros((0, rf))    # (rg, rf)
    a = ftwf - (ftwg @ q @ ftwg.T if rg else 0.0)   # (rf, rf)

    one_hot = jax.nn.one_hot(spk_ids, n_speakers, dtype=x.dtype) \
        * w[:, None]                                # (N,S) pad rows zeroed
    counts = reduce_fn(one_hot.sum(axis=0))         # (S,)
    fx = x @ ftw.T                                  # (N, rf) per-session f_i
    gx = x @ gtw.T if rg else jnp.zeros((x.shape[0], 0))     # (N, rg)
    f_sum = reduce_fn(one_hot.T @ fx)               # (S, rf)
    g_sum = reduce_fn(one_hot.T @ gx)               # (S, rg)

    eye_f = jnp.eye(rf)
    l_mat = eye_f[None] + counts[:, None, None] * a[None]     # (S,rf,rf)
    m_cov = jnp.linalg.inv(l_mat)                              # (S,rf,rf)
    rhs = f_sum - (g_sum @ s if rg else 0.0)                   # (S,rf)
    eh = jnp.einsum("sij,sj->si", m_cov, rhs)                  # (S,rf)
    eh_per = eh[spk_ids] * w[:, None]                          # (N,rf)
    if rg:
        eu = gx @ q.T - eh_per @ s.T                           # (N,rg)
    else:
        eu = jnp.zeros((x.shape[0], 0))

    # joint latent per session y_i = [h_spk; u_i]
    y = jnp.concatenate([eh_per, eu], axis=1)                  # (N, rf+rg)
    # second-moment accumulators: E[y yᵀ] = cov + E[y]E[y]ᵀ
    ehh = reduce_fn(jnp.einsum("ni,nj->ij", y, y))
    # covariance blocks (reference tmpM, cpp:2460-2470) — per SESSION,
    # expressed via per-speaker counts so no (N,rf,rf) gather is needed
    cov_hh = jnp.einsum("s,sij->ij", counts, m_cov)            # (rf,rf)
    if rg:
        msum_t = cov_hh @ s.T                                  # (rf,rg)
        cov_hu = -msum_t
        cov_uu = n_tot * q + s @ msum_t
        cov = jnp.block([[cov_hh, cov_hu], [cov_hu.T, cov_uu]])
    else:
        cov = cov_hh
    ehh_sum = ehh + cov                                        # (rf+rg)²
    xh_sum = reduce_fn(x.T @ y)                                # (R, rf+rg)

    # M-step: [F G] = xhSum · EhhSum⁻¹ (reference mStep cpp:2790-2815)
    fg = jnp.linalg.solve(ehh_sum.T, xh_sum.T).T               # (R, rf+rg)
    f_new = fg[:, :rf]
    g_new = fg[:, rf:]
    sigma_obs = reduce_fn(x.T @ x) / n_tot
    sigma_new = sigma_obs - (fg @ xh_sum.T) / n_tot
    sigma_new = 0.5 * (sigma_new + sigma_new.T) \
        + 1e-6 * jnp.eye(r, dtype=x.dtype)
    # minimum divergence on h: whiten by the posterior second moment of h
    hh = (eh.T @ eh + jnp.sum(m_cov, axis=0)) / n_speakers
    chol = jnp.linalg.cholesky(hh + 1e-9 * jnp.eye(rf))
    f_new = f_new @ chol
    if rg:
        uu = (reduce_fn(jnp.einsum("ni,nj->ij", eu, eu)) + cov_uu) / n_tot
        chol_u = jnp.linalg.cholesky(uu + 1e-9 * jnp.eye(rg))
        g_new = g_new @ chol_u
    # mean update (reference _Delta): fold the residual data mean back in
    mean_new = model.mean + reduce_fn(jnp.sum(x, axis=0)) / n_tot
    return model.replace(mean=mean_new, f=f_new, g=g_new, sigma=sigma_new)


def plda_em_iteration(model: PldaModel, dev: DevSet) -> PldaModel:
    """One EM iteration (reference em_iteration cpp:2329-2344 +
    getExpectedValues + mStep)."""
    return plda_em_core(model, dev.vectors, dev.spk_ids, dev.n_speakers)


def plda_train(key: jax.Array, dev: DevSet, rank_f: int, rank_g: int = 0,
               n_iterations: int = 10, verbose: bool = False,
               init: PldaModel | None = None, mesh=None) -> PldaModel:
    """Full trainer (reference PLDA.cpp:74-99: center → EM loop → save).
    ``init`` warm-starts EM from a loaded model (pldaLoadInitMatrices);
    ``mesh`` shards the session axis of each EM iteration over its
    "data" axis (the threaded getExpectedValues, PldaTools.cpp:2647)."""
    x = dev.vectors
    mean = jnp.mean(x, axis=0)
    xc = x - mean[None, :]
    cov = (xc.T @ xc) / x.shape[0]
    model = init if init is not None else PldaModel.init(
        key, x.shape[1], rank_f, rank_g, data_mean=mean, data_cov=cov)
    for it in range(n_iterations):
        if mesh is not None:
            from ..parallel.sharding import sharded_plda_em_iteration
            model = sharded_plda_em_iteration(mesh, model, dev)
        else:
            model = plda_em_iteration(model, dev)
        if verbose:
            print(f"PLDA EM it {it}: |F|={float(jnp.abs(model.f).mean()):.5f} "
                  f"tr(Sigma)={float(jnp.trace(model.sigma)):.4f}")
    return model


def _gaussian_logpdf_terms(cov: jax.Array):
    """(inverse, logdet) of a covariance."""
    chol = jnp.linalg.cholesky(cov)
    inv = jax.scipy.linalg.cho_solve((chol, True),
                                     jnp.eye(cov.shape[0], dtype=cov.dtype))
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return inv, logdet


@functools.partial(jax.jit, static_argnames=())
def plda_llr(model: PldaModel, enroll: jax.Array, n_sessions: jax.Array,
             test: jax.Array) -> jax.Array:
    """Batched PLDA verification LLR (reference pldaNativeScoring,
    cpp:4489-4610).

    enroll: (M, R) per-model MEAN of its enrollment i-vectors;
    n_sessions: (M,) number of enrollment sessions per model;
    test: (T, R).  Returns (M, T) scores.

    LLR(m, t) = log N(t; F·ĥ_m, F·C_m·Fᵀ + W̃) − log N(t; 0, F·Fᵀ + W̃)
    with ĥ_m, C_m the h-posterior given the m's sessions — the reference's
    per-#session constants K_L appear here as the n-dependent (C_m-based)
    covariance terms, computed batched over models.
    """
    w_cov = model.within_cov()
    r = model.mean.shape[0]
    rf = model.rank_f
    w_inv, _ = _gaussian_logpdf_terms(w_cov)
    p = model.f.T @ w_inv                         # (rf, R)
    a = p @ model.f                               # (rf, rf)
    xe = enroll - model.mean[None, :]
    xt = test - model.mean[None, :]
    # h posterior per model: L_m = I + n_m·A ; ĥ = L⁻¹·n·P·x̄
    l_mat = jnp.eye(rf)[None] + n_sessions[:, None, None] * a[None]
    f_stat = n_sessions[:, None] * (xe @ p.T)     # (M, rf)
    h_hat = jnp.linalg.solve(l_mat, f_stat[..., None])[..., 0]
    c_m = jnp.linalg.inv(l_mat)                   # (M, rf, rf)
    mu_t = h_hat @ model.f.T                      # (M, R) predicted test mean

    # same-speaker covariance per model: F·C_m·Fᵀ + W̃ — depends on n only
    # through C_m; batch over models
    cov_same = jnp.einsum("ri,mij,qj->mrq", model.f, c_m, model.f) \
        + w_cov[None]
    chol_same = jnp.linalg.cholesky(cov_same)
    logdet_same = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol_same, axis1=1, axis2=2)), axis=1)  # (M,)
    # quadratic form per (m, t): (t−μ_m)ᵀ cov_same⁻¹ (t−μ_m)
    diff = xt[None, :, :] - mu_t[:, None, :]      # (M, T, R)
    sol = jax.scipy.linalg.cho_solve(
        (chol_same, True), jnp.swapaxes(diff, 1, 2))          # (M, R, T)
    quad_same = jnp.einsum("mtr,mrt->mt", diff, sol)

    cov_diff = model.f @ model.f.T + w_cov
    inv_diff, logdet_diff = _gaussian_logpdf_terms(cov_diff)
    quad_diff = jnp.einsum("tr,rq,tq->t", xt, inv_diff, xt)   # (T,)

    del r
    return 0.5 * (quad_diff[None, :] - quad_same
                  + logdet_diff - logdet_same[:, None])
