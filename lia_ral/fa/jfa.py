"""Joint Factor Analysis engine: M_{s,h} = m + V·y_s + U·x_h + D·z_s.

array re-design of reference ``AccumulateJFAStat`` (SURVEY.md §2.1,
4865 LoC of per-speaker/per-session loops) driven by the tool flows:

* EigenVoice (EigenVoice.cpp:71-163): iterate {estimateVEVT,
  estimateAndInverseL_EV, substractMplusDZ, substractUX, estimateYandV,
  updateVestimate, orthonormalizeV};
* EigenChannel (EigenChannel.cpp:70-200): Y with V fixed, then iterate
  {estimateUEUT, estimateAndInverseL_EC, substractMplusVYplusDZ,
  estimateXandU};
* EstimateDMatrix (EstimateDMatrix.cpp:105-212): MAP-like per-speaker
  residual with relevance factor (estimateZMAP,
  AccumulateJFAStat.cpp:3576);
* speaker-model synthesis getSpeakerModel = m + V·y + U·x + D·z
  (AccumulateJFAStat.cpp:4605).

Everything reuses the TV primitives: subspaces are (R, K, D) pytrees, the
per-entity L-solves are batched Cholesky factorisations, accumulators are
einsums (psum-able).  Session↔speaker bookkeeping (reference JFATranslate)
is an integer index array.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..pytree import dataclass as pytree_dataclass
from ..gmm.model import GmmDiag
from .stats import BwStats


@pytree_dataclass
class JfaModel:
    v: jax.Array            # (Rv, K, D) eigenvoices
    u: jax.Array            # (Ru, K, D) eigenchannels
    d: jax.Array            # (K, D)    diagonal residual
    ubm_means: jax.Array    # (K, D)
    ubm_inv_var: jax.Array  # (K, D)

    @property
    def rank_v(self) -> int:
        return self.v.shape[0]

    @property
    def rank_u(self) -> int:
        return self.u.shape[0]

    @classmethod
    def init(cls, key: jax.Array, rank_v: int, rank_u: int, gmm: GmmDiag,
             scale: float = 0.001) -> "JfaModel":
        """Box-Muller random init of V and U, D zeroed (reference
        initEV/initEC/initD, AccumulateJFAStat.cpp:1070-1176)."""
        k, d = gmm.means.shape
        kv, ku = jax.random.split(key)
        return cls(
            v=jax.random.normal(kv, (rank_v, k, d), jnp.float32) * scale,
            u=jax.random.normal(ku, (rank_u, k, d), jnp.float32) * scale,
            d=jnp.zeros((k, d), jnp.float32),
            ubm_means=jnp.asarray(gmm.means, jnp.float32),
            ubm_inv_var=jnp.asarray(gmm.cov_inv, jnp.float32),
        )

    def supervector(self, y: jax.Array, x: jax.Array, z: jax.Array
                    ) -> jax.Array:
        """m + V·y + U·x + D·z — (K, D) mean offset of one session
        (reference getSpeakerModel, cpp:4605)."""
        return (self.ubm_means
                + jnp.einsum("r,rkd->kd", y, self.v)
                + jnp.einsum("r,rkd->kd", x, self.u)
                + self.d * z)

    def speaker_gmm(self, y: jax.Array, z: jax.Array,
                    weights: jax.Array) -> GmmDiag:
        means = (self.ubm_means + jnp.einsum("r,rkd->kd", y, self.v)
                 + self.d * z)
        return GmmDiag(weights=weights, means=means,
                       cov_inv=self.ubm_inv_var)


@pytree_dataclass
class JfaStats:
    """Per-speaker and per-session Baum-Welch stats (reference _statN,
    _statF / _statN_h, _statF_X_h) + session→speaker index."""

    spk: BwStats            # n (S,K), f (S,K,D)
    sess: BwStats           # n (H,K), f (H,K,D)
    sess_spk: jax.Array     # (H,) int32

    @classmethod
    def from_sessions(cls, sess: BwStats, sess_spk, n_speakers: int
                      ) -> "JfaStats":
        """Aggregate session stats into speaker stats (reference stacks
        them at accumulation time, cpp:501-691)."""
        sess_spk = jnp.asarray(np.asarray(sess_spk, np.int32))
        one_hot = jax.nn.one_hot(sess_spk, n_speakers, dtype=sess.n.dtype)
        n_spk = one_hot.T @ sess.n
        f_spk = jnp.einsum("hs,hkd->skd", one_hot, sess.f)
        return cls(spk=BwStats(n=n_spk, f=f_spk), sess=sess,
                   sess_spk=sess_spk)


def _subspace_gram(t: jax.Array, inv_var: jax.Array) -> jax.Array:
    """E_c = T_c Σ_c⁻¹ T_cᵀ — (K, R, R) (reference estimateVEVT/UEUT,
    cpp:1255/1415)."""
    return jnp.einsum("rkd,kd,qkd->krq", t, inv_var, t,
                      preferred_element_type=jnp.float32)


def _latent_posterior(t: jax.Array, inv_var: jax.Array, gram: jax.Array,
                      n: jax.Array, fbar: jax.Array):
    """Posterior of a latent with prior N(0,I) through subspace ``t``.

    n (B,K), fbar (B,K,D) residual first-order stats.
    Returns (mean (B,R), cov=L⁻¹ (B,R,R)) — reference
    estimateAndInverseL_EV/_EC (cpp:1959/2127).
    """
    r = t.shape[0]
    eye = jnp.eye(r, dtype=n.dtype)
    l_mat = eye[None] + jnp.einsum("bk,krq->brq", n, gram,
                                   preferred_element_type=jnp.float32)
    aux = jnp.einsum("rkd,kd,bkd->br", t, inv_var, fbar,
                     preferred_element_type=jnp.float32)
    chol = jnp.linalg.cholesky(l_mat)
    mean = jax.scipy.linalg.cho_solve((chol, True), aux[..., None])[..., 0]
    cov = jax.scipy.linalg.cho_solve(
        (chol, True), jnp.broadcast_to(eye, l_mat.shape))
    return mean, cov


def _center(stats: BwStats, model: JfaModel) -> jax.Array:
    """F − N·m (reference substractM equivalent)."""
    return stats.f - stats.n[..., None] * model.ubm_means[None]


def _subtract(fbar: jax.Array, n: jax.Array, offset: jax.Array) -> jax.Array:
    """F̄ − N·offset for a per-entity (B,K,D) mean offset (reference
    substractMplusDZ / substractUX / substractMplusVYplusDZ family,
    cpp:3795/4142/4390)."""
    return fbar - n[..., None] * offset


def _session_offsets_ux(model: JfaModel, x: jax.Array) -> jax.Array:
    """U·x_h per session — (H, K, D)."""
    return jnp.einsum("hr,rkd->hkd", x, model.u)


def _speaker_ux_stats(stats: JfaStats, model: JfaModel, x: jax.Array,
                      n_speakers: int) -> jax.Array:
    """Σ_{h∈s} N_h·(U·x_h) — the channel part to remove from SPEAKER
    stats (reference substractUX, cpp:4142)."""
    ux = _session_offsets_ux(model, x)                       # (H,K,D)
    contrib = stats.sess.n[..., None] * ux                   # (H,K,D)
    one_hot = jax.nn.one_hot(stats.sess_spk, n_speakers,
                             dtype=contrib.dtype)
    return jnp.einsum("hs,hkd->skd", one_hot, contrib)


# -- latent estimation --------------------------------------------------------

def estimate_y(stats: JfaStats, model: JfaModel, x: jax.Array,
               z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Speaker factors y given channel factors x and residual z
    (reference estimateY, cpp:2857).  Returns (y (S,Rv), cov (S,Rv,Rv))."""
    s = stats.spk.n.shape[0]
    gram = _subspace_gram(model.v, model.ubm_inv_var)
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, model.d[None] * z)
    fbar = fbar - _speaker_ux_stats(stats, model, x, s)
    return _latent_posterior(model.v, model.ubm_inv_var, gram,
                             stats.spk.n, fbar)


def estimate_x(stats: JfaStats, model: JfaModel, y: jax.Array,
               z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Channel factors x per session given y and z (reference estimateX,
    cpp:3252)."""
    gram = _subspace_gram(model.u, model.ubm_inv_var)
    fbar = _center(stats.sess, model)
    spk_off = (jnp.einsum("sr,rkd->skd", y, model.v)
               + model.d[None] * z)                          # (S,K,D)
    fbar = _subtract(fbar, stats.sess.n, spk_off[stats.sess_spk])
    return _latent_posterior(model.u, model.ubm_inv_var, gram,
                             stats.sess.n, fbar)


def estimate_z_map(stats: JfaStats, model: JfaModel, y: jax.Array,
                   x: jax.Array, tau: float = 10.0) -> jax.Array:
    """MAP residual z per speaker with relevance factor τ (reference
    estimateZMAP, cpp:3576): z = D·Σ⁻¹·F̃ / (τ + N) elementwise per (k,d)
    with prior weight τ."""
    s = stats.spk.n.shape[0]
    fbar = _center(stats.spk, model)
    fbar = fbar - stats.spk.n[..., None] * jnp.einsum(
        "sr,rkd->skd", y, model.v)
    fbar = fbar - _speaker_ux_stats(stats, model, x, s)
    num = model.d[None] * model.ubm_inv_var[None] * fbar      # (S,K,D)
    den = tau + stats.spk.n[..., None] * (
        model.d[None] ** 2 * model.ubm_inv_var[None])
    return num / den


def estimate_yx_joint(stats: JfaStats, model: JfaModel, z: jax.Array
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Joint (y, x) posterior per SPEAKER over the stacked [V; U]
    subspace — reference estimateVUEVUT (AccumulateJFAStat.cpp:1573,
    Gram of the concatenated subspace) + estimateAndInverseL_VU
    (cpp:2289) + estimateYX/splitYX (cpp:3518/3772), the enrollment path
    of TrainTargetJFA (TrainTarget.cpp:521-536).  In this mode the
    channel factor is tied per speaker (_YX is (n_speakers, Rv+Ru)): all
    of a speaker's enrollment sessions share one x.

    Returns (y (S,Rv), x_spk (S,Ru), joint posterior cov (S,Rv+Ru,Rv+Ru)).
    """
    rv = model.rank_v
    vu = jnp.concatenate([model.v, model.u], axis=0)          # (Rv+Ru,K,D)
    gram = _subspace_gram(vu, model.ubm_inv_var)
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, model.d[None] * z)    # substractMplusDZ
    yx, cov = _latent_posterior(vu, model.ubm_inv_var, gram,
                                stats.spk.n, fbar)
    return yx[:, :rv], yx[:, rv:], cov


def estimate_z_joint(stats: JfaStats, model: JfaModel, y: jax.Array,
                     x_spk: jax.Array, tau: float = 10.0) -> jax.Array:
    """MAP residual z per speaker AFTER a joint (y, x) estimate —
    reference substractMplusVUYX + estimateZ (TrainTarget.cpp:538-541):
    the channel offset here uses the speaker-tied x, not per-session
    factors."""
    offset = (jnp.einsum("sr,rkd->skd", y, model.v)
              + jnp.einsum("sr,rkd->skd", x_spk, model.u))
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, offset)
    num = model.d[None] * model.ubm_inv_var[None] * fbar
    den = tau + stats.spk.n[..., None] * (
        model.d[None] ** 2 * model.ubm_inv_var[None])
    return num / den


def enroll_targets_joint(stats: JfaStats, model: JfaModel,
                         tau: float = 10.0
                         ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """TrainTargetJFA enrollment (TrainTarget.cpp:393-560): one batched
    joint (y, x) estimate over [V; U] followed by the residual z —
    replaces the reference's per-speaker storeAccs/substract/restore
    choreography with pure-functional batched algebra.  Returns
    (y (S,Rv), x_spk (S,Ru), z (S,K,D))."""
    z0 = jnp.zeros_like(stats.spk.f)
    y, x_spk, _ = estimate_yx_joint(stats, model, z0)
    z = estimate_z_joint(stats, model, y, x_spk, tau)
    return y, x_spk, z


def store_accs(stats: JfaStats) -> JfaStats:
    """Reference storeAccs (AccumulateJFAStat.cpp:3777): snapshot the
    N/F accumulators before the in-place substract* mutations of an EM
    substep.  Our stats are immutable jax pytrees, so the snapshot is
    the identity — kept as explicit API so tool flows mirror the
    reference's storeAccs/restoreAccs pairing (EigenVoice.cpp:117/150)
    and so host code can hold a named pre-substep reference."""
    return stats


def restore_accs(snapshot: JfaStats) -> JfaStats:
    """Reference restoreAccs (AccumulateJFAStat.cpp:3786): return the
    pre-substep accumulators.  See store_accs — with immutable stats the
    snapshot IS the accumulator state."""
    return snapshot


def save_accs_npz(path: str, stats: JfaStats) -> None:
    """Durable between-substep checkpoint of the full JFA accumulator
    state (sessions + speaker aggregation + index) — the crash-recovery
    flavour of storeAccs (the reference keeps them in RAM; loadAccs-style
    restart is our file-DAG recovery model)."""
    np.savez(path, spk_n=np.asarray(stats.spk.n),
             spk_f=np.asarray(stats.spk.f),
             sess_n=np.asarray(stats.sess.n),
             sess_f=np.asarray(stats.sess.f),
             sess_spk=np.asarray(stats.sess_spk))


def load_accs_npz(path: str) -> JfaStats:
    z = np.load(path)
    return JfaStats(
        spk=BwStats(n=jnp.asarray(z["spk_n"]), f=jnp.asarray(z["spk_f"])),
        sess=BwStats(n=jnp.asarray(z["sess_n"]),
                     f=jnp.asarray(z["sess_f"])),
        sess_spk=jnp.asarray(z["sess_spk"]))


def orthonormalize_v(model: JfaModel) -> JfaModel:
    """Row-orthonormalise V in supervector layout — reference
    orthonormalizeV (AccumulateJFAStat.cpp:4700, plain Gram-Schmidt over
    rows of V).  QR on the transpose is the batched equivalent; signs
    are fixed to the Gram-Schmidt convention (positive projection of
    each original row on its orthonormalised self)."""
    rv = model.rank_v
    flat = model.v.reshape(rv, -1)                            # (Rv, KD)
    q, r = jnp.linalg.qr(flat.T)                              # (KD,Rv)
    sign = jnp.sign(jnp.diagonal(r))
    sign = jnp.where(sign == 0, 1.0, sign)
    return model.replace(v=(q * sign[None, :]).T.reshape(model.v.shape))


# -- subspace EM updates ------------------------------------------------------

@pytree_dataclass
class SubspaceAccums:
    a: jax.Array       # (K, R, R)
    c: jax.Array       # (R, K, D)

    def merge(self, other: "SubspaceAccums") -> "SubspaceAccums":
        return jax.tree.map(jnp.add, self, other)


def _accumulate_subspace(n: jax.Array, fbar: jax.Array, mean: jax.Array,
                         cov: jax.Array) -> SubspaceAccums:
    """A_c = Σ_b N_bc·(cov_b + mean_b·mean_bᵀ); C = Σ_b mean_b ⊗ F̄_b
    (reference estimateYandV / estimateXandU accumulators,
    cpp:2457/3030)."""
    second = cov + jnp.einsum("br,bq->brq", mean, mean)
    return SubspaceAccums(
        a=jnp.einsum("bk,brq->krq", n, second,
                     preferred_element_type=jnp.float32),
        c=jnp.einsum("br,bkd->rkd", mean, fbar,
                     preferred_element_type=jnp.float32),
    )


def _solve_subspace(acc: SubspaceAccums) -> jax.Array:
    """T_c = A_c⁻¹·C_c per component (reference updateVestimate/
    updateUestimate, cpp:3597/3622)."""
    c_krd = jnp.transpose(acc.c, (1, 0, 2))                  # (K,R,D)
    return jnp.transpose(jnp.linalg.solve(acc.a, c_krd), (1, 0, 2))


def v_residual(stats: JfaStats, model: JfaModel, x: jax.Array,
               z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Speaker-level (n, F̄) residual for the V substep: F̄ centered,
    minus D·z and the per-speaker channel stats (substractMplusDZ +
    substractUX, cpp:3795/4142)."""
    s = stats.spk.n.shape[0]
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, model.d[None] * z)
    fbar = fbar - _speaker_ux_stats(stats, model, x, s)
    return stats.spk.n, fbar


def u_residual(stats: JfaStats, model: JfaModel, y: jax.Array,
               z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Session-level (n, F̄) residual for the U substep
    (substractMplusVYplusDZ, cpp:4390)."""
    spk_off = (jnp.einsum("sr,rkd->skd", y, model.v) + model.d[None] * z)
    fbar = _center(stats.sess, model)
    fbar = _subtract(fbar, stats.sess.n, spk_off[stats.sess_spk])
    return stats.sess.n, fbar


def subspace_em_step(t: jax.Array, inv_var: jax.Array, n: jax.Array,
                     fbar: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Shared E+M over one subspace given per-entity residual stats:
    posterior latents, A/C accumulators, per-component solve.  Returns
    (new subspace, latent means)."""
    gram = _subspace_gram(t, inv_var)
    mean, cov = _latent_posterior(t, inv_var, gram, n, fbar)
    acc = _accumulate_subspace(n, fbar, mean, cov)
    return _solve_subspace(acc), mean


def jfa_v_iteration(stats: JfaStats, model: JfaModel, x: jax.Array,
                    z: jax.Array) -> tuple[JfaModel, jax.Array]:
    """One EigenVoice EM iteration (EigenVoice.cpp:71-163 loop body).
    Returns (model with new V, y estimates)."""
    n, fbar = v_residual(stats, model, x, z)
    v_new, y = subspace_em_step(model.v, model.ubm_inv_var, n, fbar)
    return model.replace(v=v_new), y


def jfa_u_iteration(stats: JfaStats, model: JfaModel, y: jax.Array,
                    z: jax.Array) -> tuple[JfaModel, jax.Array]:
    """One EigenChannel EM iteration (EigenChannel.cpp:70-200 loop body)."""
    n, fbar = u_residual(stats, model, y, z)
    u_new, x = subspace_em_step(model.u, model.ubm_inv_var, n, fbar)
    return model.replace(u=u_new), x


def jfa_d_iteration(stats: JfaStats, model: JfaModel, y: jax.Array,
                    x: jax.Array, tau: float = 10.0
                    ) -> tuple[JfaModel, jax.Array]:
    """D estimation given V (and U) — reference EstimateDMatrix.cpp:105-212:
    ML update of the diagonal from the speaker residual with the MAP-τ
    posterior for z."""
    s = stats.spk.n.shape[0]
    fbar = _center(stats.spk, model)
    fbar = fbar - stats.spk.n[..., None] * jnp.einsum(
        "sr,rkd->skd", y, model.v)
    fbar = fbar - _speaker_ux_stats(stats, model, x, s)
    # z posterior (diagonal case): precision τ + N·d²Σ⁻¹ per (s,k,d)
    d2iv = model.d[None] ** 2 * model.ubm_inv_var[None]
    den = tau + stats.spk.n[..., None] * d2iv
    z_mean = model.d[None] * model.ubm_inv_var[None] * fbar / den
    # M-step: d_kd = Σ_s z·F̄ / Σ_s N·E[z²], with E[z²] = mean² + 1/den
    num = jnp.sum(z_mean * fbar, axis=0)
    ezz = z_mean * z_mean + 1.0 / den
    den_m = jnp.sum(stats.spk.n[..., None] * ezz, axis=0)
    d_new = num / jnp.maximum(den_m, 1e-10)
    return model.replace(d=d_new), z_mean


def jfa_train(key: jax.Array, stats: JfaStats, gmm: GmmDiag,
              rank_v: int, rank_u: int,
              nb_it_v: int = 10, nb_it_u: int = 10, nb_it_d: int = 0,
              tau: float = 10.0, verbose: bool = False
              ) -> tuple[JfaModel, jax.Array, jax.Array, jax.Array]:
    """Full JFA training: V then U then D (the reference's tool order:
    EigenVoice → EigenChannel → EstimateDMatrix)."""
    model = JfaModel.init(key, rank_v, rank_u, gmm)
    s = stats.spk.n.shape[0]
    h = stats.sess.n.shape[0]
    x = jnp.zeros((h, rank_u), jnp.float32)
    z = jnp.zeros((s, gmm.means.shape[0], gmm.means.shape[1]), jnp.float32)
    y = jnp.zeros((s, rank_v), jnp.float32)
    for it in range(nb_it_v):
        model, y = jfa_v_iteration(stats, model, x, z)
        if verbose:
            print(f"JFA V it {it}: |V|={float(jnp.abs(model.v).mean()):.5f}")
    for it in range(nb_it_u):
        y, _ = estimate_y(stats, model, x, z)
        model, x = jfa_u_iteration(stats, model, y, z)
        if verbose:
            print(f"JFA U it {it}: |U|={float(jnp.abs(model.u).mean()):.5f}")
    for it in range(nb_it_d):
        y, _ = estimate_y(stats, model, x, z)
        x, _ = estimate_x(stats, model, y, z)
        model, z = jfa_d_iteration(stats, model, y, x, tau)
        if verbose:
            print(f"JFA D it {it}: |D|={float(jnp.abs(model.d).mean()):.5f}")
    y, _ = estimate_y(stats, model, x, z)
    x, _ = estimate_x(stats, model, y, z)
    if nb_it_d > 0:
        z = estimate_z_map(stats, model, y, x, tau)
    return model, y, x, z


def jfa_verify_em_llk(x_frames: jax.Array, mask: jax.Array,
                      stats: JfaStats, model: JfaModel,
                      weights: jax.Array, y: jax.Array, x: jax.Array,
                      z: jax.Array, max_sessions: int = 1) -> float:
    """EM-likelihood monitor (reference JFAAcc::getLLK / verifyEMLK,
    AccumulateJFAStat.cpp:4803-4860): total mean frame LLK of up to
    ``max_sessions`` sessions under their synthesised session models
    m + V·y + U·x + D·z — rises over V/U/D EM iterations.

    x_frames (H, T, Dim) padded session frames with (H, T) mask."""
    from ..gmm.kernels import frame_llk
    n = min(max_sessions, int(stats.sess.n.shape[0]))
    total = 0.0
    for h in range(n):
        spk = int(stats.sess_spk[h])
        means = model.supervector(y[spk], x[h], z[spk])
        sess_gmm = GmmDiag(weights=weights, means=means,
                           cov_inv=model.ubm_inv_var)
        llk = frame_llk(x_frames[h], sess_gmm)
        total += float(jnp.sum(llk * mask[h])
                       / jnp.maximum(jnp.sum(mask[h]), 1.0))
    return total


# -- scoring ------------------------------------------------------------------

def jfa_dot_product_scores(stats_test: BwStats, model: JfaModel,
                           y_models: jax.Array, x_test: jax.Array,
                           z_models: jax.Array | None = None) -> jax.Array:
    """Linear (dot-product) JFA scoring — reference ComputeTestDotProduct
    (ComputeTest.cpp:228): score(m, t) = <V·y_m [+D·z_m], Σ⁻¹·(F̄_t −
    N_t·U·x_t)> normalised by the test frame count."""
    fbar = stats_test.f - stats_test.n[..., None] * model.ubm_means[None]
    ux = jnp.einsum("tr,rkd->tkd", x_test, model.u)
    fbar = fbar - stats_test.n[..., None] * ux
    fnorm = fbar * model.ubm_inv_var[None]                    # (T,K,D)
    sv = jnp.einsum("mr,rkd->mkd", y_models, model.v)
    if z_models is not None:
        sv = sv + model.d[None] * z_models
    frames = jnp.maximum(jnp.sum(stats_test.n, axis=-1), 1e-6)  # (T,)
    return jnp.einsum("mkd,tkd->mt", sv, fnorm) / frames[None, :]
