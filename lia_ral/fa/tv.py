"""TotalVariability (i-vector) engine.

array re-design of reference ``AccumulateTVStat`` (SURVEY.md §2.1):

* ``estimateTETt`` (cpp:766) → one einsum producing E_c = T_c Σ_c⁻¹ T_cᵀ
  for all components at once;
* ``estimateAandC`` (cpp:1691-1800) — the reference's hottest stage, a
  per-speaker loop over L-inversions threaded over a pthread pool — becomes
  a speaker-chunked scan of batched Cholesky factorisations + einsum
  accumulations (the pthread merge of A/C under mutexes is an associative
  sum, psum-able under sharding);
* ``updateTestimate`` (cpp:974) → one batched linear solve over the
  component axis;
* ``minDivergence`` (cpp:2056-2101) → Cholesky rescale of T + mean update;
* ``estimateW`` (cpp:2103-2267) and the two fast approximations
  ``estimateWUbmWeight`` (cpp:2337) / ``estimateWEigenDecomposition``
  (cpp:2556) → batched solves / matmuls.

Model layout: T is (R, K, D) — the reference's (R, K·D) supervector rows
kept component-major so component-wise contractions are natural einsums.
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
class TvModel:
    t: jax.Array           # (R, K, D) total-variability matrix
    ubm_means: jax.Array   # (K, D)    — mutated by minDivergence mean update
    ubm_inv_var: jax.Array # (K, D)

    @property
    def rank(self) -> int:
        return self.t.shape[0]

    @property
    def n_distrib(self) -> int:
        return self.t.shape[1]

    @property
    def dim(self) -> int:
        return self.t.shape[2]

    def t_flat(self) -> jax.Array:
        """(R, K·D) supervector layout (reference _T)."""
        return self.t.reshape(self.rank, -1)

    @classmethod
    def from_ubm(cls, t, gmm: GmmDiag) -> "TvModel":
        return cls(t=jnp.asarray(t, jnp.float32),
                   ubm_means=jnp.asarray(gmm.means, jnp.float32),
                   ubm_inv_var=jnp.asarray(gmm.cov_inv, jnp.float32))

    # file interop: reference saves T as (R, K·D) .matx
    def save(self, path: str, fmt: str = "DB") -> None:
        from ..io.matrix import write_matrix_file
        write_matrix_file(path, np.asarray(self.t_flat(), np.float64), fmt)

    @classmethod
    def load(cls, path: str, gmm: GmmDiag) -> "TvModel":
        from ..io.matrix import read_matrix_file
        t = read_matrix_file(path)
        r = t.shape[0]
        k, d = gmm.means.shape
        return cls.from_ubm(t.reshape(r, k, d), gmm)


@pytree_dataclass
class TvAccums:
    """EM accumulators (reference _A, _Cmx, _R, _r, _meanW)."""

    a: jax.Array        # (K, R, R)  Σ_s N_sc·(L_s⁻¹ + w_s w_sᵀ)
    c: jax.Array        # (R, K, D)  Σ_s w_s ⊗ F̄_s
    r_mat: jax.Array    # (R, R)     Σ_s (L_s⁻¹ + w_s w_sᵀ)
    r_vec: jax.Array    # (R,)       Σ_s w_s
    n_utts: jax.Array   # ()

    def merge(self, other: "TvAccums") -> "TvAccums":
        return jax.tree.map(jnp.add, self, other)

    @classmethod
    def zeros(cls, r: int, k: int, d: int, dtype=jnp.float32) -> "TvAccums":
        return cls(a=jnp.zeros((k, r, r), dtype),
                   c=jnp.zeros((r, k, d), dtype),
                   r_mat=jnp.zeros((r, r), dtype),
                   r_vec=jnp.zeros((r,), dtype),
                   n_utts=jnp.zeros((), dtype))


def init_t(key: jax.Array, rank: int, gmm: GmmDiag,
           scale: float = 1.0) -> TvModel:
    """Random T init — reference initT Box-Muller Gaussian draw
    (AccumulateTVStat.cpp:701)."""
    k, d = gmm.means.shape
    t = jax.random.normal(key, (rank, k, d), jnp.float32) * scale
    return TvModel.from_ubm(t, gmm)


def estimate_tett(model: TvModel) -> jax.Array:
    """E_c = T_c Σ_c⁻¹ T_cᵀ for every component — (K, R, R)
    (reference estimateTETt, cpp:766)."""
    return jnp.einsum("rkd,kd,qkd->krq", model.t, model.ubm_inv_var, model.t,
                      preferred_element_type=jnp.float32)


def _posterior(n_blk, fbar_blk, model: TvModel, tett: jax.Array,
               tn_flat: jax.Array | None = None, need_cov: bool = True):
    """Per-utterance-block posteriors: L⁻¹ and w.

    n_blk: (B, K); fbar_blk: (B, K, D) centered stats; ``tn_flat`` a
    precomputed T·Σ⁻¹ in (R, K·D) layout (hoisted by the callers so it
    is built once per call, not once per chunk).
    Returns (w (B,R), linv (B,R,R)).

    Both contractions are flattened matmuls: the (B,K)@(K,R²) L build
    streams the 1.3 GB tett exactly once per block (the einsum form
    lowered poorly — stage C measured 95 ms for 500 utts at K=2048/
    R=400; the matmul form + chunk=256 runs ~8x faster, PERF.md §2).
    """
    r = model.rank
    b, k = n_blk.shape
    eye = jnp.eye(r, dtype=n_blk.dtype)
    l_mat = eye[None] + jnp.dot(
        n_blk, tett.reshape(k, r * r),
        preferred_element_type=jnp.float32).reshape(b, r, r)
    if tn_flat is None:
        tn_flat = (model.t * model.ubm_inv_var[None]).reshape(r, -1)
    # aux = T Σ⁻¹ F̄ per utterance (reference AUX), as (B,KD)@(KD,R)
    aux = jnp.dot(fbar_blk.reshape(b, -1), tn_flat.T,
                  preferred_element_type=jnp.float32)
    chol = jnp.linalg.cholesky(l_mat)                      # (B,R,R)
    w = jax.scipy.linalg.cho_solve((chol, True), aux[..., None])[..., 0]
    if not need_cov:
        # extraction doesn't need the posterior covariance; the L⁻¹
        # identity-solve is an extra B·R³ of triangular work per block
        return w, None
    linv = jax.scipy.linalg.cho_solve(
        (chol, True), jnp.broadcast_to(eye, l_mat.shape))
    return w, linv


def _posterior_mean(n_blk, fbar_blk, model: TvModel, tett: jax.Array,
                    tn_flat: jax.Array):
    """w only — see _posterior(need_cov=False)."""
    return _posterior(n_blk, fbar_blk, model, tett, tn_flat,
                      need_cov=False)[0]


@functools.partial(jax.jit, static_argnames=("chunk",))
def tv_e_step(stats: BwStats, model: TvModel, chunk: int = 64
              ) -> tuple[jax.Array, TvAccums]:
    """Full E-step over all utterances, chunked over the speaker axis.

    Returns (w (S,R), accums).  Reference estimateAandC (cpp:1691-1800).
    """
    s, k = stats.n.shape
    d = model.dim
    r = model.rank
    tett = estimate_tett(model)
    fbar = stats.centered(model.ubm_means)                  # (S,K,D)
    pad = (-s) % chunk
    n_p = jnp.concatenate([stats.n, jnp.zeros((pad, k), stats.n.dtype)])
    f_p = jnp.concatenate([fbar, jnp.zeros((pad, k, d), fbar.dtype)])
    valid = jnp.concatenate([jnp.ones((s,), jnp.float32),
                             jnp.zeros((pad,), jnp.float32)])
    nb = n_p.reshape(-1, chunk, k)
    fb = f_p.reshape(-1, chunk, k, d)
    vb = valid.reshape(-1, chunk)

    tn_flat = (model.t * model.ubm_inv_var[None]).reshape(r, -1)

    def body(acc: TvAccums, blk):
        n_blk, f_blk, v_blk = blk
        w, linv = _posterior(n_blk, f_blk, model, tett, tn_flat)
        w = w * v_blk[:, None]          # zero padded utterances
        cov = linv + jnp.einsum("br,bq->brq", w, w)
        cov = cov * v_blk[:, None, None]
        acc = TvAccums(
            a=acc.a + jnp.einsum("bk,brq->krq", n_blk, cov,
                                 preferred_element_type=jnp.float32),
            c=acc.c + jnp.einsum("br,bkd->rkd", w, f_blk,
                                 preferred_element_type=jnp.float32),
            r_mat=acc.r_mat + jnp.sum(cov, axis=0),
            r_vec=acc.r_vec + jnp.sum(w, axis=0),
            n_utts=acc.n_utts + jnp.sum(v_blk),
        )
        return acc, w

    acc, w_blocks = jax.lax.scan(body, TvAccums.zeros(r, k, d), (nb, fb, vb))
    w_all = w_blocks.reshape(-1, r)[:s]
    return w_all, acc


def tv_m_step(model: TvModel, acc: TvAccums) -> TvModel:
    """T_c = A_c⁻¹ C_c per component — reference updateTestimate
    (cpp:974-1005), batched over the component axis."""
    c_kdr = jnp.transpose(acc.c, (1, 2, 0))                 # (K,D,R)
    t_new = jnp.linalg.solve(acc.a, jnp.transpose(c_kdr, (0, 2, 1)))
    # t_new: (K,R,D) → (R,K,D)
    return model.replace(t=jnp.transpose(t_new, (1, 0, 2)))


def min_divergence(model: TvModel, acc: TvAccums) -> TvModel:
    """Minimum-divergence step (reference minDivergence, cpp:2056-2101):
    whiten T by the empirical i-vector covariance, fold the i-vector mean
    into the UBM means."""
    n = jnp.maximum(acc.n_utts, 1.0)
    r_bar = acc.r_vec / n
    r_cov = acc.r_mat / n - jnp.einsum("i,j->ij", r_bar, r_bar)
    # mean update BEFORE rotation (reference order): m += meanWᵀ·T
    new_means = model.ubm_means + jnp.einsum("r,rkd->kd", r_bar, model.t)
    chol_l = jnp.linalg.cholesky(r_cov)                     # R = L·Lᵀ
    # T ← Lᵀ·T  (reference Ch upper with R=ChᵀCh, T ← Ch·T)
    t_new = jnp.einsum("rq,rkd->qkd", chol_l, model.t)
    return model.replace(t=t_new, ubm_means=new_means)


def tv_em_iteration(stats: BwStats, model: TvModel, chunk: int = 64,
                    min_div: bool = True) -> tuple[TvModel, jax.Array]:
    """One full T-matrix EM iteration (reference TotalVariability.cpp
    117-168 loop body).  Returns (new model, i-vectors of this iteration).
    """
    w, acc = tv_e_step(stats, model, chunk=chunk)
    new_model = tv_m_step(model, acc)
    if min_div:
        new_model = min_divergence(new_model, acc)
    return new_model, w


def _pcg_basis(model: TvModel, n_ref: jax.Array):
    """Preconditioner basis for the per-utterance L-solves.

    Q = eigenvectors of the reference-occupancy-weighted Σ_k n̄_k·E_k
    (an (R,R) eigh — one per estimate_w call), and D(k,i) = (Qᵀ E_k Q)_ii
    — the same quantities as the reference's eigenDecomposition
    APPROXIMATION (AccumulateTVStat.cpp:2556/3106), reused here as a
    PRECONDITIONER so the solve stays EXACT.  Both are built from the
    FACTORED form E_k = Tn_k·Tn_kᵀ (Tn = T·√Σ⁻¹): two (R, K·D) matmuls
    (~4·R²·K·D flops) instead of rotating the materialised (K,R,R) tett
    (~2·K·R³ — 2.5x more at K=2048/R=400/D=39, and tett need not exist);
    D(k,i) = ‖Qᵀ·Tn_k‖²-rows, exactly (QᵀE_kQ)_ii up to roundoff."""
    r, k, d = model.t.shape
    tn = model.t * jnp.sqrt(model.ubm_inv_var)[None]            # (R,K,D)
    nw = n_ref / jnp.maximum(jnp.sum(n_ref), 1e-30)
    tns = (tn * jnp.sqrt(nw)[None, :, None]).reshape(r, k * d)
    m = jnp.dot(tns, tns.T, preferred_element_type=jnp.float32)  # (R,R)
    _, q = jnp.linalg.eigh(m)
    h = jnp.dot(q.T, tn.reshape(r, k * d),
                preferred_element_type=jnp.float32)              # (R, K·D)
    dk = jnp.sum(h.reshape(r, k, d) ** 2, axis=-1).T             # (K, R)
    return q, dk


def _posterior_mean_pcg(n_blk, fbar_blk, model: TvModel, tett, tn_flat,
                        q, dk, iters: int, tol: float = 0.0):
    """w = L⁻¹·aux via preconditioned conjugate gradients.

    L is SPD and, preconditioned by the per-utterance diagonal
    1/(1 + n·D) in the fixed Q basis, near-perfectly conditioned
    (measured κ ≈ 1.6 at K=2048/R=400 on 2000-frame occupancies):
    convergence to f32 roundoff in ~10 iterations; ``iters`` bounds
    the loop.  With ``tol > 0`` the loop exits early once EVERY
    utterance in the block satisfies ‖L·x − aux‖ ≤ tol·‖aux‖ (a
    lax.while_loop — one extra (B,) reduction per iteration); with
    ``tol == 0`` the trip count is jit-static (lax.fori_loop).  Each
    iteration is one bandwidth-bound (B,R,R)·(B,R) matvec — 5x faster
    than the batched Cholesky at B=512/R=400 (14.7 vs 72.7 ms measured
    on-chip, PERF.md §2).  Padding rows (n=0) give L=I, aux=0 → x=0
    exactly (and rel=0, so they never hold the exit back)."""
    r = model.rank
    b, k = n_blk.shape
    eye = jnp.eye(r, dtype=n_blk.dtype)
    l_mat = eye[None] + jnp.dot(
        n_blk, tett.reshape(k, r * r),
        preferred_element_type=jnp.float32).reshape(b, r, r)
    aux = jnp.dot(fbar_blk.reshape(b, -1), tn_flat.T,
                  preferred_element_type=jnp.float32)           # (B,R)
    dinv = 1.0 / (1.0 + jnp.dot(n_blk, dk,
                                preferred_element_type=jnp.float32))

    def m_inv(v):
        return ((v @ q) * dinv) @ q.T

    x = jnp.zeros_like(aux)
    res = aux
    z = m_inv(res)
    p = z
    rz = jnp.sum(res * z, axis=1, keepdims=True)
    aux_nrm = jnp.maximum(jnp.linalg.norm(aux, axis=1), 1e-30)

    def step(x, res, p, rz):
        ap = jnp.einsum("brq,bq->br", l_mat, p,
                        preferred_element_type=jnp.float32)
        alpha = rz / jnp.maximum(jnp.sum(p * ap, axis=1, keepdims=True),
                                 1e-30)
        x = x + alpha * p
        res = res - alpha * ap
        z = m_inv(res)
        rz2 = jnp.sum(res * z, axis=1, keepdims=True)
        p = z + (rz2 / jnp.maximum(rz, 1e-30)) * p
        return x, res, p, rz2

    if tol > 0.0:
        def w_cond(st):
            i, x, res, p, rz = st
            rel_max = jnp.max(jnp.linalg.norm(res, axis=1) / aux_nrm)
            return jnp.logical_and(i < iters, rel_max > tol)

        def w_body(st):
            i, x, res, p, rz = st
            return (i + 1,) + step(x, res, p, rz)

        _, x, res, p, rz = jax.lax.while_loop(
            w_cond, w_body, (jnp.zeros((), jnp.int32), x, res, p, rz))
    else:
        x, res, p, rz = jax.lax.fori_loop(
            0, iters, lambda _, st: step(*st), (x, res, p, rz))
    # per-utterance relative residual ‖L·x − aux‖/‖aux‖ — cheap (the
    # final res is already live) and the convergence diagnostic for
    # stats outside the validated envelope (see estimate_w docstring)
    rel = (jnp.linalg.norm(res, axis=1)
           / jnp.maximum(jnp.linalg.norm(aux, axis=1), 1e-30))
    return x, rel


@functools.partial(jax.jit, static_argnames=("chunk", "solver",
                                             "pcg_iters", "pcg_tol",
                                             "return_diag"))
def estimate_w(stats: BwStats, model: TvModel, chunk: int = 256,
               solver: str = "pcg", pcg_iters: int = 16,
               pcg_tol: float = 1e-7,
               return_diag: bool = False) -> jax.Array:
    """Exact i-vector extraction: w = L⁻¹ T Σ⁻¹ F̄ per utterance
    (reference estimateW, cpp:2103-2267).  ``chunk`` bounds the live
    (B,R,R) solve block; 256 amortises the per-block tett stream
    (PERF.md §2).

    ``solver``: "pcg" (default) solves the SPD systems by
    eigendecomposition-preconditioned conjugate gradients — exact to
    f32 roundoff (max dev 4.9e-7 vs the Cholesky path at milestone
    shapes, residual ≤ 1e-8 at ``pcg_iters=16``; tests pin both) and
    ~3x faster end-to-end; "cholesky" keeps the batched-factorisation
    path (the E-step always uses it — it needs the full L⁻¹).

    Validated PCG envelope (scripts/sweep_pcg_iters.py, on-chip at
    K=2048/R=400): uniform ~2000-frame occupancies AND 100k-frame
    utterances converge to the f32 dev floor vs Cholesky by 8
    iterations (7e-7 / 9.7e-7); a hostile heavy-tailed Dirichlet(0.05)
    occupancy profile (maximally mismatched to the batch-mean
    preconditioner basis) reaches its floor (2.9e-6) by 16 — raising
    to 20 does not improve any measured case, hence the 16 default.
    For stats outside this envelope pass ``return_diag=True`` to get
    the per-utterance relative residual ‖L·w − aux‖/‖aux‖ — values ≫
    f32 roundoff mean raise ``pcg_iters`` (config key
    ``ivSolverPcgIterations``) or use solver="cholesky".

    ``pcg_tol`` (default 1e-7, config key ``ivSolverPcgTolerance``)
    exits the CG loop early once every utterance in a chunk reaches
    that relative residual — benign envelopes converge in ~8-10
    iterations, so this saves roughly half the matvec passes with a
    result within tol (≪ every test tolerance) of the fixed-count
    path; ``pcg_tol=0`` restores the jit-static fixed-``pcg_iters``
    loop."""
    s, k = stats.n.shape
    d = model.dim
    tett = estimate_tett(model)
    tn_flat = (model.t * model.ubm_inv_var[None]).reshape(model.rank, -1)
    fbar = stats.centered(model.ubm_means)
    pad = (-s) % chunk
    n_p = jnp.concatenate([stats.n, jnp.zeros((pad, k), stats.n.dtype)])
    f_p = jnp.concatenate([fbar, jnp.zeros((pad, k, d), fbar.dtype)])
    if solver == "pcg":
        q, dk = _pcg_basis(model, jnp.mean(stats.n, axis=0))

        def block(blk):
            n_blk, f_blk = blk
            return _posterior_mean_pcg(n_blk, f_blk, model, tett, tn_flat,
                                       q, dk, pcg_iters, pcg_tol)
    elif solver == "cholesky":
        def block(blk):
            n_blk, f_blk = blk
            w_blk = _posterior_mean(n_blk, f_blk, model, tett, tn_flat)
            # direct solve: residual is f32 roundoff by construction
            return w_blk, jnp.zeros((n_blk.shape[0],), w_blk.dtype)
    else:
        raise ValueError(f"unknown estimate_w solver {solver}")

    w, rel = jax.lax.map(block, (n_p.reshape(-1, chunk, k),
                                 f_p.reshape(-1, chunk, k, d)))
    w = w.reshape(-1, model.rank)[:s]
    if return_diag:
        return w, rel.reshape(-1)[:s]
    return w


def get_speaker_model(model: TvModel, w: jax.Array, gmm: GmmDiag) -> GmmDiag:
    """Synthesise the speaker GMM m + Tᵀw (reference getSpeakerModel,
    AccumulateTVStat.cpp:1533); weights/covariances stay the UBM's."""
    shift = jnp.einsum("r,rkd->kd", w, model.t)
    return gmm.replace(means=model.ubm_means + shift)


def verify_em_llk(x: jax.Array, mask: jax.Array, stats: BwStats,
                  model: TvModel, gmm: GmmDiag, max_utts: int = 1) -> float:
    """EM-likelihood check (reference verifyEMLK / getLLK,
    AccumulateTVStat.cpp:1627-1688, config key ``computeLLK``): total
    mean frame LLK of up to ``max_utts`` utterances under their
    synthesised speaker models — monotone over T-EM iterations."""
    from ..gmm.kernels import frame_llk
    w_all = estimate_w(stats, model)
    n = min(max_utts, stats.n_utts)
    total = 0.0
    for i in range(n):
        spk = get_speaker_model(model, w_all[i], gmm)
        llk = frame_llk(x[i], spk)
        total += float(jnp.sum(llk * mask[i])
                       / jnp.maximum(jnp.sum(mask[i]), 1.0))
    return total


# -- fast approximations ------------------------------------------------------

def norm_t_matrix(model: TvModel) -> jax.Array:
    """T̄ = T·sqrt(Σ⁻¹) (reference normTMatrix, cpp:1600) — (R,K,D)."""
    return model.t * jnp.sqrt(model.ubm_inv_var)[None, :, :]


def weighted_cov(model: TvModel, ubm_weights: jax.Array) -> jax.Array:
    """W = Σ_c w_c·T̄_c T̄_cᵀ (reference getWeightedCov, cpp:2826)."""
    tn = norm_t_matrix(model)
    return jnp.einsum("k,rkd,qkd->rq", ubm_weights, tn, tn,
                      preferred_element_type=jnp.float32)


def estimate_w_ubm_weight(stats: BwStats, model: TvModel,
                          w_mat: jax.Array, chunk: int = 64) -> jax.Array:
    """UBM-weight approximation (reference estimateWUbmWeight, cpp:2337):
    L_s ≈ I + (Σ_c N_sc)·W with W the weighted covariance — one shared
    R×R structure scaled per utterance."""
    s = stats.n.shape[0]
    r = model.rank
    tn = norm_t_matrix(model)
    fnorm = stats.normalized(model.ubm_means, model.ubm_inv_var)  # (S,K,D)
    aux = jnp.einsum("rkd,skd->sr", tn, fnorm,
                     preferred_element_type=jnp.float32)
    n_sum = jnp.sum(stats.n, axis=-1)                             # (S,)
    eye = jnp.eye(r, dtype=aux.dtype)

    def block(blk):
        aux_b, ns_b = blk
        l_mat = eye[None] + ns_b[:, None, None] * w_mat[None]
        chol = jnp.linalg.cholesky(l_mat)
        return jax.scipy.linalg.cho_solve((chol, True),
                                          aux_b[..., None])[..., 0]

    pad = (-s) % chunk
    aux_p = jnp.concatenate([aux, jnp.zeros((pad, r), aux.dtype)])
    ns_p = jnp.concatenate([n_sum, jnp.zeros((pad,), n_sum.dtype)])
    w = jax.lax.map(block, (aux_p.reshape(-1, chunk, r),
                            ns_p.reshape(-1, chunk)))
    return w.reshape(-1, r)[:s]


def eigen_decompose_w(w_mat: jax.Array) -> jax.Array:
    """Q = eigenvectors of the weighted covariance (reference
    computeEigenProblem, cpp:2999-3104) — columns are eigenvectors."""
    _, q = jnp.linalg.eigh(w_mat)
    return q


def approximate_tctc(model: TvModel, q: jax.Array) -> jax.Array:
    """D(c,i) ≈ (Qᵀ T̄_c T̄_cᵀ Q)_ii (reference approximateTcTc, cpp:3106)
    — (K, R)."""
    tn = norm_t_matrix(model)
    tq = jnp.einsum("rkd,rq->kqd", tn, q,
                    preferred_element_type=jnp.float32)    # (K,R,D)
    return jnp.sum(tq * tq, axis=-1)                       # (K,R)


def estimate_w_eigen_decomposition(stats: BwStats, model: TvModel,
                                   d_mat: jax.Array, q: jax.Array
                                   ) -> jax.Array:
    """Eigen-decomposition approximation (reference
    estimateWEigenDecomposition, cpp:2556-2610): L⁻¹ ≈ Q·diag(1/(1+N·D))·Qᵀ
    — no per-utterance matrix inversion at all."""
    tn = norm_t_matrix(model)
    fnorm = stats.normalized(model.ubm_means, model.ubm_inv_var)
    aux = jnp.einsum("rkd,skd->sr", tn, fnorm,
                     preferred_element_type=jnp.float32)   # (S,R)
    inv_l = 1.0 / (1.0 + jnp.dot(stats.n, d_mat,
                                 preferred_element_type=jnp.float32))  # (S,R)
    aux_q = jnp.einsum("sr,rq->sq", aux, q)                # project
    return jnp.einsum("sq,rq->sr", aux_q * inv_l, q)


def orthonormalize_t(model: TvModel) -> TvModel:
    """Orthonormalise the rows of T (reference orthonormalizeT, cpp:1548)
    via QR on the supervector layout."""
    tf = model.t_flat()                                    # (R, KD)
    q, _ = jnp.linalg.qr(tf.T)                             # (KD, R)
    return model.replace(t=q.T.reshape(model.t.shape))
