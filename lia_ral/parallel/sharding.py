"""Sharded sufficient-statistics accumulation.

The reference's threaded EM (``AccumulateStat.cpp:234-299``: dynamic
segment queue, per-thread MixtureStat, ``addAccEM`` merge) maps exactly to:
shard the frame axis over the "data" mesh axis, run the chunked stat
kernel per shard, ``psum`` the EmStats pytree over the axis.  The merge is
associative, so sharded == serial to float tolerance — the property the
reference implicitly tests by keeping threaded and unthreaded paths
(SURVEY.md §4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..gmm import stats_path
from ..gmm.kernels import EmStats
from ..gmm.stats_path import em_stats
from ..gmm.model import GmmDiag


def shard_frames(x: jax.Array, w: jax.Array, n_shards: int,
                 ) -> tuple[jax.Array, jax.Array]:
    """Pad the frame axis to a multiple of n_shards (zero weights on pad)."""
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        w = jnp.concatenate([w, jnp.zeros((pad,), w.dtype)])
    return x, w


def sharded_em_stats(
    mesh: Mesh,
    x: jax.Array,
    w: jax.Array,
    gmm: GmmDiag,
    chunk: int = 4096,
    local_fn=None,
) -> EmStats:
    """EM sufficient stats with the frame axis sharded over mesh axis
    "data"; the model is replicated; stats are psum-merged across devices.
    ``local_fn`` is the per-shard statistics (default:
    gmm.stats_path.em_stats at f32 grade)."""
    if local_fn is None:
        def local_fn(xs, ws, g):
            return em_stats(xs, ws, g, chunk=chunk)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P()),
        out_specs=P(),
        # the GPU kernel's outputs carry no varying-axes type
        check_vma=not stats_path.use_kernel(),
    )
    def _stats(xs, ws, g):
        return jax.lax.psum(local_fn(xs, ws, g), axis_name="data")

    n_data = mesh.shape["data"]
    x, w = shard_frames(x, w, n_data)
    return _stats(x, w, gmm)


def sharded_stats_fn(mesh: Mesh, chunk: int = 4096, fast_math: bool = False,
                     fast_stats: bool = False):
    """stats_fn drop-in for gmm.em.train_model / map_adapt.adapt_model:
    same (x, w, gmm) → EmStats signature, jitted over the mesh.  Every
    shard runs gmm.stats_path.em_stats with the same precision flags, so
    fastMath/fastStats also apply under numThread-sharding."""
    from ..gmm.em import default_stats_fn
    local = default_stats_fn(chunk=chunk, fast_math=fast_math,
                             fast_stats=fast_stats)

    @jax.jit
    def fn(x, w, gmm):
        return sharded_em_stats(mesh, x, w, gmm, chunk=chunk,
                                local_fn=local)

    return fn


def sharded_em_stats_2d(
    mesh: Mesh,
    x: jax.Array,
    w: jax.Array,
    gmm: GmmDiag,
    chunk: int = 4096,
) -> EmStats:
    """2-D sharded stats: frames over "data" AND components over "model".

    For UBMs/T-matrices beyond one chip's HBM (SURVEY.md §2.6 "model
    sharding"): each device holds K/m components; the posterior
    normalisation needs the global logsumexp over K, realised as
    pmax/psum collectives over the "model" axis before the local stat
    matmuls.  Outputs stay component-sharded; frame-axis reduction is a
    psum over "data".
    """
    from ..gmm.kernels import weighted_logdens

    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    k, d = gmm.means.shape
    assert k % n_model == 0, (k, n_model)
    x, w = shard_frames(x, w, n_data)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"),
                  GmmDiag(weights=P("model"), means=P("model"),
                          cov_inv=P("model"))),
        out_specs=EmStats(n=P("model"), sum_x=P("model"), sum_xx=P("model"),
                          llk=P(), count=P()),
    )
    def _stats(xs, ws, g):
        nloc = xs.shape[0]
        pad = (-nloc) % chunk
        xs = jnp.concatenate([xs, jnp.zeros((pad, d), xs.dtype)])
        ws = jnp.concatenate([ws, jnp.zeros((pad,), ws.dtype)])

        def body(acc, blk):
            xb, wb = blk
            ld = weighted_logdens(xb, g)                   # (B, K/m)
            m_loc = jnp.max(ld, axis=-1)
            m_glob = jax.lax.pmax(m_loc, axis_name="model")
            s_loc = jnp.sum(jnp.exp(ld - m_glob[:, None]), axis=-1)
            s_glob = jax.lax.psum(s_loc, axis_name="model")
            llk = jnp.log(s_glob) + m_glob                 # (B,)
            post = jnp.exp(ld - llk[:, None])              # local slice of γ
            pw = post * wb[:, None]
            return EmStats(
                n=acc.n + jnp.sum(pw, axis=0),
                sum_x=acc.sum_x + jnp.dot(
                    pw.T, xb, preferred_element_type=jnp.float32),
                sum_xx=acc.sum_xx + jnp.dot(
                    pw.T, xb * xb, preferred_element_type=jnp.float32),
                llk=acc.llk + jnp.sum(llk * wb) / n_model,
                count=acc.count + jnp.sum(wb) / n_model,
            ), None

        # varying over BOTH mesh axes (data via ws, model via g)
        zero = jnp.sum(ws[:1]) * 0.0 + jnp.sum(g.weights[:1]) * 0.0
        init = jax.tree.map(
            lambda z: z + zero.astype(z.dtype),
            EmStats.zeros(k // n_model, d, xs.dtype))
        acc, _ = jax.lax.scan(body, init,
                              (xs.reshape(-1, chunk, d),
                               ws.reshape(-1, chunk)))
        # frame-axis merge over "data"; llk/count also merged over "model"
        # (pre-divided above so the double psum is exact)
        return EmStats(
                n=jax.lax.psum(acc.n, "data"),
                sum_x=jax.lax.psum(acc.sum_x, "data"),
                sum_xx=jax.lax.psum(acc.sum_xx, "data"),
                llk=jax.lax.psum(acc.llk, ("data", "model")),
                count=jax.lax.psum(acc.count, ("data", "model")),
            )

    return _stats(x, w, gmm)


def replicate(mesh: Mesh, tree):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_along_axis(mesh: Mesh, arr: jax.Array, axis_name: str = "data"):
    """Place an array with its leading axis sharded over ``axis_name``."""
    spec = P(axis_name)
    return jax.device_put(arr, NamedSharding(mesh, spec))


def sharded_tv_e_step(mesh: Mesh, stats, model, chunk: int = 64):
    """TV E-step with the speaker axis sharded over mesh axis "data".

    The reference threads estimateAandC over speakers with shared A/C
    accumulators under mutexes (AccumulateTVStat.cpp:1798-1799,1944);
    here each device accumulates its speaker shard's TvAccums and the
    pytree is psum-merged across devices.  The per-speaker i-vector posteriors
    w stay sharded (all_gather-free — they are consumed shard-local by
    downstream per-speaker work).

    Returns (w (S,R) sharded over "data", TvAccums replicated).
    """
    from ..fa.stats import BwStats
    from ..fa.tv import tv_e_step

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P()),
        out_specs=(P("data"), P()),
        check_vma=False,   # scan carry starts unvarying (zeros init)
    )
    def _estep(n_loc, f_loc, mdl):
        w, acc = tv_e_step(BwStats(n=n_loc, f=f_loc), mdl, chunk=chunk)
        return w, jax.lax.psum(acc, axis_name="data")

    # pad the speaker axis to the shard count; a zero-stat row has w=0 and
    # contributes exactly I to r_mat (its posterior cov is the prior) and
    # 1 to n_utts — corrected below so sharded == serial
    n_data = mesh.shape["data"]
    s_real = stats.n.shape[0]
    (n_p, f_p), _ = _pad_leading([stats.n, stats.f], n_data)
    pad = n_p.shape[0] - s_real
    w, acc = _estep(n_p, f_p, model)
    if pad:
        acc = acc.replace(
            r_mat=acc.r_mat - pad * jnp.eye(acc.r_mat.shape[0],
                                            dtype=acc.r_mat.dtype),
            n_utts=acc.n_utts - pad)
    return w[:s_real], acc


def _pad_leading(arrs, n_shards: int):
    """Zero-pad the shared leading axis of a list of arrays to a multiple
    of n_shards.  Zero rows carry zero stats/weights, so every consumer
    below is exact under padding."""
    n = arrs[0].shape[0]
    pad = (-n) % n_shards
    if not pad:
        return arrs, n
    out = [jnp.concatenate(
        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs]
    return out, n


def sharded_subspace_accums(mesh: Mesh, t: jax.Array, inv_var: jax.Array,
                            n: jax.Array, fbar: jax.Array):
    """JFA/TV subspace A/C accumulation with the entity (speaker or
    session) axis sharded over mesh axis "data".

    The analogue of the reference's threaded estimateVEVT/estimateYandV
    (AccumulateJFAStat.cpp:1255/2457: per-thread speaker ranges merged
    into shared _vEvT/_Aev under joins); here each device accumulates
    its shard's SubspaceAccums and the pytree is psum-merged.
    Zero-stat padding rows contribute exactly nothing (A sums n·(cov+mmᵀ),
    C sums mean⊗F̄ with mean=0 for zero stats).
    """
    from ..fa.jfa import _accumulate_subspace, _latent_posterior, \
        _subspace_gram

    n_data = mesh.shape["data"]
    (n, fbar), _ = _pad_leading([n, fbar], n_data)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data")),
        out_specs=(P("data"), P()),
    )
    def _acc(t_, iv_, gram_, n_loc, fbar_loc):
        mean, cov = _latent_posterior(t_, iv_, gram_, n_loc, fbar_loc)
        acc = _accumulate_subspace(n_loc, fbar_loc, mean, cov)
        return mean, jax.lax.psum(acc, axis_name="data")

    gram = _subspace_gram(t, inv_var)
    return _acc(t, inv_var, gram, n, fbar)


def sharded_jfa_v_iteration(mesh: Mesh, stats, model, x: jax.Array,
                            z: jax.Array):
    """EigenVoice EM iteration with speakers sharded over "data" —
    sharded == serial (tested).  Residual construction (session→speaker
    channel-stat aggregation) stays a global einsum; the per-speaker
    L-solves and A/C accumulation shard."""
    from ..fa.jfa import _solve_subspace, v_residual

    n, fbar = v_residual(stats, model, x, z)
    s = n.shape[0]
    y, acc = sharded_subspace_accums(mesh, model.v, model.ubm_inv_var,
                                     n, fbar)
    return model.replace(v=_solve_subspace(acc)), y[:s]


def sharded_jfa_u_iteration(mesh: Mesh, stats, model, y: jax.Array,
                            z: jax.Array):
    """EigenChannel EM iteration with sessions sharded over "data"."""
    from ..fa.jfa import _solve_subspace, u_residual

    n, fbar = u_residual(stats, model, y, z)
    h = n.shape[0]
    x, acc = sharded_subspace_accums(mesh, model.u, model.ubm_inv_var,
                                     n, fbar)
    return model.replace(u=_solve_subspace(acc)), x[:h]


def sharded_plda_em_iteration(mesh: Mesh, model, dev):
    """PLDA EM iteration with the SESSION axis sharded over "data".

    The analogue of the reference's threaded getExpectedValues
    (PldaTools.cpp:2647: per-thread speaker ranges, mutex-guarded _EhT /
    _xhT accumulators): session-level matmuls shard, cross-session sums
    psum across devices, and the (S,rf,rf) speaker solves are replicated (they
    are identical on every shard), so sharded == serial exactly.
    """
    from ..backend.plda import plda_em_core

    n_data = mesh.shape["data"]
    w = jnp.ones(dev.vectors.shape[0], jnp.float32)
    ids = jnp.asarray(dev.spk_ids, jnp.int32)
    (xv, w, ids), _ = _pad_leading([jnp.asarray(dev.vectors), w, ids],
                                   n_data)
    n_speakers = int(dev.n_speakers)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data")),
        out_specs=P(),
    )
    def _iter(mdl, x_loc, ids_loc, w_loc):
        return plda_em_core(
            mdl, x_loc, ids_loc, n_speakers, w=w_loc,
            reduce_fn=lambda v: jax.lax.psum(v, axis_name="data"))

    return _iter(model, xv, ids, w)


def sharded_plda_llr(mesh: Mesh, model, enroll: jax.Array,
                     n_sessions: jax.Array, test: jax.Array) -> jax.Array:
    """Batched PLDA trial scoring with the MODEL axis sharded over
    "data" (the analogue of the reference's threaded scoring loop,
    PldaTools.cpp:4061).  Each device scores its model shard against the
    full (replicated) test set; the (M, T) score matrix comes back
    model-sharded and is gathered by the caller's device_get."""
    from ..backend.plda import plda_llr

    n_data = mesh.shape["data"]
    m = enroll.shape[0]
    (enroll_p, ns_p), _ = _pad_leading(
        [enroll, jnp.maximum(jnp.asarray(n_sessions, jnp.float32), 1.0)],
        n_data)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P()),
        out_specs=P("data"),
    )
    def _score(mdl, e_loc, ns_loc, t_):
        return plda_llr(mdl, e_loc, ns_loc, t_)

    return _score(model, enroll_p, ns_p, test)[:m]


def sharded_estimate_w(mesh: Mesh, stats, model, chunk: int = 64,
                       solver: str = "pcg", pcg_iters: int = 16,
                       pcg_tol: float = 1e-7):
    """i-vector extraction with the utterance axis sharded over "data".

    Extraction is embarrassingly parallel (estimateW[Un]Threaded,
    AccumulateTVStat.cpp:2103-2267: the reference splits the file list
    across threads with no shared accumulator), so NO collective is
    needed: tett/tn and the PCG preconditioner basis (seeded from the
    GLOBAL occupancy mean, computed on the replicated stats BEFORE the
    shard_map) enter every shard replicated — the basis and hence every
    iterate is identical to the serial path, so sharded == serial to
    reduction-order noise.  (With ``pcg_tol > 0`` the early-exit
    iteration COUNT is decided per local chunk, so shard and serial
    chunks may stop at different iterations — both within pcg_tol of
    the exact solve, which is far inside the parity tolerances.)

    Returns w (S, R) sharded over "data" (gathered on exit).
    """
    from ..fa.tv import (_pcg_basis, _posterior_mean, _posterior_mean_pcg,
                         estimate_tett)

    if solver not in ("pcg", "cholesky"):
        raise ValueError(f"unknown estimate_w solver {solver}")

    tett = estimate_tett(model)
    tn_flat = (model.t * model.ubm_inv_var[None]).reshape(model.rank, -1)
    if solver == "pcg":
        q, dk = _pcg_basis(model, jnp.mean(stats.n, axis=0))
    else:
        q = dk = jnp.zeros((0,), jnp.float32)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P(), P(), P(), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    def _extract(n_loc, f_loc, mdl, tt, tn, qq, dd):
        s_loc, k = n_loc.shape
        d = mdl.dim
        pad = (-s_loc) % chunk
        n_p = jnp.concatenate([n_loc, jnp.zeros((pad, k), n_loc.dtype)])
        f_p = jnp.concatenate([f_loc, jnp.zeros((pad, k, d), f_loc.dtype)])

        def block(blk):
            n_blk, f_blk = blk
            if solver == "pcg":
                w_blk, _ = _posterior_mean_pcg(n_blk, f_blk, mdl, tt, tn,
                                               qq, dd, pcg_iters, pcg_tol)
                return w_blk
            return _posterior_mean(n_blk, f_blk, mdl, tt, tn)

        w = jax.lax.map(block, (n_p.reshape(-1, chunk, k),
                                f_p.reshape(-1, chunk, k, d)))
        return w.reshape(-1, mdl.rank)[:s_loc]

    n_data = mesh.shape["data"]
    s_real = stats.n.shape[0]
    fbar = stats.centered(model.ubm_means)          # F̄ = F − N·m
    (n_p, f_p), _ = _pad_leading([stats.n, fbar], n_data)
    w = _extract(n_p, f_p, model, tett, tn_flat, q, dk)
    return w[:s_real]


def sharded_tv_e_step_2d(mesh: Mesh, stats, model, chunk: int = 32):
    """TV E-step sharded over BOTH axes: speakers over "data" AND the
    GMM component axis over "model".

    This is the >HBM case of SURVEY §2.6 ("shard the T-matrix and
    per-component A_c accumulators over devices when > HBM"; tett + A
    at K=4096/R=600 take ~12 GB).  Each device holds only its K/m slice of T, tett, F̄ and
    the A/C accumulators; the per-utterance (B,R,R) L build and (B,R)
    aux are partial sums over local components, psum-merged over
    "model" (the ONLY cross-component collectives — R²-sized, tiny
    next to the sharded K·R² state), after which the batched Cholesky
    solve runs replicated within each model group, so sharded == serial
    to reduction order.

    Returns (w (S,R) sharded over "data", TvAccums with a/c sharded
    over "model" and r_mat/r_vec/n_utts replicated).
    """
    from ..fa.tv import TvAccums

    r = model.rank
    k, d = model.ubm_means.shape
    n_model = mesh.shape["model"]
    n_data = mesh.shape["data"]
    assert k % n_model == 0, (k, n_model)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data", "model"), P("data", "model", None),
                  P(None, "model", None), P("model"), P("model")),
        out_specs=(P("data"),
                   TvAccums(a=P("model"), c=P(None, "model"),
                            r_mat=P(), r_vec=P(), n_utts=P())),
        check_vma=False,
    )
    def _estep(n_loc, f_loc, t_loc, means_loc, iv_loc):
        s_loc, k_loc = n_loc.shape
        # local tett / T·Σ⁻¹ over this shard's components
        tett = jnp.einsum("rkd,kd,qkd->krq", t_loc, iv_loc, t_loc,
                          preferred_element_type=jnp.float32)
        tn_flat = (t_loc * iv_loc[None]).reshape(r, -1)
        fbar = f_loc - n_loc[..., None] * means_loc[None]
        pad = (-s_loc) % chunk
        n_p = jnp.concatenate([n_loc, jnp.zeros((pad, k_loc),
                                                n_loc.dtype)])
        f_p = jnp.concatenate([fbar, jnp.zeros((pad, k_loc, d),
                                               fbar.dtype)])
        valid = jnp.concatenate([jnp.ones((s_loc,), jnp.float32),
                                 jnp.zeros((pad,), jnp.float32)])
        eye = jnp.eye(r, dtype=jnp.float32)

        def body(acc, blk):
            n_blk, f_blk, v_blk = blk
            b = n_blk.shape[0]
            # partial L/aux over LOCAL components → psum over "model"
            l_part = jnp.dot(n_blk, tett.reshape(k_loc, r * r),
                             preferred_element_type=jnp.float32
                             ).reshape(b, r, r)
            l_mat = eye[None] + jax.lax.psum(l_part, axis_name="model")
            aux = jax.lax.psum(
                jnp.dot(f_blk.reshape(b, -1), tn_flat.T,
                        preferred_element_type=jnp.float32),
                axis_name="model")
            chol = jnp.linalg.cholesky(l_mat)
            w = jax.scipy.linalg.cho_solve((chol, True),
                                           aux[..., None])[..., 0]
            linv = jax.scipy.linalg.cho_solve(
                (chol, True), jnp.broadcast_to(eye, l_mat.shape))
            w = w * v_blk[:, None]
            cov = (linv + jnp.einsum("br,bq->brq", w, w)) \
                * v_blk[:, None, None]
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

        acc, w_blocks = jax.lax.scan(
            body, TvAccums.zeros(r, k_loc, d),
            (n_p.reshape(-1, chunk, k_loc),
             f_p.reshape(-1, chunk, k_loc, d),
             valid.reshape(-1, chunk)))
        # a/c stay component-sharded; everything merges over "data"
        acc = TvAccums(
            a=jax.lax.psum(acc.a, "data"),
            c=jax.lax.psum(acc.c, "data"),
            r_mat=jax.lax.psum(acc.r_mat, "data"),
            r_vec=jax.lax.psum(acc.r_vec, "data"),
            n_utts=jax.lax.psum(acc.n_utts, "data"))
        return w_blocks.reshape(-1, r)[:s_loc], acc

    s_real = stats.n.shape[0]
    (n_p, f_p), _ = _pad_leading([stats.n, stats.f], n_data)
    pad = n_p.shape[0] - s_real
    w, acc = _estep(n_p, f_p, model.t, model.ubm_means, model.ubm_inv_var)
    if pad:
        # zero-stat padding rows contribute exactly I to r_mat and 1 to
        # n_utts (their posterior covariance is the prior) — corrected
        # here so sharded == serial (same fix as sharded_tv_e_step)
        acc = acc.replace(
            r_mat=acc.r_mat - pad * jnp.eye(r, dtype=acc.r_mat.dtype),
            n_utts=acc.n_utts - pad)
    return w[:s_real], acc
