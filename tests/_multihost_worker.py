"""Worker for tests/test_multihost.py: one of N coordinated CPU processes.

Usage: python _multihost_worker.py <coordinator> <num_procs> <pid> <outdir>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lia_ral.gmm.kernels import em_stats
from lia_ral.gmm.model import GmmDiag
from lia_ral.parallel.distributed import (global_stats, host_local_batch,
                                              initialize_from_env,
                                              make_global_mesh,
                                              shard_file_list)


def corpus(n=4096, d=8, k=6):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    gw = rng.random(k) + 0.1
    gmm = GmmDiag.create(gw / gw.sum(),
                         rng.standard_normal((k, d)).astype(np.float32),
                         (rng.random((k, d)) + 0.5).astype(np.float32))
    return x, w, gmm


def main():
    coord, nproc, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    assert initialize_from_env(coord, nproc, pid)
    assert jax.process_count() == nproc
    x, w, gmm = corpus()
    # host-local slice: contiguous frame blocks per process (each "host"
    # loads only its shard, as shard_file_list would for file lists)
    per = x.shape[0] // nproc
    xl, wl = x[pid * per:(pid + 1) * per], w[pid * per:(pid + 1) * per]
    mesh = make_global_mesh()
    gx, gw_arr = host_local_batch(mesh, xl, wl)
    stats = global_stats(mesh, lambda a, b, g: em_stats(a, b, g),
                         gx, gw_arr, gmm)
    # file-list sharding is deterministic and disjoint
    names = [f"f{i}" for i in range(10)]
    mine = shard_file_list(names)
    with open(os.path.join(outdir, f"names_{pid}.txt"), "w") as f:
        f.write(" ".join(mine))
    if jax.process_index() == 0:
        np.savez(os.path.join(outdir, "stats.npz"),
                 n=np.asarray(stats.n), sum_x=np.asarray(stats.sum_x),
                 sum_xx=np.asarray(stats.sum_xx),
                 llk=np.asarray(stats.llk), count=np.asarray(stats.count))

    # cross-host PLDA EM: the session axis shard_maps over the GLOBAL
    # mesh, so the cross-session reduce_fn psums ride DCN between the
    # two processes (the multi-host form of PldaTools.cpp:2647's
    # mutex-guarded accumulators)
    from lia_ral.backend.plda import PldaModel
    from lia_ral.parallel.sharding import sharded_plda_em_iteration
    vecs, labels, model = plda_problem()
    from lia_ral.backend.ivnorm import DevSet
    dev = DevSet.from_labels(vecs, labels)
    new = sharded_plda_em_iteration(mesh, model, dev)
    if jax.process_index() == 0:
        np.savez(os.path.join(outdir, "plda.npz"),
                 f=np.asarray(new.f), g=np.asarray(new.g),
                 sigma=np.asarray(new.sigma), mean=np.asarray(new.mean))
    # cross-host TV E-step: speakers shard over the GLOBAL mesh, the
    # TvAccums psums ride DCN (the multi-host form of the threaded
    # estimateAandC accumulators, AccumulateTVStat.cpp:1944)
    from lia_ral.parallel.sharding import sharded_tv_e_step
    stats_tv, tv_model = tv_problem()
    w_iv, acc = sharded_tv_e_step(mesh, stats_tv, tv_model, chunk=2)
    if jax.process_index() == 0:
        np.savez(os.path.join(outdir, "tv.npz"),
                 a=np.asarray(acc.a), c=np.asarray(acc.c),
                 r_mat=np.asarray(acc.r_mat),
                 r_vec=np.asarray(acc.r_vec))
    # cross-host JFA V iteration: speakers shard over the GLOBAL mesh,
    # the SubspaceAccums psum rides DCN (the multi-host form of the
    # reference's threaded estimateVEVT merge,
    # AccumulateJFAStat.cpp:1573)
    from jax.experimental.multihost_utils import process_allgather

    from lia_ral.parallel.sharding import sharded_jfa_v_iteration
    jstats, jmodel, jx, jz = jfa_problem()
    jnew, y = sharded_jfa_v_iteration(mesh, jstats, jmodel, jx, jz)
    y_all = process_allgather(y, tiled=True)      # (S,rv) spans both hosts
    if jax.process_index() == 0:
        np.savez(os.path.join(outdir, "jfa.npz"),
                 v=np.asarray(jnew.v), y=np.asarray(y_all))
    # cross-host i-vector extraction: utterances shard over the GLOBAL
    # mesh; no collective in the solve itself (per-utterance systems),
    # preconditioner basis replicated (sharded_estimate_w docstring)
    from lia_ral.parallel.sharding import sharded_estimate_w
    w_iv2 = sharded_estimate_w(mesh, stats_tv, tv_model, chunk=2,
                               pcg_iters=12)
    w_all = process_allgather(w_iv2, tiled=True)
    if jax.process_index() == 0:
        np.savez(os.path.join(outdir, "w_iv.npz"), w=np.asarray(w_all))
    print(f"proc {pid}: ok", flush=True)


def tv_problem():
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import init_t
    rngt = np.random.default_rng(9)
    k, d, r, s = 6, 4, 3, 8
    gw = rngt.random(k) + 0.5
    gmm_t = GmmDiag.create(gw / gw.sum(),
                           rngt.standard_normal((k, d)).astype(np.float32),
                           (rngt.random((k, d)) + 0.5).astype(np.float32))
    model = init_t(jax.random.key(5), r, gmm_t)
    stats = BwStats(
        n=np.asarray(rngt.random((s, k)) * 20 + 1, np.float32),
        f=np.asarray(rngt.standard_normal((s, k, d)) * 3, np.float32))
    return stats, model


def jfa_problem():
    from lia_ral.fa.jfa import JfaModel, JfaStats
    from lia_ral.fa.stats import BwStats
    rngj = np.random.default_rng(11)
    k, d, h, spk, rv = 6, 4, 12, 4, 2
    gw = rngj.random(k) + 0.5
    gmm_j = GmmDiag.create(gw / gw.sum(),
                           rngj.standard_normal((k, d)).astype(np.float32),
                           (rngj.random((k, d)) + 0.5).astype(np.float32))
    sess = BwStats(
        n=np.asarray(rngj.random((h, k)) * 20 + 1, np.float32),
        f=np.asarray(rngj.standard_normal((h, k, d)) * 3, np.float32))
    stats = JfaStats.from_sessions(sess, [i % spk for i in range(h)], spk)
    import jax as _jax
    model = JfaModel.init(_jax.random.key(4), rv, rv, gmm_j, scale=0.1)
    x = np.asarray(rngj.standard_normal((h, rv)) * 0.1, np.float32)
    z = np.zeros_like(np.asarray(stats.spk.f))
    return stats, model, x, z


def plda_problem():
    from lia_ral.backend.plda import PldaModel
    rngp = np.random.default_rng(7)
    vecs = rngp.standard_normal((16, 10)).astype(np.float32)
    labels = [f"s{i % 4}" for i in range(16)]
    model = PldaModel.init(jax.random.key(3), 10, 4, 2,
                           data_mean=vecs.mean(0),
                           data_cov=np.cov(vecs.T).astype(np.float32))
    return vecs, labels, model


if __name__ == "__main__":
    main()
