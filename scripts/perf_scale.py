"""Scale-shape validation of the FA stack on the chip (PERF.md source).

Runs each heavy stage ONCE at the BASELINE milestone shapes
(K=2048, D=39, R=400 TV; JFA 300 EV / 100 EC + D; PLDA rank 150 on
400-dim vectors) and records wall time + HBM survival:

  * TV EM iteration (E-step chunked batched-Cholesky + M-step per-
    component solves over (K, R, R) A_c batches + min-divergence)
  * estimateW exact + ubmWeight + eigenDecomposition approximations
  * JFA V/U/D iterations over session stats
  * PLDA EM iteration + pldaNativeScoring on a trial matrix

Usage: python scripts/perf_scale.py [--speakers N] [--chunk N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--speakers", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from lia_ral.backend.ivnorm import DevSet
    from lia_ral.backend.plda import (PldaModel, plda_em_iteration,
                                          plda_llr)
    from lia_ral.fa.jfa import (JfaModel, JfaStats, estimate_y,
                                    jfa_d_iteration, jfa_u_iteration,
                                    jfa_v_iteration)
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import (TvModel, approximate_tctc, estimate_w,
                                   estimate_w_eigen_decomposition,
                                   estimate_w_ubm_weight, eigen_decompose_w,
                                   init_t, tv_em_iteration, weighted_cov)
    from lia_ral.gmm.model import GmmDiag

    K, D, R = 2048, 39, 400
    RV, RU = 300, 100
    PL = 150
    S = args.speakers
    rng = np.random.default_rng(0)
    gmm = GmmDiag.create(np.full(K, 1.0 / K),
                         rng.standard_normal((K, D)).astype(np.float32),
                         (rng.random((K, D)) + 0.5).astype(np.float32))
    # synthetic BW stats for S sessions (~2000 frames each)
    n_st = jnp.asarray(rng.random((S, K)).astype(np.float32) * 2000 / K)
    f_st = jnp.asarray(
        (rng.standard_normal((S, K, D)) * 3).astype(np.float32)
        * np.asarray(n_st)[:, :, None])
    stats = BwStats(n=n_st, f=f_st)
    times = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        out = jax.block_until_ready(out)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a, **kw))
        dt = time.perf_counter() - t0
        times[name] = round(dt, 3)
        print(json.dumps({"stage": name, "wall_s": round(dt, 3),
                          "first_call_s": round(compile_s, 1)}), flush=True)
        return out

    model = init_t(jax.random.key(0), R, gmm, scale=0.01)
    model, _wiv = timed("tv_em_iteration  (S=%d,K=%d,R=%d)" % (S, K, R),
                        tv_em_iteration, stats, model, chunk=args.chunk)
    w = timed("estimate_w exact", estimate_w, stats, model,
              chunk=args.chunk)
    wmat = weighted_cov(model, gmm.weights)
    timed("estimate_w ubmWeight", estimate_w_ubm_weight, stats, model, wmat)
    q = eigen_decompose_w(wmat)
    d_mat = approximate_tctc(model, q)
    timed("estimate_w eigenDecomposition", estimate_w_eigen_decomposition,
          stats, model, d_mat, q)
    del w

    # JFA: sessions→speakers (2 sessions per speaker)
    sess_spk = np.repeat(np.arange(S // 2), 2)
    jstats = JfaStats.from_sessions(stats, sess_spk, S // 2)
    jmodel = JfaModel.init(jax.random.key(1), RV, RU, gmm)
    x0 = jnp.zeros((S, RU), jnp.float32)
    z0 = jnp.zeros((S // 2, K, D), jnp.float32)
    jmodel, y = timed("jfa_v_iteration (RV=%d)" % RV, jfa_v_iteration,
                      jstats, jmodel, x0, z0)
    jmodel, x = timed("jfa_u_iteration (RU=%d)" % RU, jfa_u_iteration,
                      jstats, jmodel, y, z0)
    jmodel, z = timed("jfa_d_iteration", jfa_d_iteration, jstats, jmodel,
                      y, x)

    # PLDA at rank 150 over 400-dim vectors
    n_pl_spk = max(S // 2, PL + 8)
    ivs = jnp.asarray(rng.standard_normal((n_pl_spk * 3, R)), jnp.float32)
    dev = DevSet(vectors=ivs,
                 spk_ids=jnp.asarray(np.repeat(np.arange(n_pl_spk), 3)),
                 n_speakers=n_pl_spk)
    pmodel = PldaModel.init(jax.random.key(2), R, PL)
    pmodel = timed("plda_em_iteration (rank=%d)" % PL, plda_em_iteration,
                   pmodel, dev)
    enroll = jnp.asarray(rng.standard_normal((200, R)), jnp.float32)
    test = jnp.asarray(rng.standard_normal((200, R)), jnp.float32)
    ns = jnp.ones((200,), jnp.float32)
    timed("plda_native_scoring 200x200", plda_llr, pmodel, enroll, ns, test)

    dev = str(jax.devices()[0])
    print(json.dumps({"platform": dev, "speakers": S,
                      "chunk": args.chunk, "times_s": times}))


if __name__ == "__main__":
    main()
