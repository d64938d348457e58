"""On-chip sweep: PCG iteration count for exact i-vector extraction.

κ of the preconditioned systems is ~1.6 (PERF.md §7), so the fixed
20-iteration default is conservative: error contracts ~(√κ−1)/(√κ+1) ≈
0.12 per iteration ⇒ f32 roundoff in ~8-10.  Measures max dev vs the
batched-Cholesky path and the extraction wall at each iteration count,
for both uniform and heavily skewed (Dirichlet) occupancy profiles —
the profile-mismatch case the preconditioner basis (batch-mean
occupancy) is weakest on.  Informs the estimate_w pcg_iters default."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from lia_ral.fa.stats import BwStats
from lia_ral.fa.tv import estimate_w, init_t
from lia_ral.gmm.model import GmmDiag

K, D, R, S = 2048, 39, 400, 500
rng = np.random.default_rng(0)
gmm = GmmDiag.create(np.full(K, 1.0 / K),
                     rng.standard_normal((K, D)).astype(np.float32),
                     (rng.random((K, D)) + 0.5).astype(np.float32))
model = init_t(jax.random.key(0), R, gmm, scale=0.01)

cases = {
    "uniform-occ": jnp.asarray(
        rng.random((S, K)).astype(np.float32) * 2 * 2000 / K),
    "dirichlet-occ (skewed)": jnp.asarray(
        (rng.dirichlet(np.full(K, 0.05), S) * 2000).astype(np.float32)),
    "long-utt 100k frames": jnp.asarray(
        (rng.dirichlet(np.full(K, 0.5), S) * 100_000).astype(np.float32)),
}
f_st = jnp.asarray((rng.standard_normal((S, K, D)) * 3).astype(np.float32))

for tag, n_st in cases.items():
    stats = BwStats(n=n_st, f=f_st)
    w_chol = np.asarray(estimate_w(stats, model, solver="cholesky"))
    scale = np.max(np.abs(w_chol))
    cfgs = ((6, 0.0), (8, 0.0), (10, 0.0), (12, 0.0), (16, 0.0), (20, 0.0),
            (16, 1e-6), (16, 1e-7), (16, 1e-8))
    if os.environ.get("SWEEP_PCG_FAST"):      # early-exit A/B only
        cfgs = ((16, 0.0), (16, 1e-7), (16, 1e-6))
    for iters, tol in cfgs:
        w_p, rel = estimate_w(stats, model, solver="pcg", pcg_iters=iters,
                              pcg_tol=tol, return_diag=True)
        dev = float(np.max(np.abs(np.asarray(w_p) - w_chol)) / scale)
        res = float(np.max(np.asarray(rel)))
        # timed: chained fresh-input passes like bench.py
        fn = jax.jit(lambda st, e, it=iters, tl=tol: estimate_w(
            BwStats(n=st.n * (1.0 + e), f=st.f), model, solver="pcg",
            pcg_iters=it, pcg_tol=tl))
        w = fn(stats, jnp.zeros((), jnp.float32))
        float(w[0, 0])
        t0 = time.perf_counter()
        for _ in range(3):
            w = fn(stats, w[0, 0] * 1e-9)
        float(w[0, 0])
        dt = (time.perf_counter() - t0) / 3
        print(f"{tag:24s} iters={iters:2d} tol={tol:.0e}  "
              f"dev-vs-chol {dev:.2e}  resid {res:.2e}  "
              f"wall {dt*1000:7.1f} ms", flush=True)
