"""Split estimate_w (exact i-vector extraction) cost on-chip: TETt Gram
vs chunked {L build} vs {L build + Cholesky solve}.  Uses the same
lax.map-chunked structure as fa.tv._posterior (a monolithic S=500 L-build
einsum crashes the remote compile helper).  Results in PERF.md."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from lia_ral.fa.stats import BwStats
from lia_ral.fa.tv import estimate_tett, estimate_w, init_t
from lia_ral.gmm.model import GmmDiag

K, D, R, S = 2048, 39, 400, 500
CHUNK = 64
rng = np.random.default_rng(0)
gmm = GmmDiag.create(np.full(K, 1.0 / K),
                     rng.standard_normal((K, D)).astype(np.float32),
                     (rng.random((K, D)) + 0.5).astype(np.float32))
model = init_t(jax.random.key(0), R, gmm, scale=0.01)
n_st = jnp.asarray(rng.random((S, K)).astype(np.float32) * 2000 / K)
f_st = jnp.asarray((rng.standard_normal((S, K, D)) * 3).astype(np.float32))
stats = BwStats(n=n_st, f=f_st)


def timeit(tag, fn, fetch):
    out = fn()
    float(np.asarray(fetch(out)).ravel()[0])
    t0 = time.perf_counter()
    for _ in range(3):
        out = fn()
    float(np.asarray(fetch(out)).ravel()[0])
    dt = (time.perf_counter() - t0) / 3
    print(f"{tag:36s} {dt*1000:8.1f} ms", flush=True)
    return out


tett = timeit("tett Gram (K,R,R)", lambda: jax.jit(estimate_tett)(model),
              lambda o: o[0, 0, 0])


def chunked(do_solve: bool):
    @jax.jit
    def run(n, f):
        tn = model.t * jnp.sqrt(model.ubm_inv_var)[None]
        fn_ = f * jnp.sqrt(model.ubm_inv_var)[None]
        aux = jnp.einsum("rkd,skd->sr", tn, fn_,
                         preferred_element_type=jnp.float32)
        eye = jnp.eye(R, dtype=jnp.float32)

        def block(blk):
            n_b, a_b = blk
            l_mat = eye[None] + jnp.einsum(
                "sk,krq->srq", n_b, tett,
                preferred_element_type=jnp.float32)
            if not do_solve:
                return jnp.sum(l_mat, axis=(1, 2)) + a_b[:, 0]
            chol = jnp.linalg.cholesky(l_mat)
            return jax.scipy.linalg.cho_solve(
                (chol, True), a_b[..., None])[..., 0].sum(-1)

        return jax.lax.map(block, (n.reshape(-1, CHUNK, K),
                                   aux.reshape(-1, CHUNK, R)))
    return run


timeit("chunked L build only", lambda: chunked(False)(stats.n, stats.f),
       lambda o: o[0, 0])
timeit("chunked L + cholesky solve", lambda: chunked(True)(stats.n, stats.f),
       lambda o: o[0, 0])
timeit("estimate_w full", lambda: estimate_w(stats, model, chunk=CHUNK),
       lambda o: o[0, 0])
