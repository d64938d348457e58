"""Benchmark: north-star pipeline throughput in audio-seconds/s/card.

North-star metric (BASELINE.md): audio-seconds/s per card for **UBM EM +
i-vector extraction**.  One pipeline pass over N frames (10 ms each) =

  A. one UBM-EM sufficient-statistics pass + M-step (K=2048, D=39)
     through the public statistics path (gmm.stats_path: the fused
     kernel on a GPU; TrainWorld hot loop, AccumulateStat.cpp:103-152);
  B. one Baum-Welch (N,F) stats pass over the same frames as utterances
     (ComputeJFAStats / TVAcc hot loop, AccumulateTVStat.cpp:281-351);
  C. exact i-vector extraction, R=400, per utterance
     (IvExtractor estimateW, AccumulateTVStat.cpp:2103-2267).

vs_baseline divides by a MEASURED CPU figure (BASELINE_CPU.json): the
reference's scalar hot loops re-implemented in C++ (native/
em_baseline.cpp for EM, native/iv_baseline.cpp for BW stats + exact
i-vector estimateW), extrapolated to 32 cores at PERFECT scaling,
harmonically combined across the three stages — a SAME-SCOPE A+B+C
comparison.  The EM-only ratio is reported separately.

Every stage wall is the MEDIAN of 3 timed repeats, each an average over
chained executions that end in ``block_until_ready``; the JSON carries
the relative spread (max−min)/median per stage.  Iterations are chained
(the model feeds back) so every execution is new work.  ``xla_*`` fields
time XLA's plain statistics path (``em_stats_chunked`` at its best
chunk, the vmapped Baum-Welch path) on the same data: the comparison
that keeps the fused kernel.

Runs on an NVIDIA GPU only: without one it exits non-zero.
Usage: python bench.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

K = 2048
D = 39
R = 400
N_FRAMES = 1_000_000        # 10000 audio-seconds per pass
T_UTT = 2000                # frames per utterance for stages B/C
XLA_CHUNK = 16384           # em_stats_chunked's best chunk on an H100
REPEATS = 3                 # median-of-3 per stage

_here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_here, "BASELINE_CPU.json")) as _f:
    _cpu = json.load(_f)
BASELINE_AUDIO_S_PER_S = float(_cpu["baseline_32core_audio_s_per_s"])
BASELINE_PIPELINE = float(_cpu["baseline_32core_pipeline_audio_s_per_s"])


def timed_median(run_iters, iters: int):
    """Median-of-REPEATS wall per chained execution + relative spread."""
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run_iters(iters)
        walls.append((time.perf_counter() - t0) / iters)
    med = statistics.median(walls)
    return med, (max(walls) - min(walls)) / med


def chained(step, state0, *data):
    """A runner of ``state = step(state, *data)`` chains that end in
    block_until_ready; jits ``step`` (data as arguments, not constants)
    and runs it once first."""
    import jax

    step = jax.jit(step)
    jax.block_until_ready(step(state0, *data))

    def run(iters):
        s = state0
        for _ in range(iters):
            s = step(s, *data)
        jax.block_until_ready(s)
    return run


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX sees {dev.platform}); the "
              "benchmark measures the card only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    sys.path.insert(0, _here)
    from lia_ral.fa.stats import BwStats, bw_stats_batch
    from lia_ral.fa.tv import (TvModel, approximate_tctc, eigen_decompose_w,
                               estimate_w, estimate_w_eigen_decomposition,
                               weighted_cov)
    from lia_ral.gmm.em import m_step
    from lia_ral.gmm.kernels import accumulate_bw_stats, em_stats_chunked
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.gmm.stats_path import em_stats

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((N_FRAMES, D)), jnp.float32)
    w = jnp.ones((N_FRAMES,), jnp.float32)
    gmm = GmmDiag.create(np.full(K, 1.0 / K),
                         rng.standard_normal((K, D)).astype(np.float32),
                         (rng.random((K, D)) + 0.5).astype(np.float32))
    audio_seconds = N_FRAMES / 100.0

    # ---- stage A: EM iteration through the public path --------------------
    def em_run(stats_fn):
        return chained(lambda g, a, b: m_step(stats_fn(a, b, g)), gmm, x, w)

    t_em, sp_em = timed_median(em_run(em_stats), 5)
    t_em_fs, _ = timed_median(em_run(
        lambda a, b, g: em_stats(a, b, g, fast_stats=True)), 5)
    t_em_xla, _ = timed_median(em_run(
        lambda a, b, g: em_stats_chunked(a, b, g, chunk=XLA_CHUNK)), 5)

    # ---- stage B: Baum-Welch (N,F) stats over utterances ------------------
    s_utts = N_FRAMES // T_UTT                    # 500
    xu = x[: s_utts * T_UTT].reshape(s_utts, T_UTT, D)
    wm = jnp.ones((s_utts, T_UTT), jnp.float32)

    def bw_run(stats_fn):
        # chain through the MODEL: every execution scores against fresh
        # means, at (K,D) cost instead of perturbing the input tensor
        def step(carry, a, b):
            g, eps = carry
            g = g.replace(means=g.means * (1.0 + eps))
            n, _ = stats_fn(a, b, g)
            return g, n[0, 0] * 1e-9
        return chained(step, (gmm, jnp.zeros((), jnp.float32)), xu, wm)

    def bw_public(a, b, g, fast_stats=False):
        st = bw_stats_batch(a, b, g, fast_stats=fast_stats)
        return st.n, st.f

    t_bw, sp_bw = timed_median(bw_run(bw_public), 3)
    t_bw_fs, _ = timed_median(bw_run(
        lambda a, b, g: bw_public(a, b, g, True)), 3)
    t_bw_xla, _ = timed_median(bw_run(
        lambda a, b, g: jax.vmap(
            lambda xs, ws: accumulate_bw_stats(xs, ws, g))(a, b)), 3)

    # ---- stage C: exact i-vector extraction (R=400) -----------------------
    t_mat = jnp.asarray(rng.standard_normal((R, K, D)) * 0.01, jnp.float32)
    model = TvModel.from_ubm(t_mat, gmm)
    stats = bw_stats_batch(xu, wm, gmm)

    def extract_run(fn):
        # fresh-input chaining: scale N by a value derived from the
        # previous i-vectors so every timed pass is new work
        def step(wv, st, mdl):
            return fn(BwStats(n=st.n * (1.0 + wv[0, 0] * 1e-9), f=st.f),
                      mdl)
        return chained(step, jnp.zeros((s_utts, R), jnp.float32), stats,
                       model)

    t_w, sp_w = timed_median(extract_run(estimate_w), 3)
    sub = BwStats(n=stats.n[:64], f=stats.f[:64])
    w_pcg = np.asarray(estimate_w(sub, model, solver="pcg"))
    w_chol = np.asarray(estimate_w(sub, model, solver="cholesky"))
    pcg_dev = float(np.max(np.abs(w_pcg - w_chol))
                    / max(np.max(np.abs(w_chol)), 1e-9))

    # ---- stage C': eigen-decomposition approximate extraction -------------
    q_mat = eigen_decompose_w(weighted_cov(model, gmm.weights))
    d_mat = approximate_tctc(model, q_mat)
    t_wa, _ = timed_median(extract_run(
        lambda st, mdl: estimate_w_eigen_decomposition(st, mdl, d_mat,
                                                       q_mat)), 3)

    rate = audio_seconds / (t_em + t_bw + t_w)
    print(json.dumps({
        "metric": f"UBM-EM + i-vector pipeline audio-s/s/card "
                  f"(K={K}, D={D}, R={R})",
        "value": rate,
        "unit": "audio_s/s/card",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": smi},
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "vs_baseline": rate / BASELINE_PIPELINE,
        "vs_baseline_em_only": audio_seconds / t_em
        / BASELINE_AUDIO_S_PER_S,
        "em_s": t_em, "bw_s": t_bw, "ivextract_s": t_w,
        "ivextract_approx_s": t_wa,
        "em_faststats_s": t_em_fs, "bw_faststats_s": t_bw_fs,
        "xla_em_s": t_em_xla, "xla_bw_s": t_bw_xla,
        "value_faststats": audio_seconds / (t_em_fs + t_bw_fs + t_w),
        "stage_spread": {"em": sp_em, "bw": sp_bw, "ivextract": sp_w},
        "pcg_vs_cholesky_max_relerr": pcg_dev,
        "pcg_vs_cholesky_ok": bool(pcg_dev < 1e-4),
        "baseline_src": "BASELINE_CPU.json (measured, 32-core perfect-"
                        "scaling, A+B+C harmonically combined)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
