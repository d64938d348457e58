"""Sustained serving throughput through the TCP wire protocol.

Complements milestone_audio.py (single-stream latency): N concurrent
clients loop {send features → verify} against a SpkDetServer
(SpkDetServer.cpp:845 protocol) for a fixed duration, measuring
sustained verifications/s and per-request latency percentiles at
concurrency 1 / 4 / 8.

The server handles each connection in a thread; device work serialises
through the single chip, so concurrency mainly pipelines host-side
protocol/feature handling against device dispatches — the measured
scaling factor IS the result.

Usage: python scripts/bench_serving.py [--seconds 10] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

K, D = 128, 24
T_TEST = 300          # 3 s of 10 ms frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from lia_ral.api import RemoteSpkDetClient, SpkDetServer
    from lia_ral.config import Config
    from lia_ral.gmm.em import TrainCfg, mixture_init, train_model
    from lia_ral.gmm.map_adapt import MapCfg, adapt_model

    rng = np.random.default_rng(7)
    centers = rng.standard_normal((64, D)) * 2.0

    def utt(off, n):
        comp = rng.integers(0, 64, n)
        return (centers[comp] + off
                + rng.standard_normal((n, D)) * 0.7).astype(np.float32)

    bg = jnp.asarray(utt(0.0, 60_000))
    w = jnp.ones(bg.shape[0], jnp.float32)
    init = mixture_init(jax.random.key(0), bg, w, K, 1.0)
    ubm = train_model(jax.random.key(1), bg, w, init,
                      TrainCfg(nb_train_it=3))
    off = rng.standard_normal(D) * 0.8
    spk = adapt_model(jax.random.key(2), jnp.asarray(utt(off, 2000)),
                      jnp.ones(2000, jnp.float32), ubm,
                      MapCfg(method="MAPOccDep", mean_adapt=True,
                             mean_r=14.0, nb_train_it=2))
    import tempfile
    d = tempfile.mkdtemp(prefix="srv_bench_")
    ubm.save(os.path.join(d, "wld.gmm"))
    spk.save(os.path.join(d, "spk.gmm"))

    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    results = {}
    try:
        test_feats = [utt(off, T_TEST) for _ in range(8)]

        def worker(idx, stop, lat, cnt):
            cli = RemoteSpkDetClient(port=port)
            cli.load_world(os.path.join(d, "wld.gmm"))
            cli.load_speaker("spk", os.path.join(d, "spk.gmm"))
            f = test_feats[idx % len(test_feats)]
            while not stop.is_set():
                t0 = time.perf_counter()
                cli.reset_features()
                cli.send_features(f)
                cli.verify("spk")
                lat.append(time.perf_counter() - t0)
                cnt[0] += 1
            cli.close()

        for conc in (1, 4, 8):
            stop = threading.Event()
            lats: list[list[float]] = [[] for _ in range(conc)]
            cnts = [[0] for _ in range(conc)]
            threads = [threading.Thread(
                target=worker, args=(i, stop, lats[i], cnts[i]))
                for i in range(conc)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            time.sleep(args.seconds)
            stop.set()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            all_lat = np.asarray(sum(lats, [])) * 1000.0
            total = sum(c[0] for c in cnts)
            results[f"conc{conc}"] = {
                "verifies_per_s": round(total / wall, 1),
                "p50_ms": round(float(np.percentile(all_lat, 50)), 1),
                "p95_ms": round(float(np.percentile(all_lat, 95)), 1),
            }
            print(json.dumps({f"conc{conc}": results[f"conc{conc}"]}),
                  flush=True)
    finally:
        srv.stop()

    # ---- scale-out path: N SimpleSpkDetSystem instances sharing the
    # chip (MILESTONE.md's claim that scale-out serving bypasses the
    # stateful wire session and uses the API per process — measured
    # here with per-thread instances, the same chip-contention shape
    # as N processes with warm compile caches), plus the batched
    # identify path (M speakers scored in ONE dispatch) ----------------
    from lia_ral.api import SimpleSpkDetSystem

    def make_sys(n_speakers=1):
        s = SimpleSpkDetSystem(Config())
        s.set_background_model(ubm)
        for m in range(n_speakers):
            s.speakers[f"spk{m}"] = spk
        return s

    for conc in (1, 4, 8):
        systems = [make_sys() for _ in range(conc)]
        # warm every instance before timing
        for s_api in systems:
            s_api.add_features(test_feats[0])
            s_api.verify_speaker("spk0")
        stop = threading.Event()
        lats = [[] for _ in range(conc)]
        cnts = [[0] for _ in range(conc)]

        def api_worker(idx, stop, lat, cnt):
            s_api = systems[idx]
            f = test_feats[idx % len(test_feats)]
            while not stop.is_set():
                t0 = time.perf_counter()
                s_api.reset_features()
                s_api.add_features(f)
                s_api.verify_speaker("spk0")
                lat.append(time.perf_counter() - t0)
                cnt[0] += 1

        threads = [threading.Thread(target=api_worker,
                                    args=(i, stop, lats[i], cnts[i]))
                   for i in range(conc)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        all_lat = np.asarray(sum(lats, [])) * 1000.0
        total = sum(c[0] for c in cnts)
        results[f"api_conc{conc}"] = {
            "verifies_per_s": round(total / wall, 1),
            "p50_ms": round(float(np.percentile(all_lat, 50)), 1),
            "p95_ms": round(float(np.percentile(all_lat, 95)), 1),
        }
        print(json.dumps({f"api_conc{conc}": results[f"api_conc{conc}"]}),
              flush=True)

    # batched identify: M enrolled speakers scored in one dispatch
    m_spk = 64
    s_api = make_sys(m_spk)
    s_api.add_features(test_feats[0])
    s_api.identify_speaker()                  # warm/compile
    n_calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        s_api.reset_features()
        s_api.add_features(test_feats[n_calls % len(test_feats)])
        s_api.identify_speaker()
        n_calls += 1
    wall = time.perf_counter() - t0
    results["api_identify_batch"] = {
        "speakers": m_spk,
        "identify_calls_per_s": round(n_calls / wall, 1),
        "speaker_trials_per_s": round(n_calls * m_spk / wall, 1),
    }
    print(json.dumps({"api_identify_batch":
                      results["api_identify_batch"]}), flush=True)

    summary = {
        "milestone": "serving throughput: wire protocol vs API scale-out "
                     "vs batched identify",
        "platform": str(jax.devices()[0]),
        "shapes": {"K": K, "D": D, "t_test": T_TEST,
                   "seconds_per_level": args.seconds},
        "results": results,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
