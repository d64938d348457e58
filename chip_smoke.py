#!/usr/bin/env python3
"""Chip smoke test: the K=2048 GMM-UBM + i-vector pipeline on one NVIDIA GPU.

Drives the reference deployment (BASELINE.md configs 3/5: K=2048, D=39,
R=400, PLDA rank 150) through the CLI entry points a user calls, on the
full-scale synthetic corpus of scripts/milestone_eer.py, with only the
iteration counts cut.  Phases, in order; any failure exits non-zero:

  1. device    — a GPU is required (no CPU fallback); prints the card's
                 name and power limit;
  2. pipeline  — NormFeat → TrainWorld → TrainTarget → ComputeTest →
                 TotalVariability → IvExtractor → IvNorm → IvTest
                 (cosine, PLDA); meanLLK must not decrease, every
                 artifact must be finite, every EER must be < 25 %;
  3. kernels   — the fused statistics kernel, as compiled for the card,
                 against a float64 NumPy reference at real widths, for
                 each setting of the fastMath/fastStats precision flags,
                 with the precision of every product read from the traced
                 and compiled programs; PCG against Cholesky extraction;
  4. serving   — SimpleSpkDetSystem and one TCP exchange with the
                 trained UBM: mean target score > mean impostor score.

``--cards 4`` runs only the multi-card phase instead: numThread=4 EM
statistics and TV E-step, and the 2-D (data × model) sharded EM
statistics and TV E-step, each against one card.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--cards 4] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

K, D, R, PLDA_RANK = 2048, 39, 400, 150
# iteration counts are the only cut: the TV EM runs 1 of its 5
# iterations; the UBM keeps all 6 (at 2 the GMM raw EER of this corpus
# is 0.267 on an H100, above the broken-path bound)
CUTS = {"tv_it": 1}
EER_LIMIT = 0.25
# kernel vs float64 at f32 grade (occupancy, llk) and PCG vs Cholesky
OCC_TOL, LLK_TOL, PCG_TOL = 2e-3, 1e-5, 1e-4
# the fastMath/fastStats flags round one product to bf16 on purpose:
# (fast_math, fast_stats) -> (occupancy, first/second-order sums) bounds
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
FLAG_TOL = {(False, False): (OCC_TOL, 1e-4), (False, True): (OCC_TOL, 5e-3),
            (True, False): (0.1, 5e-2), (True, True): (0.1, 5e-2)}
X3 = "BF16_BF16_F32_X3"       # the kernel's f32-grade product
SHARD_TOL = 1e-4


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---- 1. device ---------------------------------------------------------------

def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX sees {devs[0].platform} "
            "devices only); this check runs on an NVIDIA card and has no "
            "CPU fallback")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards requested, "
                         f"JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    say(smi)
    say(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}")
    return devs


# ---- 2. pipeline through the CLI ----------------------------------------------

def _cli(tool: str, cfg: dict, capture: bool = False) -> str:
    from lia_ral.__main__ import main as cli_main

    argv = [tool]
    for key, val in cfg.items():
        argv += [f"--{key}", str(val)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with (contextlib.redirect_stdout(buf) if capture
          else contextlib.nullcontext()):
        rc = cli_main(argv)
    check(rc == 0, f"{tool} exited with {rc}")
    say(f"  {tool}: {time.perf_counter() - t0:.1f} s")
    return buf.getvalue()


def _finite(what: str, arr) -> None:
    arr = np.asarray(arr)
    check(arr.size > 0 and bool(np.all(np.isfinite(arr))),
          f"{what}: empty or non-finite")


def _split_scores(lines):
    tgt, imp = [], []
    for line in lines:
        spk = int(line.seg.split("_s")[1].split("_")[0])
        (tgt if line.model == f"model{spk}" else imp).append(line.score)
    return np.asarray(tgt), np.asarray(imp)


def pipeline_phase(work: str, scale: dict, seed: int) -> dict:
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from milestone_eer import gen_corpus

    from lia_ral.backend.eval import eer
    from lia_ral.gmm.model import GmmDiag
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import read_matrix_file
    from lia_ral.io.nist import read_nist_scores

    p = dict(scale)
    say("  cuts: " + ", ".join(f"{key} {p[key]} -> {val}"
                               for key, val in CUTS.items()))
    p.update(CUTS)
    t0 = time.perf_counter()
    names = gen_corpus(work, p, np.random.default_rng(seed))
    say(f"  corpus: {time.perf_counter() - t0:.1f} s")

    base = {
        "featureFilesPath": work + "/", "mixtureFilesPath": work + "/",
        "labelFilesPath": work + "/", "lstPath": work + "/",
        "matrixFilesPath": work + "/",
        "saveVectorFilesPath": work + "/", "loadVectorFilesPath": work + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".norm.prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "mixtureDistribCount": p["k"],
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": p["ubm_it"], "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
    }
    path = lambda name: os.path.join(work, name)   # noqa: E731
    res = {}

    all_files = (["bg"] + [n for _, n in names["dev"]]
                 + [n for _, n in names["enroll"]]
                 + [n for _, n in names["test"]]
                 + [n for _, n in names["imp_enroll"]] + names["imp_test"])
    with open(path("allfeat.lst"), "w") as f:
        f.write("\n".join(all_files) + "\n")
    _cli("NormFeat", {**base, "loadFeatureFileExtension": ".prm",
                      "saveFeatureFileFormat": "SPRO4",
                      "saveFeatureFileExtension": ".norm.prm",
                      "inputFeatureFilename": path("allfeat.lst"),
                      "mode": "norm"})

    log = _cli("TrainWorld", {**base, "inputFeatureFilename": "bg",
                              "outputWorldFilename": "wld",
                              "verbose": "true"}, capture=True)
    llk = [float(v) for v in re.findall(r"meanLLK=(-?[\d.]+(?:e-?\d+)?)",
                                        log)]
    say(f"  TrainWorld meanLLK per iteration: {llk}")
    check(len(llk) == p["ubm_it"], f"expected {p['ubm_it']} meanLLK lines")
    check(all(b >= a for a, b in zip(llk, llk[1:])),
          f"meanLLK decreased: {llk}")
    wld = GmmDiag.load(path("wld.gmm"))
    for leaf in (wld.weights, wld.means, wld.cov_inv):
        _finite("UBM", leaf)

    rows = ([[m, f] for m, f in names["enroll"]]
            + [[m, f] for m, f in names["imp_enroll"]])
    write_xlist(path("targets.ndx"), rows)
    _cli("TrainTarget", {**base, "targetIdList": path("targets.ndx"),
                         "inputWorldFilename": "wld", "MAPAlgo": "MAPOccDep",
                         "meanAdapt": "true", "MAPRegFactorMean": 14.0,
                         "nbTrainIt": 3})
    tgt_models = [m for m, _ in names["enroll"]]
    for m, _ in rows:
        _finite(f"client model {m}", GmmDiag.load(path(m + ".gmm")).means)

    test_segs = [nm for _, nm in names["test"]]
    write_xlist(path("ndx_main"), [[t] + tgt_models for t in test_segs])
    _cli("ComputeTest", {**base, "ndxFilename": path("ndx_main"),
                         "inputWorldFilename": "wld",
                         "outputFilename": path("scores_main.nist"),
                         "gender": "M", "topDistribsCount": 10})
    lines = read_nist_scores(path("scores_main.nist"))
    check(len(lines) == len(test_segs) * len(tgt_models),
          "ComputeTest: missing trials")
    tgt, imp = _split_scores(lines)
    _finite("GMM scores", np.concatenate([tgt, imp]))
    res["gmm_raw_eer"] = eer(tgt, imp)

    dev_sessions = [nm for _, nm in names["dev"]]
    write_xlist(path("tv.ndx"), [[n] for n in dev_sessions])
    _cli("TotalVariability", {**base, "ndxFilename": path("tv.ndx"),
                              "inputWorldFilename": "wld",
                              "totalVariabilityNumber": p["r"],
                              "totalVariabilityMatrix": "TV",
                              "meanEstimate": "TVmean",
                              "nbIt": p["tv_it"], "initScale": 0.5})
    _finite("T matrix", read_matrix_file(path("TV.matx")))
    _finite("TV mean", read_matrix_file(path("TVmean.matx")))

    everything = dev_sessions + [f for _, f in names["enroll"]] + test_segs
    write_xlist(path("all.ndx"), [[n] for n in everything])
    _cli("IvExtractor", {**base, "ndxFilename": path("all.ndx"),
                         "inputWorldFilename": "wld",
                         "totalVariabilityMatrix": "TV",
                         "meanEstimate": "TVmean",
                         "ivExtractionMode": "exact", "ivSolver": "pcg"})
    _finite("i-vectors", np.stack(
        [read_matrix_file(path(n + ".y")).ravel() for n in everything]))

    write_xlist(path("dev.ndx"), [[spk, nm] for spk, nm in names["dev"]])
    _cli("IvNorm", {**base, "backgroundNdxFilename": path("dev.ndx"),
                    "ivNormIterationNb": 2})
    for it in range(2):
        _finite("IvNorm EFR matrix", read_matrix_file(
            path(f"EFR_ivNormEfrMatrix_it{it}.matx")))

    write_xlist(path("iv_targets.ndx"), [[m, f] for m, f in names["enroll"]])
    write_xlist(path("iv_trials.ndx"), [[t] + tgt_models for t in test_segs])
    for mode, extra in (("cosine", {}),
                        ("plda", {"pldaEigenVoiceNumber": p["plda"],
                                  "pldaNbIt": 5, "randomSeed": seed})):
        out = path(f"scores_iv_{mode}.nist")
        _cli("IvTest", {**base, "targetIdList": path("iv_targets.ndx"),
                        "ndxFilename": path("iv_trials.ndx"),
                        "backgroundNdxFilename": path("dev.ndx"),
                        "scoreMode": mode, "outputFilename": out,
                        "ivNorm": "true", "ivNormIterationNb": 2, **extra})
        tgt, imp = _split_scores(read_nist_scores(out))
        _finite(f"i-vector {mode} scores", np.concatenate([tgt, imp]))
        res[f"iv_{mode}_eer"] = eer(tgt, imp)

    say("  EER: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
    for key, val in res.items():
        check(val < EER_LIMIT, f"{key} {val:.4f} is not below {EER_LIMIT}")
    return {"names": names, "wld": path("wld.gmm"), "work": work}


# ---- 3. kernels against the float64 reference ---------------------------------

def random_gmm(rng, k: int, d: int):
    from lia_ral.gmm.model import GmmDiag

    wk = rng.random(k) + 0.5
    return GmmDiag.create(wk / wk.sum(), rng.standard_normal((k, d)),
                          rng.random((k, d)) + 0.5)


def reference_stats(x, w, gmm):
    """float64 NumPy statistics of frames x (..., T, D), weights (..., T):
    (n, sum_x, sum_xx, llk) per leading index."""
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    m = np.asarray(gmm.means, np.float64)
    iv = np.asarray(gmm.cov_inv, np.float64)
    cst = (-0.5 * (m.shape[1] * np.log(2 * np.pi) - np.log(iv).sum(-1))
           + np.log(np.asarray(gmm.weights, np.float64))
           - 0.5 * np.sum(m * m * iv, -1))
    ld = (x * x) @ (-0.5 * iv.T) + x @ (m * iv).T + cst
    top = ld.max(-1, keepdims=True)
    lse = top[..., 0] + np.log(np.exp(ld - top).sum(-1))
    p = np.exp(ld - lse[..., None]) * w[..., None]
    pt = np.swapaxes(p, -1, -2)
    return p.sum(-2), pt @ x, pt @ (x * x), (lse * w).sum(-1)


def _occ_err(n, ref):
    """Max relative occupancy error; a thousandth of a frame floors the
    denominator of components that hold (almost) nothing."""
    return float(np.max(np.abs(np.asarray(n, np.float64) - ref)
                        / (ref + 1e-3)))


def _rel(a, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - ref))
                 / max(np.max(np.abs(ref)), 1e-30))


def _label(fast_math: bool, fast_stats: bool) -> str:
    return "+".join([n for n, on in (("fastMath", fast_math),
                                     ("fastStats", fast_stats)) if on]
                    ) or "f32"


def kernel_dot_precisions(fn, *args) -> list[str]:
    """How each product inside the fused kernel's pallas_calls is asked
    to run, in program order, read from the traced program: the
    DotAlgorithmPreset's name, or "BF16" for one pass over bf16
    operands."""
    import jax

    found = []

    def walk(jaxpr, in_kernel):
        for eqn in jaxpr.eqns:
            if in_kernel and eqn.primitive.name == "dot_general":
                prec = eqn.params["precision"]
                dtypes = sorted({str(v.aval.dtype) for v in eqn.invars})
                found.append(
                    prec.name if isinstance(prec, jax.lax.DotAlgorithmPreset)
                    else "BF16" if dtypes == ["bfloat16"]
                    else f"{prec} on {dtypes}")
            inside = in_kernel or eqn.primitive.name == "pallas_call"
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (tuple, list)) else [val]):
                    if hasattr(sub, "eqns"):
                        walk(sub, inside)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr, inside)

    walk(jax.make_jaxpr(fn)(*args).jaxpr, False)
    return found


_REQ = re.compile(r"stablehlo\.dot_general[^\n]*?(?:precision = \[([A-Z, ]+)\]"
                  r"|algorithm = <([^>]*)>|(:))")
_HLO = re.compile(r"operand_precision=\{([a-z,]+)\}"
                  r'|"operand_precision":\[([^\]]*)\]'
                  r"|algorithm=([a-z0-9_]+)"
                  r'|"algorithm":"([A-Z0-9_]+)"')


def xla_dot_precisions(lowered_text: str, compiled_text: str
                       ) -> tuple[list[str], list[str]]:
    """(requested, compiled) precision of every XLA product: the
    precision or algorithm each ``dot_general`` of the lowered program
    asks for ("DEFAULT" where it names none), and the distinct operand
    precisions and algorithms that the compiled program's dots and GEMM
    calls carry."""
    req = [(p or a or "DEFAULT").replace(" ", "")
           for p, a, _ in _REQ.findall(lowered_text)]
    got = sorted({"".join(m).replace('"', "").replace(" ", "").lower()
                  for m in _HLO.findall(compiled_text)})
    return req, got


def f32_grade(requested: list[str], compiled: list[str]) -> bool:
    """True if every product asks for HIGHEST and none of the compiled
    ones runs in TF32 or in one bf16 pass."""
    one_pass = re.compile(r"tf32|(^|_)bf16_bf16_f32$|^(high|default)(,|$)")
    return (bool(requested)
            and all(r == "HIGHEST,HIGHEST" for r in requested)
            and not any(one_pass.search(c.replace("alg_dot_", ""))
                        for c in compiled))


def kernel_phase(seed: int, n_frames: int = 65536, n_utts: int = 32,
                 t_utt: int = 2000) -> None:
    import jax
    import jax.numpy as jnp

    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import TvModel, estimate_w
    from lia_ral.gmm import stats_path
    from lia_ral.gmm.kernels import em_stats_chunked

    check(stats_path.use_kernel(), "the statistics path did not choose "
          "the fused kernel on this device")
    rng = np.random.default_rng(seed)
    gmm = random_gmm(rng, K, D)
    x = rng.standard_normal((n_frames, D)).astype(np.float32)
    w = (rng.random(n_frames) > 0.1).astype(np.float32)
    rn, rf, rs, rl = reference_stats(x, w, gmm)
    em = jax.jit(stats_path.em_stats,
                 static_argnames=("fast_math", "fast_stats", "chunk"))
    for fast_math, fast_stats in FLAGS:
        flags = dict(fast_math=fast_math, fast_stats=fast_stats)
        dots = kernel_dot_precisions(
            lambda a, b, g: stats_path.em_stats(a, b, g, **flags),
            x[:256], w[:256], gmm)
        dens, stat = ("BF16" if fast_math else X3), ("BF16" if fast_stats
                                                      else X3)
        st = em(jnp.asarray(x), jnp.asarray(w), gmm, **flags)
        occ, f_err = _occ_err(st.n, rn), _rel(st.sum_x, rf)
        s_err = _rel(st.sum_xx, rs)
        llk = abs(float(st.llk) - rl) / abs(rl)
        say(f"  EM stats K={K} D={D} N={n_frames} {_label(**flags)}: "
            f"occupancy {occ:.3e}, sum_x {f_err:.3e}, sum_xx {s_err:.3e}, "
            f"llk {llk:.3e}; kernel products (density, density, stats) "
            f"{dots}")
        check(dots == [dens, dens, stat],
              f"kernel products {dots}, expected {[dens, dens, stat]}")
        occ_tol, f_tol = FLAG_TOL[fast_math, fast_stats]
        check(occ <= occ_tol and max(f_err, s_err) <= f_tol,
              f"EM stats {_label(**flags)} out of bounds")
        check(fast_math or llk <= LLK_TOL,
              f"EM llk {_label(**flags)} out of bounds")

    xu = rng.standard_normal((n_utts, t_utt, D)).astype(np.float32)
    lens = rng.integers(t_utt // 4, t_utt + 1, n_utts)
    mu = ((np.arange(t_utt)[None, :] < lens[:, None])
          & (rng.random((n_utts, t_utt)) > 0.2)).astype(np.float32)
    rn, rf, _, _ = reference_stats(xu, mu, gmm)
    bw = jax.jit(stats_path.bw_stats, static_argnames=("fast_stats",))
    for fast_stats in (False, True):
        n, f = bw(jnp.asarray(xu), jnp.asarray(mu), gmm,
                  fast_stats=fast_stats)
        occ, f_err = _occ_err(n, rn), _rel(f, rf)
        say(f"  BW stats {n_utts}x{t_utt} ragged "
            f"{_label(False, fast_stats)}: occupancy {occ:.3e}, "
            f"F {f_err:.3e}")
        occ_tol, f_tol = FLAG_TOL[False, fast_stats]
        check(occ <= occ_tol and f_err <= f_tol,
              f"BW stats {_label(False, fast_stats)} out of bounds")
        if not fast_stats:
            stats = BwStats(n=n, f=f)

    t_mat = jnp.asarray(rng.standard_normal((R, K, D)) * 0.01, jnp.float32)
    model = TvModel.from_ubm(t_mat, gmm)
    w_pcg = np.asarray(estimate_w(stats, model, solver="pcg"))
    w_chol = np.asarray(estimate_w(stats, model, solver="cholesky"))
    pcg = _rel(w_pcg, w_chol)
    say(f"  i-vector extraction R={R}: PCG vs Cholesky {pcg:.3e}")
    check(pcg <= PCG_TOL, "PCG extraction out of bounds")

    # XLA's own products at f32 grade: the plain statistics path (density
    # and stat products) and the exact extraction (L-build and PCG)
    for what, fn, args in (
            ("XLA density+stats", lambda a, b, g: em_stats_chunked(
                a, b, g, chunk=4096), (x[:8192], w[:8192], gmm)),
            ("XLA L-build+PCG", lambda st, m: estimate_w(st, m,
                                                         solver="pcg"),
             (BwStats(n=stats.n[:4], f=stats.f[:4]), model))):
        lowered = jax.jit(fn).lower(*args)
        req, got = xla_dot_precisions(lowered.as_text(),
                                      lowered.compile().as_text())
        say(f"  {what}: {len(req)} products ask for {sorted(set(req))}; "
            f"compiled: {got or 'no precision markers'}")
        check(f32_grade(req, got), f"{what} is not f32-grade")


# ---- 4. serving -------------------------------------------------------------

def serving_phase(ctx: dict) -> None:
    from lia_ral.api import RemoteSpkDetClient, SimpleSpkDetSystem
    from lia_ral.api import SpkDetServer
    from lia_ral.config import Config
    from lia_ral.io.features import read_feature_file

    work, names = ctx["work"], ctx["names"]

    def feats(name):
        return read_feature_file(os.path.join(work, name + ".norm.prm"),
                                 fmt="SPRO4").data

    speakers = [0, 1]
    sysm = SimpleSpkDetSystem()
    sysm.load_background_model(ctx["wld"])
    enroll = dict(names["enroll"])
    for s in speakers:
        sysm.reset_features()
        sysm.add_features(feats(enroll[f"model{s}"]))
        sysm.create_speaker_model(f"model{s}")
    tests = {s: [nm for spk, nm in names["test"] if spk == s][:2]
             for s in speakers}
    tgt, imp = [], []
    for s in speakers:
        for nm in tests[s]:
            sysm.reset_features()
            sysm.add_features(feats(nm))
            for claim in speakers:
                _, score = sysm.verify_speaker(f"model{claim}")
                (tgt if claim == s else imp).append(score)
    _, _, who = sysm.identify_speaker()
    _finite("verification scores", tgt + imp)
    say(f"  SimpleSpkDetSystem: {len(tgt) + len(imp)} verify requests, "
        f"mean target {np.mean(tgt):.4f} > mean impostor "
        f"{np.mean(imp):.4f}; identify -> {who}")
    check(np.mean(tgt) > np.mean(imp), "target scores do not exceed "
          "impostor scores")

    srv = SpkDetServer(Config(), port=0)
    port = srv.start()
    try:
        cli = RemoteSpkDetClient(port=port)
        cli.load_world(ctx["wld"])
        cli.send_features(feats(enroll["model0"]))
        cli.train_speaker("model0")
        cli.reset_features()
        cli.send_features(feats(tests[0][0]))
        ok, score = cli.verify("model0")
        cli.close()
    finally:
        srv.stop()
    _finite("TCP verify score", [score])
    say(f"  TCP exchange: verify model0 -> decision {ok}, score "
        f"{score:.4f}")


# ---- --cards 4 ----------------------------------------------------------------

def cards_phase(n_cards: int, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from lia_ral.config import Config
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import init_t, tv_e_step
    from lia_ral.gmm import stats_path
    from lia_ral.parallel import make_mesh, sharded_em_stats_2d
    from lia_ral.parallel.sharding import (sharded_tv_e_step,
                                           sharded_tv_e_step_2d)
    from lia_ral.tools.common import resolve_mesh, resolve_stats_fn

    rng = np.random.default_rng(seed)
    gmm = random_gmm(rng, K, D)
    x = jnp.asarray(rng.standard_normal((262144, D)), jnp.float32)
    w = jnp.asarray(rng.random(262144) > 0.1, jnp.float32)
    one = jax.jit(stats_path.em_stats)(x, w, gmm)

    def compare(what, got, want):
        errs = [_rel(a, b) for a, b in zip(jax.tree.leaves(got),
                                           jax.tree.leaves(want))]
        say(f"  {what}: max relative deviation {max(errs):.3e}")
        check(max(errs) <= SHARD_TOL, f"{what} deviates from one card")

    cfg = Config({"numThread": str(n_cards)})
    mesh = resolve_mesh(cfg)
    check(mesh is not None and mesh.devices.size == n_cards,
          "numThread did not give a mesh over every card")
    compare(f"EM stats numThread={n_cards}", resolve_stats_fn(cfg)(x, w, gmm),
            one)

    n_utt = 64
    xu = jnp.asarray(rng.standard_normal((n_utt, 1024, D)), jnp.float32)
    n, f = stats_path.bw_stats(xu, jnp.ones((n_utt, 1024), jnp.float32), gmm)
    stats = BwStats(n=n, f=f)
    model = init_t(jax.random.key(seed), R, gmm, scale=0.01)
    w_one, acc_one = tv_e_step(stats, model, chunk=16)
    w_sh, acc_sh = sharded_tv_e_step(mesh, stats, model, chunk=16)
    compare(f"TV E-step numThread={n_cards}", (w_sh, acc_sh),
            (w_one, acc_one))

    mesh2 = make_mesh(n_data=2, n_model=n_cards // 2)
    st2 = sharded_em_stats_2d(mesh2, x, w, gmm)
    compare("EM stats 2-D mesh 2x2", st2, one)
    w2, acc2 = sharded_tv_e_step_2d(mesh2, stats, model, chunk=16)
    compare("TV E-step 2-D mesh 2x2", (w2, acc2), (w_one, acc_one))

    held = {s.device for s in st2.sum_x.addressable_shards}
    distinct = {tuple(np.asarray(s.data).ravel()[:4])
                for s in st2.sum_x.addressable_shards}
    say(f"  2-D EM sum_x shards on {len(held)} devices, "
        f"{len(distinct)} distinct component blocks")
    check(len(held) == n_cards, "the 2-D statistics are not on every card")
    check(len(distinct) == n_cards // 2,
          "the model axis does not split the components")
    in_use = [(d.memory_stats() or {}).get("bytes_in_use")
              for d in jax.devices()[:n_cards]]
    say(f"  device memory in use (bytes): {in_use}")
    check(all(b is None or b > 0 for b in in_use), "a card holds no arrays")


# ---- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devs = device_phase(args.cards)
    sys.path.insert(0, HERE)
    import jax

    import lia_ral  # noqa: F401  (package numerics and cache settings)
    say("default matmul precision: "
        f"{jax.config.jax_default_matmul_precision}")

    def phase(name, fn, *a):
        say(f"phase {name}")
        t0 = time.perf_counter()
        out = fn(*a)
        say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return out

    if args.cards > 1:
        phase(f"{args.cards} cards", cards_phase, args.cards, args.seed)
    else:
        sys.path.insert(0, os.path.join(HERE, "scripts"))
        from milestone_eer import SCALES

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            ctx = phase("pipeline", pipeline_phase, work, SCALES["full"],
                        args.seed)
            phase("kernels", kernel_phase, args.seed)
            phase("serving", serving_phase, ctx)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
