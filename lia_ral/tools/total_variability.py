"""TotalVariability: T-matrix EM trainer CLI.

Equivalent of reference ``LIA_SpkDet/TotalVariability``
(TotalVariability.cpp:71-248): accumulate (or load) Baum-Welch stats →
random T init → EM loop with optional minimum divergence → save T (and the
ubmWeight / eigenDecomposition approximation matrices on request).
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..fa.stats import BwStats, bw_stats_batch, load_stats, save_stats
from ..fa.tv import (TvModel, approximate_tctc, eigen_decompose_w,
                     estimate_w, get_speaker_model, init_t,
                     tv_em_iteration, weighted_cov)
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.matrix import write_matrix_file
from .common import load_features_and_mask, mixture_path, setup_verbose


def matrix_out_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("matrixFilesPath", "./")
    ext = cfg.get_str("saveMatrixFilesExtension", ".matx")
    return os.path.join(root, name + ext)


def accumulate_stats_from_ndx(cfg: Config, gmm: GmmDiag,
                              verbose: bool = False
                              ) -> tuple[BwStats, list[str]]:
    """Per NDX line (session id + feature files): one stats row.

    The reference uses TVTranslate to map files↔sessions
    (AccumulateTVStat.h:78-191); here each NDX line is one session.
    """
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    # Sessions are length-bucketed (pad to a multiple of statsBucketFrames)
    # and dispatched as (batch, T, D) bw_stats_batch calls: one compiled
    # executable per bucket shape and one device round-trip per batch,
    # instead of one per session — the device shape of the reference's
    # per-thread static file-list split (AccumulateTVStat.cpp:478-551).
    bucket = max(cfg.get_int("statsBucketFrames", 2048), 1)
    batch_size = max(cfg.get_int("statsBatchSize", 64), 1)
    # all feature files of the NDX read in parallel by the native batched
    # loader (liaio_read_batch thread pool), then grouped per session
    from .common import file_frame_mask, load_files_batch
    flat: list[str] = []
    spans: list[tuple[str, int, int]] = []
    for session, files in ndx:
        if not files:
            files = [session]
        spans.append((session, len(flat), len(flat) + len(files)))
        flat.extend(files)
    mats = load_files_batch(flat, cfg)
    entries: list[tuple[str, np.ndarray, np.ndarray]] = []
    for session, a, b in spans:
        xs = mats[a:b]
        if any(x is None for x in xs):
            # reference recovery model: warn, skip the session, rerun the
            # failed shard later (TrainTarget.cpp:141-150 pattern)
            print(f"WARNING: cannot read session [{session}]"
                  " — session skipped")
            continue
        try:
            masks = [file_frame_mask(nm, x.shape[0], cfg)
                     for nm, x in zip(flat[a:b], xs)]
        except Exception as e:   # malformed .lbl → warn-skip, rerun shard
            print(f"WARNING: bad label file for session [{session}]: {e}"
                  " — session skipped")
            continue
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        mask = masks[0] if len(masks) == 1 else np.concatenate(masks)
        entries.append((session, x, mask))
        if verbose:
            print(f"stats [{session}]: {int(mask.sum())} frames")
    from ..fa.stats import bw_stats_bucketed
    stats = bw_stats_bucketed(
        [(x, m) for _, x, m in entries], gmm, bucket=bucket,
        batch_size=batch_size,
        fast_stats=cfg.get_bool("fastStats", False))
    names = [name for name, _, _ in entries]
    return stats, names


def verify_llk(cfg: Config, names: list[str], stats: BwStats,
               model: TvModel, gmm: GmmDiag) -> float:
    """EM-likelihood check (reference TVAcc::verifyEMLK,
    AccumulateTVStat.cpp:1655-1688, key ``computeLLK``): total mean frame
    LLK of the first N sessions under their synthesised speaker models."""
    from ..gmm.kernels import frame_llk
    max_utts = cfg.get_int("computeLLK", 1)
    w_all = estimate_w(stats, model)
    total = 0.0
    for i in range(min(max_utts, len(names))):
        fs, mask = load_features_and_mask([names[i]], cfg)
        spk = get_speaker_model(model, w_all[i], gmm)
        llk = frame_llk(jnp.asarray(fs.data), spk)
        m = jnp.asarray(mask)
        total += float(jnp.sum(llk * m) / jnp.maximum(jnp.sum(m), 1.0))
    return total


def main(cfg: Config) -> TvModel:
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    rank = cfg.get_int("totalVariabilityNumber")
    nb_it = cfg.get_int("nbIt", 10)
    min_div = cfg.get_bool("minDivergence", True)
    if cfg.get_bool("loadAccs", False):
        stats, names = load_stats(cfg.get_str("accsFilename"))
    else:
        stats, names = accumulate_stats_from_ndx(cfg, gmm, verbose)
        if cfg.exists("accsFilename"):
            save_stats(cfg.get_str("accsFilename"), stats, names)
    key = jax.random.key(cfg.get_int("randomSeed", 0))
    model = init_t(key, rank, gmm,
                   scale=cfg.get_float("initScale", 0.001))
    if cfg.get_bool("saveInitMatrix", False):
        model.save(matrix_out_path(
            cfg.get_str("totalVariabilityMatrix") + "_init", cfg))
    # numThread > 1 → shard the session axis of the E-step over the mesh
    # (reference threaded estimateAandC, AccumulateTVStat.cpp:1694)
    from .common import resolve_mesh
    mesh = resolve_mesh(cfg)
    for it in range(nb_it):
        if mesh is not None:
            from ..fa.tv import min_divergence, tv_m_step
            from ..parallel.sharding import sharded_tv_e_step
            w, acc = sharded_tv_e_step(
                mesh, stats, model, chunk=cfg.get_int("speakerChunk", 64))
            model = tv_m_step(model, acc)
            if min_div:
                model = min_divergence(model, acc)
        else:
            model, w = tv_em_iteration(stats, model,
                                       chunk=cfg.get_int("speakerChunk", 64),
                                       min_div=min_div)
        if verbose:
            print(f"TV EM it {it}: |T|={float(jnp.abs(model.t).mean()):.5f}")
        if cfg.exists("computeLLK") and not cfg.get_bool("loadAccs", False):
            total = verify_llk(cfg, names, stats, model, gmm)
            print(f"*** (Verify LLK) it {it} Total LLK={total:.5f} ***")
    model.save(matrix_out_path(cfg.get_str("totalVariabilityMatrix"), cfg))
    if min_div:
        write_matrix_file(matrix_out_path(
            cfg.get_str("meanEstimate", "meanEstimate"), cfg),
            np.asarray(model.ubm_means, np.float64).reshape(1, -1))
    if cfg.exists("approximationMode"):
        mode = cfg.get_str("approximationMode")
        w_mat = weighted_cov(model, gmm.weights)
        base = cfg.get_str("totalVariabilityMatrix")
        if mode == "ubmWeight":
            write_matrix_file(matrix_out_path(base + "_weightedCov", cfg),
                              np.asarray(w_mat, np.float64))
        elif mode == "eigenDecomposition":
            q = eigen_decompose_w(w_mat)
            d_mat = approximate_tctc(model, q)
            write_matrix_file(matrix_out_path(base + "_EigDec_D", cfg),
                              np.asarray(d_mat, np.float64))
            write_matrix_file(matrix_out_path(base + "_EigDec_Q", cfg),
                              np.asarray(q, np.float64))
        else:
            print(f"approximationMode [{mode}] unknown")
    return model


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
