"""JFA CLI tools: ComputeJFAStats, EigenVoice, EigenChannel,
EstimateDMatrix.

Equivalents of the reference binaries (SURVEY.md §2.2):
* ComputeJFAStats (ComputeJFAStats.cpp:71-105) — precompute & save N/F
  sufficient stats;
* EigenVoice (EigenVoice.cpp:71-163) — V-matrix EM;
* EigenChannel (EigenChannel.cpp:70-200) — U-matrix EM;
* EstimateDMatrix (EstimateDMatrix.cpp:105-212) — diagonal D estimation.

NDX convention: each line "speakerId file1 [file2 ...]"; every file is one
session of that speaker (reference JFATranslate bookkeeping).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..fa.jfa import (JfaModel, JfaStats, estimate_x, estimate_y,
                      jfa_d_iteration, jfa_u_iteration, jfa_v_iteration)
from ..fa.stats import BwStats, load_stats, save_stats
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import load_features_and_mask, mixture_path, setup_verbose
from .total_variability import matrix_out_path


def accumulate_session_stats(cfg: Config, gmm: GmmDiag, verbose=False
                             ) -> tuple[JfaStats, list[str], list[str]]:
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    # one session per file; all files read in parallel by the native
    # batched loader, label masks built per file afterwards
    from .common import file_frame_mask, load_files_batch
    spk_names, flat, flat_spk = [], [], []
    for spk, files in ndx:
        if spk not in spk_names:
            spk_names.append(spk)
        sid = spk_names.index(spk)
        for f in (files if files else [spk]):
            flat.append(f)
            flat_spk.append(sid)
    mats = load_files_batch(flat, cfg)
    sess_names, sess_spk, entries = [], [], []
    for f, sid, x in zip(flat, flat_spk, mats):
        if x is None:
            print(f"WARNING: cannot read session [{f}] — session skipped")
            continue
        try:
            mask = file_frame_mask(f, x.shape[0], cfg)
        except Exception as e:   # malformed .lbl → warn-skip, rerun shard
            print(f"WARNING: bad label file for session [{f}]: {e}"
                  " — session skipped")
            continue
        entries.append((x, mask))
        sess_names.append(f)
        sess_spk.append(sid)
        if verbose:
            print(f"stats [{spk_names[sid]}/{f}]: {int(mask.sum())} frames")
    from ..fa.stats import bw_stats_bucketed
    sess = bw_stats_bucketed(
        entries, gmm, bucket=cfg.get_int("statsBucketFrames", 2048),
        batch_size=cfg.get_int("statsBatchSize", 64),
        fast_stats=cfg.get_bool("fastStats", False))
    stats = JfaStats.from_sessions(sess, np.asarray(sess_spk),
                                   len(spk_names))
    return stats, spk_names, sess_names


def load_or_accumulate(cfg: Config, gmm: GmmDiag, verbose=False) -> JfaStats:
    if cfg.get_bool("loadAccs", False):
        sess, names = load_stats(cfg.get_str("accsFilename"))
        sess_spk = np.load(cfg.get_str("accsFilename") + ".spk.npy")
        return JfaStats.from_sessions(sess, sess_spk,
                                      int(sess_spk.max()) + 1)
    stats, spk_names, sess_names = accumulate_session_stats(cfg, gmm, verbose)
    if cfg.exists("accsFilename"):
        save_stats(cfg.get_str("accsFilename"), stats.sess, sess_names)
        np.save(cfg.get_str("accsFilename") + ".spk.npy",
                np.asarray(stats.sess_spk))
    return stats


def _load_subspace(cfg: Config, key: str, gmm: GmmDiag) -> jnp.ndarray:
    mat = read_matrix_file(matrix_out_path(cfg.get_str(key), cfg))
    k, d = gmm.means.shape
    return jnp.asarray(mat.reshape(mat.shape[0], k, d), jnp.float32)


def compute_jfa_stats_main(cfg: Config) -> JfaStats:
    """ComputeJFAStats: accumulate and checkpoint N/F."""
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    stats, _, sess_names = accumulate_session_stats(cfg, gmm, verbose)
    save_stats(cfg.get_str("accsFilename"), stats.sess, sess_names)
    np.save(cfg.get_str("accsFilename") + ".spk.npy",
            np.asarray(stats.sess_spk))
    return stats


def eigen_voice_main(cfg: Config) -> JfaModel:
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    stats = load_or_accumulate(cfg, gmm, verbose)
    rank_v = cfg.get_int("eigenVoiceNumber")
    rank_u = cfg.get_int("eigenChannelNumber", 1)
    model = JfaModel.init(jax.random.key(cfg.get_int("randomSeed", 0)),
                          rank_v, rank_u, gmm,
                          scale=cfg.get_float("initScale", 0.001))
    s, k = stats.spk.n.shape
    d = gmm.means.shape[1]
    x = jnp.zeros((stats.sess.n.shape[0], rank_u), jnp.float32)
    z = jnp.zeros((s, k, d), jnp.float32)
    # the reference snapshots accumulators before each substep's in-place
    # mutations (storeAccs/restoreAccs, EigenVoice.cpp:117/150); with
    # immutable stats the pairing is an explicit no-op kept for flow parity
    from ..fa.jfa import orthonormalize_v, restore_accs, store_accs
    from .common import resolve_mesh
    snapshot = store_accs(stats)
    ortho = cfg.get_bool("orthonormalizeV", False)   # EigenVoice.cpp:143
    mesh = resolve_mesh(cfg)    # numThread → speaker-sharded V substep
    for it in range(cfg.get_int("nbIt", 10)):
        if mesh is not None:
            from ..parallel.sharding import sharded_jfa_v_iteration
            model, y = sharded_jfa_v_iteration(mesh, stats, model, x, z)
        else:
            model, y = jfa_v_iteration(stats, model, x, z)
        if ortho:
            model = orthonormalize_v(model)
        stats = restore_accs(snapshot)
        if verbose:
            print(f"EigenVoice it {it}: |V|="
                  f"{float(jnp.abs(model.v).mean()):.6f}")
    write_matrix_file(matrix_out_path(
        cfg.get_str("eigenVoiceMatrix", "EV"), cfg),
        np.asarray(model.v.reshape(rank_v, -1), np.float64))
    return model


def eigen_channel_main(cfg: Config) -> JfaModel:
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    stats = load_or_accumulate(cfg, gmm, verbose)
    rank_u = cfg.get_int("eigenChannelNumber")
    s, k = stats.spk.n.shape
    d = gmm.means.shape[1]
    model = JfaModel.init(jax.random.key(cfg.get_int("randomSeed", 0)),
                          1, rank_u, gmm,
                          scale=cfg.get_float("initScale", 0.001))
    if cfg.exists("eigenVoiceMatrix"):
        v = _load_subspace(cfg, "eigenVoiceMatrix", gmm)
        model = model.replace(v=v)
    z = jnp.zeros((s, k, d), jnp.float32)
    x = jnp.zeros((stats.sess.n.shape[0], rank_u), jnp.float32)
    # reference EigenChannel: estimate Y once with V fixed, then iterate U
    from .common import resolve_mesh
    mesh = resolve_mesh(cfg)    # numThread → session-sharded U substep
    for it in range(cfg.get_int("nbIt", 10)):
        y, _ = estimate_y(stats, model, x, z)
        if mesh is not None:
            from ..parallel.sharding import sharded_jfa_u_iteration
            model, x = sharded_jfa_u_iteration(mesh, stats, model, y, z)
        else:
            model, x = jfa_u_iteration(stats, model, y, z)
        if verbose:
            print(f"EigenChannel it {it}: |U|="
                  f"{float(jnp.abs(model.u).mean()):.6f}")
    write_matrix_file(matrix_out_path(
        cfg.get_str("eigenChannelMatrix", "EC"), cfg),
        np.asarray(model.u.reshape(rank_u, -1), np.float64))
    return model


def estimate_d_matrix_main(cfg: Config) -> JfaModel:
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    stats = load_or_accumulate(cfg, gmm, verbose)
    model = JfaModel.init(jax.random.key(cfg.get_int("randomSeed", 0)),
                          1, 1, gmm)
    if cfg.exists("eigenVoiceMatrix"):
        model = model.replace(v=_load_subspace(cfg, "eigenVoiceMatrix", gmm))
    if cfg.exists("eigenChannelMatrix"):
        model = model.replace(u=_load_subspace(cfg, "eigenChannelMatrix", gmm))
    tau = cfg.get_float("regulationFactor", 10.0)
    s, k = stats.spk.n.shape
    d = gmm.means.shape[1]
    x = jnp.zeros((stats.sess.n.shape[0], model.rank_u), jnp.float32)
    z = jnp.zeros((s, k, d), jnp.float32)
    for it in range(cfg.get_int("nbIt", 5)):
        y, _ = estimate_y(stats, model, x, z)
        x, _ = estimate_x(stats, model, y, z)
        model, z = jfa_d_iteration(stats, model, y, x, tau)
        if verbose:
            print(f"EstimateD it {it}: |D|="
                  f"{float(jnp.abs(model.d).mean()):.6f}")
    write_matrix_file(matrix_out_path(cfg.get_str("DMatrix", "D"), cfg),
                      np.asarray(model.d.reshape(1, -1), np.float64))
    return model


def main(cfg: Config):
    mode = cfg.get_str("jfaMode", "stats")
    return {"stats": compute_jfa_stats_main,
            "eigenVoice": eigen_voice_main,
            "eigenChannel": eigen_channel_main,
            "estimateD": estimate_d_matrix_main}[mode](cfg)


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
