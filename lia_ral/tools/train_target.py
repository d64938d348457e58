"""TrainTarget: MAP/MLLR target model training CLI.

Equivalent of reference ``LIA_SpkDet/TrainTarget`` (TrainTarget.cpp:73-237):
per line of ``targetIdList`` (client id followed by its training files),
MAP-adapt the world model on the client's frames and save the client model.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp

from ..config import Config
from ..gmm.map_adapt import MapCfg, adapt_model
from ..gmm.model import GmmDiag
from .common import load_features_and_mask, mixture_path, setup_verbose
from ..io.lists import read_ndx


def _load_fa_model(cfg: Config, world: GmmDiag):
    """Channel model for the TrainTargetFA variant."""
    import os
    from ..fa.lfa import lfa_model
    from ..io.matrix import read_matrix_file
    u = read_matrix_file(os.path.join(
        cfg.get_str("matrixFilesPath", "./"),
        cfg.get_str("eigenChannelMatrix")
        + cfg.get_str("loadMatrixFilesExtension", ".matx")))
    k, d = world.means.shape
    return lfa_model(u.reshape(u.shape[0], k, d), world,
                     tau=cfg.get_float("regulationFactor", 16.0))


def train_target_jfa(cfg: Config) -> dict[str, GmmDiag]:
    """TrainTargetJFA (TrainTarget.cpp:393-560, channelCompensation JFA):
    joint per-speaker (y, x) over the stacked [V; U] subspace, residual z
    with unit prior (estimateZ, AccumulateJFAStat.cpp:3450), client model
    = m + V·y + D·z (channel factor dropped), optional Σ⁻¹-scaled
    supervector and y/x/z side files.

    Device shape: ALL clients are enrolled in one batched joint estimate
    (the reference loops speakers through storeAccs/substract/restore,
    TrainTarget.cpp:521-541)."""
    import numpy as np
    from ..fa.jfa import JfaModel, enroll_targets_joint
    from ..io.matrix import read_matrix_file, write_matrix_file
    from .jfa_tools import accumulate_session_stats
    verbose = setup_verbose(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    k, d = world.means.shape

    def sub(key: str, rows_default: int) -> jnp.ndarray:
        from .total_variability import matrix_out_path
        if not cfg.exists(key):
            return jnp.zeros((rows_default, k, d), jnp.float32)
        m = read_matrix_file(matrix_out_path(cfg.get_str(key), cfg))
        return jnp.asarray(m.reshape(m.shape[0], k, d), jnp.float32)

    model = JfaModel(
        v=sub("eigenVoiceMatrix", 1), u=sub("eigenChannelMatrix", 1),
        d=sub("DMatrix", 1)[0] if cfg.exists("DMatrix")
        else jnp.zeros((k, d), jnp.float32),
        ubm_means=jnp.asarray(world.means, jnp.float32),
        ubm_inv_var=jnp.asarray(world.cov_inv, jnp.float32))

    cfg2 = cfg.copy()
    cfg2["ndxFilename"] = cfg.get_str("targetIdList")
    stats, spk_names, _ = accumulate_session_stats(cfg2, world, verbose)
    y, x_spk, z = enroll_targets_joint(stats, model, tau=1.0)
    vy_dz = (jnp.einsum("sr,rkd->skd", y, model.v)
             + model.d[None] * z)                             # (S,K,D)
    out: dict[str, GmmDiag] = {}
    sv_path = cfg.get_str("saveVectorFilesPath", "./")
    sv_ext = cfg.get_str("vectorFilesExtension", ".vect")
    for i, client in enumerate(spk_names):
        cm = GmmDiag(weights=world.weights,
                     means=world.means + vy_dz[i],
                     cov_inv=world.cov_inv)
        if cfg.get_bool("saveMixture", True):
            cm.save(mixture_path(client, cfg, save=True),
                    fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                    model_id=client)
        if cfg.get_bool("saveSuperVector", True) and cfg.exists(
                "saveVectorFilesPath"):
            # only the supervector is Σ⁻¹-scaled (TrainTarget.cpp:575)
            sv = np.asarray(vy_dz[i] * world.cov_inv, np.float64)
            write_matrix_file(os.path.join(sv_path, client + sv_ext),
                              sv.reshape(1, -1))
        for flag, arr, ext_key, dflt in (
                ("saveY", y[i], "yExtension", ".y"),
                ("saveX", x_spk[i], "xExtension", ".x"),
                ("saveZ", z[i].reshape(-1), "zExtension", ".z")):
            if cfg.get_bool(flag, False):
                write_matrix_file(
                    os.path.join(sv_path,
                                 client + cfg.get_str(ext_key, dflt)),
                    np.asarray(arr, np.float64)[None, :])
        out[client] = cm
        if verbose:
            print(f"JFA client [{client}] enrolled")
    return out


def main(cfg: Config) -> dict[str, GmmDiag]:
    verbose = setup_verbose(cfg)
    ndx_path = cfg.get_str("targetIdList")
    # channelCompensation dispatch (TrainTargetMain.cpp:163-169):
    # "JFA" → TrainTargetJFA, "LFA"/bool → feature-domain FA variant
    if cfg.get_str("channelCompensation", "") == "JFA":
        return train_target_jfa(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    mcfg = MapCfg.from_config(cfg)
    seed = cfg.get_int("randomSeed", 0)
    # TrainTargetFA variant (TrainTarget.cpp:279-420): estimate the
    # session channel factor on the client data and remove U·x from the
    # frames before MAP
    fa_model = None
    cc = cfg.get_str("channelCompensation", "")
    if cc == "LFA" or (cc not in ("", "JFA")
                       and cfg.get_bool("channelCompensation", False)):
        fa_model = _load_fa_model(cfg, world)
    # optional NAP of the client supervector (TrainTarget.cpp:154-157) and
    # supervector output instead of a model file (outputAdaptParam,
    # cpp:158-169: getSuperVector KL|SVMUBM written as a .vect matrix)
    nap_u = None
    if cfg.get_bool("NAP", False):
        from ..io.matrix import read_matrix_file
        nap_u = jnp.asarray(
            read_matrix_file(cfg.get_str("NAPChannelMatrix",
                                         cfg.get_str("channelMatrix", "U"))),
            jnp.float32)
    output_adapt_param = cfg.get_bool("outputAdaptParam", False)
    out: dict[str, GmmDiag] = {}
    for line_no, (client, files) in enumerate(read_ndx(ndx_path)):
        try:
            # useIdForSelectedFrame (GeneralTools.cpp:866): the client id
            # is the frame-selection label for its own files
            ccfg = cfg
            if cfg.get_bool("useIdForSelectedFrame", False):
                ccfg = cfg.copy()
                ccfg["labelSelectedFrames"] = client
            fs, mask = load_features_and_mask(files, ccfg)
        except FileNotFoundError as e:
            # reference warns and optionally falls back to the world model
            print(f"WARNING: no data for client [{client}]: {e}")
            if cfg.get_bool("useModelData", False):
                out[client] = world
                world.save(mixture_path(client, cfg, save=True),
                           fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                           model_id=client)
            continue
        x = jnp.asarray(fs.data)
        w = jnp.asarray(mask)
        if fa_model is not None:
            from ..fa.lfa import compensate_features, estimate_channel
            from ..fa.stats import bw_stats_batch
            x_h = estimate_channel(bw_stats_batch(x[None], w[None], world),
                                   fa_model)[0]
            x = compensate_features(x, world, fa_model, x_h)
        key = jax.random.key(seed + line_no)
        client_model = adapt_model(key, x, w, world, mcfg)
        if nap_u is not None:
            from ..backend.supervector import compute_nap
            client_model = compute_nap(client_model, nap_u)
        if output_adapt_param:
            import numpy as np
            from ..backend.supervector import get_supervector
            from ..io.matrix import write_matrix_file
            sv = get_supervector(cfg.get_str("superVector", "KL"),
                                 world, client_model)
            write_matrix_file(
                os.path.join(cfg.get_str("saveVectorFilesPath", "./"),
                             client + cfg.get_str("vectorFilesExtension",
                                                  ".vect")),
                np.asarray(sv, np.float64)[None, :])
        else:
            client_model.save(mixture_path(client, cfg, save=True),
                              fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                              model_id=client)
        out[client] = client_model
        if verbose:
            print(f"client [{client}]: {int(mask.sum())} frames "
                  f"→ {mixture_path(client, cfg, save=True)}")
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
