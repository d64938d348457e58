"""IvExtractor: i-vector extraction CLI.

Equivalent of reference ``LIA_SpkDet/IvExtractor`` (IvExtractor.cpp:70-150
exact estimateW; 151 UbmWeight variant; 253 EigenDecomposition variant).
Writes one i-vector file per target (saveWbyFile parity: a 1×R .matx per
session, plus a combined .npz).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..config import Config
from ..fa.stats import load_stats
from ..fa.tv import (TvModel, estimate_w, estimate_w_eigen_decomposition,
                     estimate_w_ubm_weight)
from ..gmm.model import GmmDiag
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import mixture_path, setup_verbose
from .total_variability import accumulate_stats_from_ndx, matrix_out_path


def vector_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("saveVectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".y")
    return os.path.join(root, name + ext)


def main(cfg: Config) -> dict[str, np.ndarray]:
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    model = TvModel.load(matrix_out_path(
        cfg.get_str("totalVariabilityMatrix"), cfg), gmm)
    if cfg.exists("meanEstimate"):
        mean = read_matrix_file(matrix_out_path(
            cfg.get_str("meanEstimate"), cfg))
        model = model.replace(ubm_means=mean.reshape(
            model.n_distrib, model.dim).astype(np.float32))
    if cfg.get_bool("loadAccs", False):
        stats, names = load_stats(cfg.get_str("accsFilename"))
    else:
        stats, names = accumulate_stats_from_ndx(cfg, gmm, verbose)
    mode = cfg.get_str("ivExtractionMode", "exact")
    if mode == "exact":
        # ivSolver: "pcg" (default — eigendecomposition-PRECONDITIONED
        # conjugate gradients, exact to f32 roundoff) or "cholesky"
        w = estimate_w(stats, model,
                       chunk=cfg.get_int("speakerChunk", 256),
                       solver=cfg.get_str("ivSolver", "pcg"),
                       pcg_iters=cfg.get_int("ivSolverPcgIterations", 16),
                       pcg_tol=cfg.get_float("ivSolverPcgTolerance", 1e-7))
    elif mode == "ubmWeight":
        # the reference uses this to dodge per-utterance L-inversion
        # (IvExtractor.cpp:151)
        w_mat = read_matrix_file(matrix_out_path(
            cfg.get_str("totalVariabilityMatrix") + "_weightedCov", cfg))
        w = estimate_w_ubm_weight(stats, model, w_mat.astype(np.float32))
    elif mode == "eigenDecomposition":
        base = cfg.get_str("totalVariabilityMatrix")
        d_mat = read_matrix_file(matrix_out_path(base + "_EigDec_D", cfg))
        q = read_matrix_file(matrix_out_path(base + "_EigDec_Q", cfg))
        w = estimate_w_eigen_decomposition(stats, model,
                                           d_mat.astype(np.float32),
                                           q.astype(np.float32))
    else:
        raise ValueError(f"unknown ivExtractionMode {mode}")
    w = np.asarray(w, np.float64)
    out: dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        write_matrix_file(vector_path(name, cfg), w[i][None, :])
        out[name] = w[i]
        if verbose:
            print(f"i-vector [{name}] → {vector_path(name, cfg)}")
    if cfg.exists("ivectorsOutput"):
        np.savez(cfg.get_str("ivectorsOutput"), w=w,
                 names=np.asarray(names, dtype=object))
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
