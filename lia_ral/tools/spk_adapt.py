"""SpkAdapt: unsupervised speaker adaptation over a test sequence.

Equivalent of reference ``LIA_SpkDet/SpkAdapt`` (TrainTargetAdapt,
SpkAdapt.cpp:90): per target — enroll from the train list, then walk the
test-trial sequence; each trial is scored, the score is mapped to a
target posterior by WMAP, and the model is incrementally MAP-updated with
the trial's frames weighted by that posterior.  Scores (before
adaptation) are written in NIST format.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np

from ..backend.unsupervised import (UnsupervisedAdapter, expand_llr,
                                    load_tnorm_param, normalize_score,
                                    online_znorm_params, oracle, wmap)
from ..config import Config
from ..gmm.map_adapt import MapCfg
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.nist import ScoreLine, write_nist_scores
from .common import load_features_and_mask, mixture_path, setup_verbose


def main(cfg: Config) -> list[ScoreLine]:
    verbose = setup_verbose(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg))
    mcfg = MapCfg.from_config(cfg) if cfg.exists("MAPAlgo") else \
        MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0)
    tar_mean = cfg.get_float("WMAPtarMean", 1.0)
    tar_std = cfg.get_float("WMAPtarStd", 1.0)
    imp_mean = cfg.get_float("WMAPimpMean", -1.0)
    imp_std = cfg.get_float("WMAPimpStd", 1.0)
    prior = cfg.get_float("WMAPtarPrior", 0.1)
    gender = cfg.get_str("gender", "M")
    # trial-weighting mode (reference SpkAdaptMain.cpp keys):
    # WMAP (default) | REGRESS (expandLLR logistic) | Oracle
    use_regress = cfg.get_bool("REGRESS", False)
    use_oracle = cfg.get_bool("Oracle", False)
    target_tests: list[tuple[str, str]] = []
    if use_oracle and cfg.exists("targetTests"):
        for name, elems in read_ndx(cfg.get_str("targetTests")):
            # "model x test ..." lines — columns 0 and 2
            if len(elems) >= 2:
                target_tests.append((name, elems[1]))
    # optional T-norm of scores before weighting (reference TNORM key:
    # impostor trial scores from a res file, loadTnormParam)
    tnorm_cache = None
    if cfg.get_bool("TNORM", False) and cfg.exists("tnormResFilename"):
        from ..io.nist import read_nist_scores
        lines = read_nist_scores(cfg.get_str("tnormResFilename"))
        res = [(ln.model, ln.seg, ln.score) for ln in lines]
        tnorm_cache = load_tnorm_param(sorted({t for _, t, _ in res}), res)
    # online Z-norm (reference ZNORM + impCohortFile keys,
    # SpkAdapt.cpp:146-219/393): pooled scores drift upward as a model
    # absorbs trial data, so Z-norm parameters must follow the ADAPTED
    # model.  The reference computes them once per client and corrects
    # drift with a precomputed frame-count shift table (cpp:717-733);
    # here the cohort is re-scored against the current model in one
    # batched dispatch whenever the model changed (online_znorm_params).
    use_znorm = cfg.get_bool("ZNORM", False)
    # refresh threshold: a near-zero WMAP weight (clear impostor) barely
    # moves the model but still changes stats.count, and an exact-equality
    # cache key would then pay a full cohort re-scoring dispatch for
    # Z-norm parameters that did not move.
    # Refresh only when the accumulated frame count grew by more than
    # znormRefreshMinFrames (0 restores the exact per-change behavior).
    znorm_min_frames = cfg.get_float("znormRefreshMinFrames", 1.0)
    cohort_x = cohort_w = None
    if use_znorm:
        from ..io.lists import read_simple_list
        c_names = read_simple_list(cfg.get_str("impCohortFile"))
        mats, masks = [], []
        for nm in c_names:
            fs_c, m_c = load_features_and_mask([nm], cfg)
            mats.append(np.asarray(fs_c.data, np.float32))
            masks.append(np.asarray(m_c, np.float32))
        t_max = max(m.shape[0] for m in mats)
        cx = np.zeros((len(mats), t_max, mats[0].shape[1]), np.float32)
        cw = np.zeros((len(mats), t_max), np.float32)
        for i, (mx, mw) in enumerate(zip(mats, masks)):
            cx[i, :mx.shape[0]] = mx
            cw[i, :mw.shape[0]] = mw
        cohort_x, cohort_w = jnp.asarray(cx), jnp.asarray(cw)
    zcache: dict[str, tuple[float, object]] = {}
    results: list[ScoreLine] = []
    # targetIdList: "target trainFile+"; ndxFilename: "testSeg target+"
    train = dict(read_ndx(cfg.get_str("targetIdList")))
    trials = read_ndx(cfg.get_str("ndxFilename"))
    adapters: dict[str, UnsupervisedAdapter] = {}
    for target, files in train.items():
        fs, mask = load_features_and_mask(files if files else [target], cfg)
        ad = UnsupervisedAdapter(world=world, map_cfg=mcfg)
        ad.enroll(jnp.asarray(fs.data), jnp.asarray(mask))
        adapters[target] = ad
    for test_name, targets in trials:
        fs, mask = load_features_and_mask([test_name], cfg)
        x = jnp.asarray(fs.data)
        w = jnp.asarray(mask)
        for target in targets:
            ad = adapters[target]
            score = ad.score(x, w)
            if tnorm_cache is not None:
                score = normalize_score(test_name, score, tnorm_cache)
            if use_znorm:
                cnt = float(np.asarray(ad.stats.count))
                zc = zcache.get(target)
                if zc is None or cnt - zc[0] > znorm_min_frames:
                    # model materially changed → refresh cohort Z-norm
                    zc = (cnt, online_znorm_params(ad.model, world,
                                                   cohort_x, cohort_w))
                    zcache[target] = zc
                score = (score - zc[1].mu) / zc[1].sigma
            results.append(ScoreLine(gender, target,
                                     "1" if score > 0 else "0",
                                     test_name, score))
            if use_oracle:
                weight = oracle(target, test_name, score, target_tests)
            elif use_regress:
                weight = float(expand_llr(
                    np.asarray([score]), cfg.get_float("THETA", 0.0),
                    cfg.get_float("BETA", 1.0))[0])
            else:
                weight = float(wmap(np.asarray([score]), tar_mean, tar_std,
                                    imp_mean, imp_std, prior)[0])
            ad.process_trial(x, w, weight)
            if verbose:
                print(f"[{target}×{test_name}] score={score:.4f} "
                      f"wmap={weight:.3f}")
    # save the adapted models
    for target, ad in adapters.items():
        ad.model.save(mixture_path(target, cfg, save=True),
                      fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                      model_id=target)
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
