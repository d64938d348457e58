"""SVM parity: FISTA dual vs an independent SMO reference (libsvm's
algorithm), plus the CLI fixture flow.

The reference bundles libsvm and its test dir
(/root/reference/LIA_Utils/Svm/test/) ships only configs — the
heart_scale data and golden outputs are absent upstream, so exact
file-level goldens cannot exist.  Parity is therefore established
against an in-test second-order SMO solver implementing libsvm's
C-SVC working-set algorithm (svm.cpp solve path the reference calls
from Svm.cpp:339): both optimise the same dual QP, so solutions must
agree to optimisation tolerance.  Measured deviations are recorded in
PARITY.md §SVM.
"""

import os

import numpy as np
import pytest

from lia_ral.backend.svm import default_c, kernel_matrix, svm_train


def smo_reference(k, y, c_vec, tol=1e-8, max_iter=200_000):
    """Second-order working-set SMO for C-SVC (libsvm WSS2):
    min ½αᵀQα − 1ᵀα  s.t. 0 ≤ α ≤ C, yᵀα = 0."""
    n = y.shape[0]
    q = k * np.outer(y, y)
    alpha = np.zeros(n)
    grad = -np.ones(n)                      # Qα − 1 at α = 0
    for _ in range(max_iter):
        yg = -y * grad
        i_up = ((y > 0) & (alpha < c_vec - 1e-12)) \
            | ((y < 0) & (alpha > 1e-12))
        i_lo = ((y > 0) & (alpha > 1e-12)) \
            | ((y < 0) & (alpha < c_vec - 1e-12))
        if not i_up.any() or not i_lo.any():
            break
        i = int(np.argmax(np.where(i_up, yg, -np.inf)))
        j = int(np.argmin(np.where(i_lo, yg, np.inf)))
        if yg[i] - yg[j] < tol:
            break
        quad = max(q[i, i] + q[j, j] - 2.0 * y[i] * y[j] * q[i, j], 1e-12)
        delta = (yg[i] - yg[j]) / quad
        old_i, old_j = alpha[i], alpha[j]
        const = y[i] * old_i + y[j] * old_j
        ai = np.clip(old_i + y[i] * delta, 0.0, c_vec[i])
        aj = y[j] * (const - y[i] * ai)
        aj = np.clip(aj, 0.0, c_vec[j])
        ai = np.clip(y[i] * (const - y[j] * aj), 0.0, c_vec[i])
        alpha[i], alpha[j] = ai, aj
        grad += q[:, i] * (ai - old_i) + q[:, j] * (aj - old_j)
    dec0 = k @ (alpha * y)
    free = (alpha > 1e-8) & (alpha < c_vec - 1e-8)
    bias = float(np.mean(y[free] - dec0[free])) if free.any() \
        else float(np.mean(y - dec0))
    return alpha, bias


def dual_objective(k, y, alpha):
    q = k * np.outer(y, y)
    return float(alpha.sum() - 0.5 * alpha @ q @ alpha)


def _gmm_sv_problem(rng, n_tgt=3, n_coh=60, d=40):
    """1-target-vs-cohort supervector setup (the GmmSv fixture shape)."""
    coh = rng.standard_normal((n_coh, d)).astype(np.float32)
    tgt = (rng.standard_normal((n_tgt, d)) * 0.3 + 1.2).astype(np.float32)
    x = np.vstack([tgt, coh])
    y = np.r_[np.ones(n_tgt), -np.ones(n_coh)].astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", ["linear", "rbf"])
def test_fista_matches_smo(kind):
    """FISTA dual == libsvm-style SMO on the same QP: dual objective to
    1e-3 relative, decision values to 2e-2 absolute (PARITY.md §SVM)."""
    rng = np.random.default_rng(17)
    x, y = _gmm_sv_problem(rng)
    c = default_c(x)
    c_vec = np.full(y.shape, c)
    k = np.asarray(kernel_matrix(x, x, kind), np.float64)
    a_smo, b_smo = smo_reference(k, y.astype(np.float64), c_vec)
    model = svm_train(x, y, c=c, kind=kind, n_iter=2000)

    test = np.vstack([_gmm_sv_problem(rng)[0][:10]])
    kt = np.asarray(kernel_matrix(test, x, kind), np.float64)
    dec_smo = kt @ (a_smo * y) + b_smo
    dec_our = np.asarray(model.decision(test))
    # decisions agree to optimisation tolerance
    np.testing.assert_allclose(dec_our, dec_smo, atol=2e-2)
    # the FISTA dual objective reaches the SMO optimum (within 1e-3 rel)
    kj = np.asarray(kernel_matrix(x, x, kind), np.float64)
    alpha_full = np.zeros(y.shape)
    # reconstruct full alpha from stored support rows
    sup = model.support
    ai = np.abs(model.alpha_y)
    idx = 0
    for r, row in enumerate(x):
        if idx < len(sup) and np.allclose(row, sup[idx]):
            alpha_full[r] = ai[idx]
            idx += 1
    obj_smo = dual_objective(kj, y, a_smo)
    obj_our = dual_objective(kj, y, alpha_full)
    assert obj_our >= obj_smo - 1e-3 * max(abs(obj_smo), 1.0), \
        (obj_our, obj_smo)


def test_target_penalty_matches_weighted_smo():
    """targetPenalty (per-class C, the reference's unbalanced
    1-vs-cohort setup) agrees with class-weighted SMO."""
    rng = np.random.default_rng(23)
    x, y = _gmm_sv_problem(rng, n_tgt=1, n_coh=40)
    c = default_c(x)
    c_vec = np.full(y.shape, c)
    c_vec[y > 0] *= 10.0
    k = np.asarray(kernel_matrix(x, x, "linear"), np.float64)
    a_smo, b_smo = smo_reference(k, y.astype(np.float64), c_vec)
    model = svm_train(x, y, c=c, target_penalty=10.0, n_iter=2000)
    test = x[:5] + 0.05
    kt = np.asarray(kernel_matrix(test, x, "linear"), np.float64)
    dec_smo = kt @ (a_smo * y) + b_smo
    dec_our = np.asarray(model.decision(test))
    np.testing.assert_allclose(dec_our, dec_smo, atol=3e-2)


def test_svm_cli_fixture_flow(tmp_path):
    """Drive svmTrain/svmPredict exactly as the reference fixture configs
    do (GmmSv.cfg: target NDX + background list of .vect supervectors →
    .svm models → predict NDX → score file): target scores > cohort."""
    from lia_ral.config import Config
    from lia_ral.io.lists import write_xlist
    from lia_ral.io.matrix import write_matrix_file
    from lia_ral.io.nist import read_nist_scores
    from lia_ral.tools.utils_tools import (svm_predict_main,
                                               svm_train_main)
    rng = np.random.default_rng(5)
    d = 30
    root = str(tmp_path) + "/"
    coh_names = []
    for i in range(25):
        nm = f"bck{i}"
        write_matrix_file(root + nm + ".vect",
                          rng.standard_normal((1, d)))
        coh_names.append(nm)
    write_matrix_file(root + "tgtA.vect",
                      rng.standard_normal((1, d)) * 0.3 + 1.5)
    write_matrix_file(root + "probe_t.vect",
                      rng.standard_normal((1, d)) * 0.3 + 1.4)
    write_matrix_file(root + "probe_i.vect", rng.standard_normal((1, d)))
    (tmp_path / "world.ndx").write_text(
        "".join(n + "\n" for n in coh_names))
    write_xlist(root + "targets.ndx", [["modelA", "tgtA"]])
    write_xlist(root + "test.ndx", [["probe_t", "modelA"],
                                    ["probe_i", "modelA"]])
    cfg = Config({
        "vectorFilesPath": root, "vectorFilesExtension": ".vect",
        "backgroundList": root + "world.ndx",
        "targetIdList": root + "targets.ndx",
        "ndxFilename": root + "test.ndx",
        "outputFilename": root + "svm.res",
        "kernelType": 0,
    })
    svm_train_main(cfg)
    assert os.path.exists(root + "modelA.svm.npz")
    lines = svm_predict_main(cfg)
    by_seg = {l.seg: l.score for l in lines}
    assert by_seg["probe_t"] > by_seg["probe_i"]
    assert read_nist_scores(root + "svm.res")
