"""Multi-host runtime (SURVEY.md §2.6; VERDICT.md missing #1).

Two coordinated CPU processes (jax.distributed, 2 virtual devices each)
accumulate EM sufficient statistics over host-local corpus shards on a
global 4-device mesh; the psum-merged result must equal the
single-process full-corpus statistics.  This is the cross-host form of
the reference's per-thread accumulator merge (addAccEM,
AccumulateStat.cpp:289) + file-level batch parallelism
(TotalVariability.cpp:82-90 loadAccs)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_stats_equal_single_process(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(pid), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    # the file-list shards are disjoint and cover everything
    shards = []
    for pid in range(2):
        with open(os.path.join(str(tmp_path), f"names_{pid}.txt")) as f:
            shards.append(f.read().split())
    assert not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == sorted(f"f{i}" for i in range(10))

    # global psum-merged stats == single-process reference
    from tests._multihost_worker import corpus
    from lia_ral.gmm.kernels import em_stats
    x, w, gmm = corpus()
    ref = em_stats(x, w, gmm)
    got = np.load(os.path.join(str(tmp_path), "stats.npz"))
    np.testing.assert_allclose(got["n"], np.asarray(ref.n),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["sum_x"], np.asarray(ref.sum_x),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["sum_xx"], np.asarray(ref.sum_xx),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["llk"], np.asarray(ref.llk),
                               rtol=1e-5, atol=1e-3)
    assert got["count"] == pytest.approx(float(ref.count))

    # cross-host PLDA EM == single-process serial iteration
    from tests._multihost_worker import plda_problem
    from lia_ral.backend.ivnorm import DevSet
    from lia_ral.backend.plda import plda_em_iteration
    vecs, labels, model = plda_problem()
    ref_p = plda_em_iteration(model, DevSet.from_labels(vecs, labels))
    got_p = np.load(os.path.join(str(tmp_path), "plda.npz"))
    np.testing.assert_allclose(got_p["f"], np.asarray(ref_p.f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_p["sigma"], np.asarray(ref_p.sigma),
                               rtol=1e-4, atol=1e-4)

    # cross-host TV E-step == single-process serial E-step
    from tests._multihost_worker import tv_problem
    from lia_ral.fa.tv import tv_e_step
    stats_tv, tv_model = tv_problem()
    _, ref_tv = tv_e_step(stats_tv, tv_model, chunk=4)
    got_tv = np.load(os.path.join(str(tmp_path), "tv.npz"))
    for key, refv in (("a", ref_tv.a), ("c", ref_tv.c),
                      ("r_mat", ref_tv.r_mat), ("r_vec", ref_tv.r_vec)):
        np.testing.assert_allclose(got_tv[key], np.asarray(refv),
                                   rtol=2e-3, atol=2e-3)

    # cross-host JFA V iteration == single-process serial iteration
    # (the DCN form of the threaded estimateVEVT merge,
    # AccumulateJFAStat.cpp:1573)
    from tests._multihost_worker import jfa_problem
    from lia_ral.fa.jfa import jfa_v_iteration
    jstats, jmodel, jx, jz = jfa_problem()
    ref_m, ref_y = jfa_v_iteration(jstats, jmodel, jx, jz)
    got_j = np.load(os.path.join(str(tmp_path), "jfa.npz"))
    np.testing.assert_allclose(got_j["v"], np.asarray(ref_m.v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_j["y"], np.asarray(ref_y),
                               rtol=2e-4, atol=2e-5)

    # cross-host i-vector extraction == single-process estimate_w
    from lia_ral.fa.tv import estimate_w
    ref_w = estimate_w(stats_tv, tv_model, chunk=2, pcg_iters=12)
    got_w = np.load(os.path.join(str(tmp_path), "w_iv.npz"))
    np.testing.assert_allclose(got_w["w"], np.asarray(ref_w),
                               rtol=2e-3, atol=2e-3)
