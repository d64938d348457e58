"""The one function that chooses how GMM statistics are computed
(gmm/stats_path.py), the package's flax-free pytrees, the compile-cache
directory, and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lia_ral.config import Config
from lia_ral.gmm import stats_kernel, stats_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy(rng, n=50, k=4, d=3):
    from lia_ral.gmm.model import GmmDiag
    gmm = GmmDiag.create(np.full(k, 1.0 / k), rng.standard_normal((k, d)),
                         rng.random((k, d)) + 0.5)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    return x, jnp.ones((n,), jnp.float32), gmm


def test_cpu_takes_xla_path_never_the_kernel(rng, monkeypatch):
    """On the CPU the kernel is never called, interpreted or not."""
    def refuse(*a, **kw):
        raise AssertionError("the fused kernel ran on the CPU")

    monkeypatch.setattr(stats_kernel, "segment_stats", refuse)
    assert jax.default_backend() == "cpu"
    assert not stats_path.use_kernel()
    x, w, gmm = _toy(rng)
    for fast_math in (False, True):
        for fast_stats in (False, True):
            st = stats_path.em_stats(x, w, gmm, fast_math=fast_math,
                                     fast_stats=fast_stats)
            assert np.isfinite(float(st.llk))
        n, f = stats_path.bw_stats(x[None], w[None], gmm,
                                   fast_stats=fast_math)
        assert n.shape == (1, 4) and f.shape == (1, 4, 3)


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False),
                                            ("metal", False)])
def test_kernel_chosen_by_backend(monkeypatch, backend, kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert stats_path.use_kernel() is kernel


def test_gpu_path_calls_compiled_kernel(rng, monkeypatch):
    """On a GPU every statistics call reaches the kernel with
    interpret=False and the caller's precision flags."""
    calls = []
    real = stats_kernel.segment_stats

    def spy(x, w, gmm, fast_math=False, fast_stats=False, interpret=False):
        calls.append((x.shape, fast_math, fast_stats, interpret))
        return real(x, w, gmm, fast_math=fast_math, fast_stats=fast_stats,
                    interpret=True)

    monkeypatch.setattr(stats_path, "use_kernel", lambda: True)
    monkeypatch.setattr(stats_kernel, "segment_stats", spy)
    x, w, gmm = _toy(rng, n=200)
    stats_path.em_stats(x, w, gmm, fast_math=True)
    stats_path.bw_stats(x.reshape(4, 50, 3), w.reshape(4, 50), gmm,
                        fast_stats=True)
    stats_path.em_stats(x, w, gmm, fast_math=True, fast_stats=True)
    assert calls[0][1:] == (True, False, False)
    assert calls[1] == ((4, 50, 3), False, True, False)
    assert calls[2][1:] == (True, True, False)
    n_seg, per = stats_kernel.em_segments(200)
    assert calls[0][0] == (n_seg, per, 3) and n_seg * per >= 200


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1_000_000])
def test_em_segments_cover_frames(n):
    n_seg, per = stats_kernel.em_segments(n)
    assert n_seg * per >= n and per % 64 == 0
    assert (n_seg - 1) * per < n


@pytest.mark.parametrize("keys,flags", [
    ({"fastMath": "true"}, (True, False)),
    ({"fastStats": "true"}, (False, True)),
    ({"fastMath": "true", "fastStats": "true"}, (True, True))])
def test_config_keys_set_precision_flags(rng, keys, flags):
    """Each key sets its own flag; both keys together set both, as they
    always could."""
    from lia_ral.gmm.kernels import em_stats_chunked
    from lia_ral.tools.common import resolve_stats_fn

    x, w, gmm = _toy(rng, n=128)
    got = resolve_stats_fn(Config(keys))(x, w, gmm)
    want = em_stats_chunked(x, w, gmm, fast_math=flags[0],
                            fast_stats=flags[1])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fast_math_reaches_em_statistics_only():
    """fastMath reaches TrainWorld's EM statistics; the Baum-Welch
    statistics of TotalVariability and ComputeJFAStats read fastStats
    alone."""
    import inspect

    from lia_ral.fa import stats as fa_stats
    from lia_ral.tools import jfa_tools, total_variability

    assert "fast_math" not in inspect.signature(stats_path.bw_stats).parameters
    assert "fast_math" not in inspect.signature(
        fa_stats.bw_stats_bucketed).parameters
    for mod in (total_variability, jfa_tools):
        src = inspect.getsource(mod)
        assert "fastMath" not in src and '"fastStats"' in src


def test_resolve_stats_fn_honours_flags(rng):
    """numThread=1 with a flag gives a stats_fn with that flag; numThread>1
    shards it; neither set keeps the default path."""
    from lia_ral.gmm.kernels import em_stats_chunked
    from lia_ral.tools.common import resolve_stats_fn

    assert resolve_stats_fn(Config({})) is None
    x, w, gmm = _toy(rng, n=128)
    want = em_stats_chunked(x, w, gmm, fast_stats=True)
    for threads in ("1", "4"):
        fn = resolve_stats_fn(Config({"fastStats": "true",
                                      "numThread": threads}))
        got = fn(x, w, gmm)
        np.testing.assert_allclose(np.asarray(got.sum_x),
                                   np.asarray(want.sum_x), rtol=1e-5,
                                   atol=1e-5)


# ---- pytrees ------------------------------------------------------------------

def _instances(rng):
    from lia_ral.fa.stats import BwStats
    from lia_ral.fa.tv import TvModel
    from lia_ral.gmm.kernels import EmStats
    from lia_ral.gmm.model import GmmDiag
    gmm = GmmDiag.uniform_init(4, 3)
    return [gmm, EmStats.zeros(4, 3),
            BwStats(n=jnp.ones((2, 4)), f=jnp.ones((2, 4, 3))),
            TvModel.from_ubm(jnp.ones((2, 4, 3)), gmm)]


@pytest.mark.parametrize("idx", range(4))
def test_pytree_flatten_replace_jit(rng, idx):
    import dataclasses
    obj = _instances(rng)[idx]
    leaves, treedef = jax.tree.flatten(obj)
    assert len(leaves) == len(dataclasses.fields(obj))
    again = jax.tree.unflatten(treedef, leaves)
    assert type(again) is type(obj)
    first = dataclasses.fields(obj)[0].name
    bumped = obj.replace(**{first: getattr(obj, first) + 1})
    assert type(bumped) is type(obj)
    np.testing.assert_array_equal(np.asarray(getattr(bumped, first)),
                                  np.asarray(getattr(obj, first)) + 1)
    out = jax.jit(lambda o: jax.tree.map(lambda a: a * 2, o))(obj)
    assert type(out) is type(obj)
    for a, b in zip(jax.tree.leaves(out), leaves):
        np.testing.assert_array_equal(np.asarray(a), 2 * np.asarray(b))
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, None)


def test_no_flax_import():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, lia_ral.fa, lia_ral.backend, lia_ral.gmm, "
         "lia_ral.tools.common; print('flax' in sys.modules)"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


# ---- compile cache ------------------------------------------------------------

def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, lia_ral, json; print(json.dumps("
         "[jax.config.jax_compilation_cache_dir, "
         "lia_ral.compile_cache_dir()]))"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_dir_env_set(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_child(want) == [want, want]


def test_compile_cache_dir_default_in_checkout():
    want = os.path.join(ROOT, ".jax_cache")
    assert _cache_dir_in_child(None) == [want, want]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---- chip_smoke.py --------------------------------------------------------------

def _run_smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---- chip_smoke.py's precision readout ------------------------------------------

def _smoke_module():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("fast_math,fast_stats", [
    (False, False), (True, False), (False, True), (True, True)])
def test_smoke_reads_kernel_precisions(rng, monkeypatch, fast_math,
                                       fast_stats):
    """The kernel's products, read from the traced program: bf16×3 at
    f32 grade, one bf16 pass where a flag asks for it."""
    smoke = _smoke_module()
    monkeypatch.setattr(stats_path, "use_kernel", lambda: True)
    x, w, gmm = _toy(rng, n=100, k=20)
    dots = smoke.kernel_dot_precisions(
        lambda a, b, g: stats_path.em_stats(
            a, b, g, fast_math=fast_math, fast_stats=fast_stats), x, w, gmm)
    dens = "BF16" if fast_math else smoke.X3
    assert dots == [dens, dens, "BF16" if fast_stats else smoke.X3]


@pytest.mark.parametrize("precision,f32", [("highest", True),
                                           ("high", False)])
def test_smoke_reads_xla_precisions(rng, precision, f32):
    """XLA's products, read from the lowered and compiled programs: the
    f32-grade check holds at "highest" and fails below it."""
    from lia_ral.gmm.kernels import em_stats_chunked

    smoke = _smoke_module()
    x, w, gmm = _toy(rng, n=64)
    with jax.default_matmul_precision(precision):
        lowered = jax.jit(lambda a, b, g: em_stats_chunked(
            a, b, g, chunk=32)).lower(x, w, gmm)
        req, got = smoke.xla_dot_precisions(lowered.as_text(),
                                            lowered.compile().as_text())
    assert len(req) >= 3
    assert smoke.f32_grade(req, got) is f32
    assert not smoke.f32_grade(["HIGHEST,HIGHEST"], ["alg_dot_tf32_tf32_f32"])
    assert not smoke.f32_grade(["HIGHEST,HIGHEST"], ["dot_bf16_bf16_f32"])
    assert smoke.f32_grade(["HIGHEST,HIGHEST"],
                           ["alg_unset", "dot_bf16_bf16_f32_x6",
                            "highest,highest"])


# ---- the former package name ------------------------------------------------------

def test_former_package_name_aliases_lia_ral():
    """The former import name serves the same module objects, and its
    ``python -m`` runs the CLI."""
    old = next(n for n in sorted(os.listdir(ROOT)) if n.startswith("lia_ral_")
               and os.path.isfile(os.path.join(ROOT, n, "__init__.py")))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    code = (f"import {old}.gmm.em as a, lia_ral.gmm.em as b; "
            f"from {old}.gmm import GmmDiag; "
            "from lia_ral.gmm.model import GmmDiag as G; "
            "assert a is b and GmmDiag is G; "
            "assert b.__spec__.name == 'lia_ral.gmm.em'; print('same')")
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "same"
    out = subprocess.run([sys.executable, "-m", old], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "TrainWorld" in out.stdout
