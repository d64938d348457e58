"""lia_ral — a speaker-recognition framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ALIZE-Speaker-Recognition/LIA_RAL (reference layout documented in SURVEY.md):

- ``lia_ral.config``   — key/value config files + CLI overrides + schemas
  (capability parity with ALIZE Config/ConfigChecker/CmdLine).
- ``lia_ral.io``       — feature (.prm SPRO3/SPRO4/RAW), label (.lbl),
  mixture (.gmm XML/RAW), matrix (.matx), list (NDX/XList) and NIST score IO.
- ``lia_ral.frontend`` — MFCC, SDC, CMVN/warping, energy VAD.
- ``lia_ral.gmm``      — diagonal-GMM model pytrees, fused LLK/posterior/
  sufficient-stat kernels, UBM EM, MAP adaptation, trial scoring.
- ``lia_ral.fa``       — Baum-Welch stats, TotalVariability (i-vector),
  JFA eigenvoice/eigenchannel/D engines.
- ``lia_ral.backend``  — i-vector backends: length-norm/EFR, LDA, WCCN,
  two-cov, G-PLDA training + scoring, score normalization (zt-norm).
- ``lia_ral.seg``      — segment tools, HMM/Viterbi, diarization,
  clustering criteria.
- ``lia_ral.parallel`` — device-mesh sharding of stat accumulation
  (data-parallel psum), multi-host helpers.
- ``lia_ral.api``      — high-level speaker-detection API + TCP server.
- ``lia_ral.tools``    — CLI entry points mirroring the reference
  binaries (TrainWorld, TrainTarget, ComputeTest, ...).

The reference implementation is CPU C++ (pthread map-reduce over frames);
this framework re-expresses every hot loop as batched matrix products
with frame-axis masking (plus one fused GPU kernel for the GMM
statistics, ``gmm.stats_kernel``), and every thread-pool merge as a psum.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Numerics default: f32 products for every matrix product XLA compiles.
# The reference computes in double throughout, and parity ("allclose on
# UBM parameters, i-vectors, and trial scores", BASELINE.md) needs
# f32-grade numerics.  On an NVIDIA GPU any f32 product below "highest"
# may run in TF32, which keeps 10 mantissa bits: a (4096×80)@(80×2048)
# density product then errs by 1.6e-2 absolute against f64, against
# 2e-5 at "highest" (H100 measurement, PERF.md).  The fused statistics
# kernel sets its own precision per product; bf16 single-pass density
# products remain the explicit speed tier (config key ``fastMath``).
#
# This is a PROCESS-GLOBAL setting: LIA_RAL_NO_GLOBAL_PRECISION=1 (set
# before first import) leaves the caller's configuration untouched.
if _os.environ.get("LIA_RAL_NO_GLOBAL_PRECISION", "0") != "1":
    _jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir() -> str:
    """The persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR
    where set, else ``.jax_cache`` at the root of this checkout."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), ".jax_cache"))


# Persistent compilation cache: the operational model is a file DAG of
# many short-lived CLI processes (the reference's binaries), so each
# process would otherwise recompile every stage.  Where the environment
# names a cache directory JAX reads it itself; otherwise the cache sits
# at a fixed path inside the checkout (listed in .gitignore).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
# cache every executable (the default keeps only >1 s compiles)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
