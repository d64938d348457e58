"""Per-stage wall/compile attribution for milestone drivers.

A slow stage wall alone cannot tell a regression from a fresh compile.
StageMonitor records, per stage:

  wall_s          stage wall time
  compiles        backend_compile events fired during the stage
  compile_s       summed backend-compile duration (jax.monitoring)
  cache_requests  compile-cache lookups (hit or miss) — a proxy for
                  how many distinct executables the stage touched
  cache_delta     new entries in the persistent compile-cache dir

Attribution rule: ``compile_s ≈ wall`` → cold compile, rerun warm
before comparing.
"""

from __future__ import annotations

import json
import os
import time


def cache_entries() -> int:
    from .. import compile_cache_dir
    try:
        return len(os.listdir(compile_cache_dir()))
    except OSError:
        return 0


class StageMonitor:
    """Collects per-stage timing + compile-activity records.

    Usage::

        mon = StageMonitor()
        with mon.stage("train_world"):
            ...
        summary["stage_records"] = mon.records   # name -> dict
    """

    def __init__(self, echo: bool = True):
        self.records: dict[str, dict] = {}
        self._echo = echo
        self._compiles = 0
        self._compile_s = 0.0
        self._cache_req = 0
        from jax import monitoring

        def _on_event(name, **kw):
            if name == "/jax/compilation_cache/compile_requests_use_cache":
                self._cache_req += 1

        def _on_duration(name, secs, **kw):
            if name == "/jax/core/compile/backend_compile_duration":
                self._compiles += 1
                self._compile_s += secs

        monitoring.register_event_listener(_on_event)
        monitoring.register_event_duration_secs_listener(_on_duration)

    def stage(self, name: str):
        mon = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                self.c0 = (mon._compiles, mon._compile_s, mon._cache_req)
                self.e0 = cache_entries()

            def __exit__(self, *a):
                dt = time.perf_counter() - self.t0
                rec = {
                    "wall_s": round(dt, 2),
                    "compiles": mon._compiles - self.c0[0],
                    "compile_s": round(mon._compile_s - self.c0[1], 2),
                    "cache_requests": mon._cache_req - self.c0[2],
                    "cache_delta": cache_entries() - self.e0,
                }
                mon.records[name] = rec
                if mon._echo:
                    print(json.dumps({"stage": name, **rec}), flush=True)

        return _T()

    @property
    def stage_walls(self) -> dict[str, float]:
        return {k: v["wall_s"] for k, v in self.records.items()}
