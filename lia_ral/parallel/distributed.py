"""Multi-host distributed runtime (SURVEY.md §2.6/§7).

The reference scales across machines operationally: users shard NDX file
lists, run one binary per shard, and merge sufficient-statistics
checkpoint files (``loadAccs`` merge,
``LIA_SpkDet/TotalVariability/TotalVariability.cpp:82-90``).  The
JAX equivalent keeps that file-DAG contract but adds a real
multi-controller runtime: ``jax.distributed`` over DCN, host-local data
loading, and a global device mesh on which the per-shard statistics
reduce with psum — the same merge the reference performs with
``addAccEM`` across pthread accumulators, lifted across hosts.

Wire-up (same on a GPU cluster and the CPU test harness):

    initialize_from_env()                     # no-op when single-process
    names = shard_file_list(all_names)        # host-local NDX shard
    mesh  = make_global_mesh()                # spans every host's devices
    stats = global_stats(mesh, stats_fn, x, w, gmm)   # psum across hosts

Tested by ``tests/test_multihost.py``: two coordinated CPU processes
(2 virtual devices each) produce bitwise-identical global EM stats to a
single-process run over the full corpus.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_from_env(coordinator: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None) -> bool:
    """Initialise the JAX multi-controller runtime.

    Explicit arguments win; otherwise the standard env vars
    (``LIA_COORDINATOR``, ``LIA_NUM_PROCESSES``, ``LIA_PROCESS_ID``) are
    used; with neither, this is a single-process no-op (returns False).
    On clusters that JAX auto-detects (e.g. SLURM),
    ``jax.distributed.initialize()`` with no arguments also works — pass
    coordinator="auto" to request that.
    """
    coordinator = coordinator or os.environ.get("LIA_COORDINATOR")
    if coordinator is None:
        return False
    if coordinator == "auto":
        jax.distributed.initialize()
        return True
    num_processes = int(num_processes
                        if num_processes is not None
                        else os.environ["LIA_NUM_PROCESSES"])
    process_id = int(process_id
                     if process_id is not None
                     else os.environ["LIA_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def shard_file_list(names: list[str],
                    process_index: int | None = None,
                    process_count: int | None = None) -> list[str]:
    """Host-local shard of an NDX/file list (round-robin, deterministic).

    This is the reference's operational sharding of file lists made
    first-class; every host streams only its shard from disk."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [n for i, n in enumerate(names) if i % pc == pi]


def make_global_mesh(n_model: int = 1) -> Mesh:
    """("data", "model") mesh over ALL processes' devices."""
    devs = jax.devices()          # global device list in multi-controller
    n_data = len(devs) // n_model
    grid = np.asarray(devs[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def host_local_batch(mesh: Mesh, x: np.ndarray, w: np.ndarray):
    """Build a global frame-sharded array from each host's LOCAL frames.

    Every host passes its own (N_local, D) frames; the result is a global
    (N_local·P, D) array sharded over the mesh "data" axis whose shards
    live where their host loaded them — no cross-host data movement."""
    sh_x = NamedSharding(mesh, P(("data",), None))
    sh_w = NamedSharding(mesh, P(("data",)))
    gx = jax.make_array_from_process_local_data(sh_x, x)
    gw = jax.make_array_from_process_local_data(sh_w, w)
    return gx, gw


def global_stats(mesh: Mesh, stats_fn, x, w, gmm):
    """All-host sufficient statistics: run ``stats_fn`` on the globally
    sharded frames; XLA inserts the cross-host psum for the (replicated)
    stat outputs — the multi-host form of the reference's addAccEM merge
    (AccumulateStat.cpp:289)."""
    in_shardings = (NamedSharding(mesh, P(("data",), None)),
                    NamedSharding(mesh, P(("data",))),
                    NamedSharding(mesh, P()))
    out_sharding = NamedSharding(mesh, P())

    fn = jax.jit(stats_fn, in_shardings=in_shardings,
                 out_shardings=out_sharding)
    return fn(x, w, gmm)
