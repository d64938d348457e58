"""Device-mesh parallelism: sharded stat accumulation, multi-host helpers.

JAX replacement for the reference's two scale mechanisms
(SURVEY.md §2.6): the pthread worker pools (per-thread accumulators merged
with addAccEM) become data-parallel shard_map with psum'd stats, and the
file-level batch parallelism becomes multi-host data parallelism over the
same mesh.
"""

from .mesh import make_mesh, device_count
from .sharding import (
    shard_frames,
    sharded_em_stats,
    sharded_em_stats_2d,
    sharded_stats_fn,
)

__all__ = [
    "make_mesh", "device_count",
    "shard_frames", "sharded_em_stats", "sharded_em_stats_2d",
    "sharded_stats_fn",
]
