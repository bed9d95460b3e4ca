"""Distribution layer: mesh setup, hash-partitioned shuffle, distributed
operators.

Replaces the reference's process-level distribution story (Flight RPC
gRPC streaming, arrow/flight/ — which ships *mechanism only*, no
distributed planner) with compiled collectives: tables are row-sharded
over a `jax.sharding.Mesh` data axis, repartitioning is
`shard_map` + `lax.all_to_all`, and the distributed operators compose the
padded device primitives from ops/padded.py (SURVEY.md §2 parallelism
table, last row).
"""

from .mesh import make_mesh, shard_batch, unshard_batch  # noqa: F401
from .distributed import (dist_filter, dist_filter_padded,  # noqa: F401
                          dist_group_by, dist_join, dist_sort_indices)
