"""Multi-host bring-up helpers.

Reference analogue: Flight's location/endpoint topology (flight/types.h:366)
— but multi-host accelerator jobs coordinate through jax.distributed +
the mesh, not through a service registry. On several hosts:

    initialize()                 # once per host process
    mesh = global_mesh()         # all chips across all hosts, axis "x"

Per-host data loading composes with mesh.shard_batch: each host ingests
its own fragment set (dataset.py scanner), places rows on its local
devices, and the distributed operators' all_to_all collectives ride the device interconnect
within the slice (DCN between slices is XLA's concern via the same API).

Single-host validation strategy (SURVEY.md §4.6): the same code paths run
on a virtual many-device CPU mesh (tests/conftest.py) and in
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize", "global_mesh", "process_info",
           "local_row_range", "global_batch_from_local", "barrier",
           "broadcast_from_host0", "allgather_to_hosts"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallback
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes or int(os.environ["NUM_PROCESSES"]),
        process_id=process_id or int(os.environ["PROCESS_ID"]),
    )


def global_mesh(axis: str = "x") -> Mesh:
    """One data axis over every chip in the slice (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def process_info():
    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices())}


def local_row_range(total_rows: int) -> range:
    """The row range this host should ingest for an evenly sharded table
    (range partitioning by host — hash affinity comes from the shuffle)."""
    p, n = jax.process_index(), jax.process_count()
    per = (total_rows + n - 1) // n
    start = p * per
    return range(start, min(start + per, total_rows))


def global_batch_from_local(batch, mesh: Mesh, axis: str = "x"):
    """Assemble a globally-sharded RecordBatch from *this host's* rows.

    Each host calls this with its own local fragment; the result is one
    logical batch of shape [sum of host rows] sharded row-wise over the
    mesh (jax.make_array_from_process_local_data — the multi-host
    analogue of mesh.shard_batch). Row counts must be equal per host.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec(axis))

    def place(x):
        if x is None:
            return None
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x))

    return jax.tree_util.tree_map(place, batch)


def barrier(name: str = "arrow1_tpu_barrier") -> None:
    """Block until every host reaches this point (reference analogue:
    Flight coordination handshakes; here it is a device collective)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def broadcast_from_host0(tree):
    """Replicate host 0's pytree (e.g. a small dimension/build table) to
    all hosts — the multi-host path for dist_join's build replication."""
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(tree)


def allgather_to_hosts(tree):
    """Gather a sharded pytree so every host holds the full value
    (result egress: the inverse of global_batch_from_local)."""
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(tree, tiled=True)
