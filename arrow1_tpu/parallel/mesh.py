"""Device mesh setup + table sharding.

A table is distributed by sharding every column array over the mesh's
"x" (data) axis — rows are range-partitioned across devices, the
device-native analogue of the reference's one-fragment-per-scan-task
distribution (dataset/scanner.cc:62). Hash partitioning (key affinity) is
established on demand by the shuffle, not at ingest.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..column import Column
from ..table import RecordBatch

__all__ = ["make_mesh", "shard_batch", "unshard_batch", "pad_to_multiple"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def pad_to_multiple(batch: RecordBatch, multiple: int) -> RecordBatch:
    """Pad rows (with null rows) to a multiple; returns padded batch.
    Padding rows carry validity=False so they are inert in aggregations
    that honor masks; pipeline code tracks true row counts separately."""
    n = batch.num_rows
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return batch
    pad = target - n
    cols = []
    for c in batch.columns:
        data = jnp.concatenate([c.data, jnp.zeros(pad, c.data.dtype)])
        validity = jnp.concatenate([c.mask(), jnp.zeros(pad, jnp.bool_)])
        data2 = (jnp.concatenate([c.data2, jnp.zeros(pad, c.data2.dtype)])
                 if c.data2 is not None else None)
        cols.append(Column(data, c.dtype, validity=validity,
                           dictionary=c.dictionary, data2=data2))
    return RecordBatch(tuple(cols), batch.names)


def shard_batch(batch: RecordBatch, mesh: Mesh, axis: str = "x") -> RecordBatch:
    """Distribute rows across the mesh axis (pads to a device multiple)."""
    n_dev = mesh.shape[axis]
    batch = pad_to_multiple(batch, n_dev)
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        return jax.device_put(x, sharding) if x is not None else None

    cols = tuple(
        Column(put(c.data), c.dtype,
               validity=put(c.validity) if c.validity is not None else None,
               dictionary=c.dictionary,
               data2=put(c.data2) if c.data2 is not None else None)
        for c in batch.columns
    )
    return RecordBatch(cols, batch.names)


def unshard_batch(batch: RecordBatch) -> RecordBatch:
    """Gather a sharded batch to host-replicated arrays."""
    def pull(x):
        return None if x is None else jax.device_get(x)

    cols = tuple(
        Column(jnp.asarray(pull(c.data)), c.dtype,
               validity=None if c.validity is None else jnp.asarray(pull(c.validity)),
               dictionary=c.dictionary,
               data2=None if c.data2 is None else jnp.asarray(pull(c.data2)))
        for c in batch.columns
    )
    return RecordBatch(cols, batch.names)
