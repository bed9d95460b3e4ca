"""Hash-partitioned shuffle over the mesh: the engine's exchange operator.

Replaces the reference's Flight-RPC data plane (arrow/flight/
serialization_internal.cc zero-copy gRPC streaming) with compiled
collectives: inside `shard_map`, every device compacts its rows into
per-destination buckets and one `lax.all_to_all` swaps them — no
serialization, no host, data never leaves device memory and the interconnect (SURVEY.md §2
"Distributed exchange" row).

Fixed-shape contract: all_to_all needs equal bucket sizes, so buckets are
padded to a static per-destination `capacity`; rows beyond capacity are
counted in an overflow flag the host checks (capacity comes from a
cardinality estimate; the eager wrappers in distributed.py pick a safe
bound). Skewed keys concentrate in one destination — the planned
mitigation (BASELINE skew spec) is salted repartitioning: detect hot keys
from the partition histogram, split them across `salt` sub-partitions and
replicate the build side; wired in distributed.dist_join via
`salt_hot_keys`.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.padded import filter_padded

__all__ = ["partition_ids", "shuffle_shard", "FNV_MIX"]

# Fibonacci (golden-ratio) multiplicative mixing — same role as the
# reference's ScalarHelper multiply-shift hashing (util/hashing.h:84).
FNV_MIX = np.uint64(0x9E3779B97F4A7C15)  # np: no backend init at import


def partition_ids(key_u64: jnp.ndarray, n_parts: int,
                  salt: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Destination partition per row from a normalized uint64 key.

    Uses high bits of the golden-ratio mix (low bits of a multiply are
    weak). `salt` (optional small int array) splits hot keys across
    destinations for skew mitigation."""
    h = key_u64 * FNV_MIX
    if salt is not None:
        h = h + salt.astype(jnp.uint64) * jnp.uint64(0xD1B54A32D192ED03)
    return ((h >> jnp.uint64(33)) % jnp.uint64(n_parts)).astype(jnp.int32)


def shuffle_shard(arrays: Dict[str, jnp.ndarray], part: jnp.ndarray,
                  row_valid: jnp.ndarray, axis_name: str, n_dev: int,
                  capacity: int):
    """Per-shard shuffle body (call inside shard_map).

    arrays: name -> local array [R, ...] to exchange.
    part:   int32[R] destination device per row.
    row_valid: bool[R] live-row mask (padding rows never shipped).
    capacity: static per-(src,dst) bucket size.

    Returns (out_arrays: name -> [n_dev*capacity, ...], out_valid
    bool[n_dev*capacity], overflowed bool scalar).
    """
    R = part.shape[0]
    slot = jnp.arange(capacity, dtype=jnp.int32)

    send_idx = []
    send_valid = []
    overflow = jnp.zeros((), jnp.bool_)
    for d in range(n_dev):
        sel = (part == d) & row_valid
        idx, count = filter_padded(sel)
        overflow = overflow | (count > capacity)
        send_idx.append(idx[:capacity] if capacity <= R else jnp.pad(
            idx, (0, capacity - R)))
        send_valid.append(slot < jnp.minimum(count, capacity))
    send_idx = jnp.stack(send_idx)      # [D, C]
    send_valid = jnp.stack(send_valid)  # [D, C]

    out_arrays = {}
    for name, arr in arrays.items():
        bucketed = arr[send_idx]        # [D, C, ...]
        recv = jax.lax.all_to_all(bucketed, axis_name, split_axis=0,
                                  concat_axis=0, tiled=True)
        out_arrays[name] = recv.reshape((n_dev * capacity,) + arr.shape[1:])
    recv_valid = jax.lax.all_to_all(send_valid, axis_name, split_axis=0,
                                    concat_axis=0, tiled=True)
    out_valid = recv_valid.reshape(n_dev * capacity)
    return out_arrays, out_valid, overflow
