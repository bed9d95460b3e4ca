"""Compile-bounded prefix scans (blocked two-level form).

Every scanned axis longer than NATIVE_SCAN_MAX is capped: reshape
[n] -> [B, C], scan axis 1, scan the B block totals, and combine the
block prefix back in. The form exists because long `jnp.cumsum` /
`lax.associative_scan` axes compiled superlinearly slowly on the
engine's first target; runtime cost is one extra [B] scan + an
elementwise combine. Whether the H100 still needs it, against plain
`jnp.cumsum` and `lax.associative_scan` at cell sizes, is ROADMAP
Speed 7.

The reference meets the same need with sequential C++ loops
(e.g. compute/kernels/vector_cumulative_ops.cc).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["cumsum_blocked", "scan_blocked", "NATIVE_SCAN_MAX"]

# axis lengths up to this use the native op (compile cost fine there)
NATIVE_SCAN_MAX = 262_144


def _block_shape(n: int):
    c = 1 << max(12, (n.bit_length() + 1) // 2)
    c = min(c, 65_536)
    b = -(-n // c)
    return b, c


def cumsum_blocked(x: jnp.ndarray, dtype=None) -> jnp.ndarray:
    """Inclusive prefix sum along axis 0 (1-D input), blocked."""
    n = x.shape[0]
    if dtype is not None:
        x = x.astype(dtype)
    if n <= NATIVE_SCAN_MAX:
        return jnp.cumsum(x)
    b, c = _block_shape(n)
    pad = b * c - n
    if pad:
        x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
    xb = x.reshape(b, c)
    inner = jnp.cumsum(xb, axis=1)
    totals = inner[:, -1]
    # exclusive block prefix (recursion: B is far below the cap)
    offs = cumsum_blocked(totals) - totals
    return (inner + offs[:, None]).reshape(-1)[:n]


def scan_blocked(fn: Callable, elems, reverse: bool = False):
    """lax.associative_scan with every scanned axis capped at C.

    fn: associative combine over pytrees, written with broadcasting
    jnp ops (it is applied to [B, 1]-vs-[B, C] for the block-prefix
    fold). Only 1-D leaf arrays are supported. For reverse=True the
    combine must be COMMUTATIVE (max/min/add/or-style): the reverse
    scan runs as flip -> forward -> flip.
    """
    leaves = jax.tree_util.tree_leaves(elems)
    n = leaves[0].shape[0]
    if n <= NATIVE_SCAN_MAX:
        return jax.lax.associative_scan(fn, elems, reverse=reverse)
    if reverse:
        flipped = jax.tree_util.tree_map(lambda a: a[::-1], elems)
        out = scan_blocked(fn, flipped, reverse=False)
        return jax.tree_util.tree_map(lambda a: a[::-1], out)
    b, c = _block_shape(n)
    pad = b * c - n

    def prep(a):
        if pad:
            # edge-pad: forward-scan results in [0, n) never read the
            # tail, any value works
            a = jnp.concatenate([a, jnp.broadcast_to(a[-1:], (pad,))])
        return a.reshape(b, c)

    xb = jax.tree_util.tree_map(prep, elems)
    inner = jax.lax.associative_scan(fn, xb, axis=1)
    block_last = jax.tree_util.tree_map(lambda a: a[:, -1], inner)
    block_pref = jax.lax.associative_scan(fn, block_last)
    pref_col = jax.tree_util.tree_map(
        lambda a: jnp.concatenate([a[:1], a[:-1]])[:, None], block_pref)
    combined = fn(pref_col, inner)
    first_block = jnp.arange(b)[:, None] == 0
    out = jax.tree_util.tree_map(
        lambda comb, inn: jnp.where(first_block, inn, comb),
        combined, inner)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(-1)[:n], out)
