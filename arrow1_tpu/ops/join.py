"""Equi-join kernels: inner / left outer / right outer / full outer /
left semi / left anti.

Designed from spec — the reference tree has NO hash join (SURVEY.md
"era-critical facts": pre-Acero; only the hash-infrastructure primitives
exist). Semantics follow SQL / the later Acero HashJoinNode, validated
against pyarrow Table.join as oracle: null keys match nothing; every
probe-side match pair is emitted; outer variants emit unmatched rows with
nulls on the other side.

Device design:
1. Multi-column keys collapse to one dense id per row by grouping the
   *union* of both sides' key columns (grouping_by_keys) — id equality ==
   full key equality, so the join core only ever sees one uint64 key.
   This replaces the reference Grouper's row-serialized key encoding
   (hash_aggregate.cc:97-311) with a sort, keeping everything fixed-width.
2. Sort the build side by key id; probe with two binary searches
   (searchsorted left/right) -> per-probe match ranges. All vector ops.
3. Two-phase sizing (host-sync of the total match count, like filter),
   then expansion: repeat probe rows by match count, pick the k-th build
   row within each range. Build rows within a key are emitted in build
   order (stable argsort), making output deterministic:
   probe-major, build-minor.

Single-column non-float keys skip step 1 entirely: the raw u64 key
normalization feeds the bucketed hash table (kernels/hashtable.py) —
one build-side sort + a gather-probe, no union grouping. A1T_JOIN=ids
forces the dense-id sort-merge path (the semantics reference).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column
from ..errors import Invalid
from ..table import RecordBatch
from .hash import grouping_by_keys
from .selection import take_column
from .sort import normalize_sort_key

__all__ = ["join", "join_indices"]

_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti", "right semi", "right anti")


def _key_ids(left: RecordBatch, right: RecordBatch,
             left_keys: Sequence[str], right_keys: Sequence[str],
             allow_raw: bool = False):
    """Join keys for both sides + per-side key validity.

    Returns (lkeys, rkeys, lvalid, rvalid, raw). When `allow_raw` and the
    key is a single non-float, non-decimal column, the keys are the raw
    order-preserving u64 normalization (`raw=True`) — no union grouping
    sort at all; equality on the u64s == key equality, and nullness is
    carried solely by the validity masks. Otherwise dense int ids from
    grouping the union (`raw=False`)."""
    if len(left_keys) != len(right_keys):
        raise Invalid("join: key count mismatch")
    keys: List[jnp.ndarray] = []
    n_float = 0
    for lk, rk in zip(left_keys, right_keys):
        lc, rc = left.column(lk), right.column(rk)
        if lc.dtype.is_binary != rc.dtype.is_binary:
            raise Invalid(f"join: key type mismatch {lc.dtype} vs {rc.dtype}")
        if lc.dtype.is_binary:
            from .dictionary import unify_dictionaries

            if lc.dictionary is not rc.dictionary:
                merged, d = unify_dictionaries([lc, rc])
                lc = Column(merged[: lc.length], lc.dtype,
                            validity=lc.validity, dictionary=d)
                rc = Column(merged[lc.length:], rc.dtype,
                            validity=rc.validity, dictionary=d)
        if lc.dtype.is_floating:
            n_float += 1
        lkeys = normalize_sort_key(lc)
        rkeys = normalize_sort_key(rc)
        # concatenate per-component (class/value structure matches when both
        # sides carry the same components; the side missing the null/NaN
        # class component — 1-vs-2 for scalar keys, 2-vs-3 for two-limb
        # decimal keys — gets an all-zeros class prepended)
        if len(lkeys) != len(rkeys):
            if len(lkeys) < len(rkeys):
                lkeys = [jnp.zeros(lc.length, jnp.uint8)] + lkeys
            else:
                rkeys = [jnp.zeros(rc.length, jnp.uint8)] + rkeys
        assert len(lkeys) == len(rkeys)
        keys.extend(jnp.concatenate([l, r]) for l, r in zip(lkeys, rkeys))
    n = left.num_rows

    def key_valid(batch, names):
        v = None
        for k in names:
            c = batch.column(k)
            if c.validity is not None:
                v = c.validity if v is None else (v & c.validity)
        return v

    lvalid = key_valid(left, left_keys)
    rvalid = key_valid(right, right_keys)

    # raw fast path: one key column, no NaN class to encode (non-float,
    # non-decimal ⇒ components are [value] or [null-class, value], and
    # the null class duplicates the validity masks)
    if (allow_raw and len(left_keys) == 1 and n_float == 0
            and not left.column(left_keys[0]).dtype.is_decimal
            and len(keys) <= 2 and keys[-1].dtype == jnp.uint64
            and (len(keys) == 1 or keys[0].dtype == jnp.uint8)):
        u = keys[-1]
        return u[:n], u[n:], lvalid, rvalid, True

    gids, _, _ = grouping_by_keys(keys)
    return gids[:n], gids[n:], lvalid, rvalid, False


def _hash_probe_ranges(probe_u64, build_u64, build_valid):
    """(build_order, lo, counts) via the bucketed hash table
    (kernels/hashtable.py) on raw u64 keys — build-side sort only, no
    union grouping. Host-syncs the overflow flag and grows the table
    like hashing.h:239's load-factor doubling."""
    from ..kernels.hashtable import (join_build, join_build_packed,
                                     join_probe, pack_table,
                                     probe_packed, table_bits_for)

    bits = table_bits_for(build_u64.shape[0])
    if build_valid is None:
        # flat PackedTable build (kernels/hashtable.py) + single-gather
        # probe in <=4M-row chunks (the windowed-gather temp is
        # [chunk, 4*ways])
        while True:
            order, pt, ovf = join_build_packed(build_u64, bits=bits)
            if int(ovf) == 0:
                break
            if bits >= 28:
                raise Invalid("join: hash table overflow at maximum "
                              "size")
            bits += 1
        import os

        n = probe_u64.shape[0]
        CH = int(os.environ.get("A1T_JOIN_PROBE_CHUNK", 4_000_000))
        if n <= CH:
            lo, counts = probe_packed(pt, probe_u64)
        else:
            los, cnts = [], []
            for i in range(0, n, CH):
                lo_i, c_i = probe_packed(pt, probe_u64[i:i + CH])
                los.append(lo_i)
                cnts.append(c_i)
            lo = jnp.concatenate(los)
            counts = jnp.concatenate(cnts)
        return order, lo.astype(jnp.int64), counts.astype(jnp.int32)
    while True:
        order, table = join_build(build_u64, bits=bits, live=build_valid)
        if int(table.overflow) == 0:
            break
        if bits >= 28:
            raise Invalid("join: hash table overflow at maximum size")
        bits += 1
    lo, counts = join_probe(table, probe_u64, packed=pack_table(table))
    return order, lo.astype(jnp.int64), counts


def _hash_matched(test_u64, table_u64, table_valid):
    """bool[n]: does each test key match >=1 valid table key."""
    from ..kernels.hashtable import join_build, join_probe, table_bits_for

    bits = table_bits_for(table_u64.shape[0])
    while True:
        _, table = join_build(table_u64, bits=bits, live=table_valid)
        if int(table.overflow) == 0:
            break
        if bits >= 28:
            raise Invalid("join: hash table overflow at maximum size")
        bits += 1
    _, counts = join_probe(table, test_u64)
    return counts > 0


def _join_mode() -> str:
    import os

    return os.environ.get("A1T_JOIN", "auto")


def join_indices(left: RecordBatch, right: RecordBatch,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 join_type: str = "inner"):
    """Compute (left_idx, right_idx, left_valid, right_valid) row-index
    arrays describing the join result. Separated from column materialization
    so the distributed path can shuffle indices instead of data."""
    if join_type not in _JOIN_TYPES:
        raise Invalid(f"unsupported join type {join_type!r}")
    lids, rids, lvalid, rvalid, raw = _key_ids(
        left, right, left_keys, right_keys,
        allow_raw=_join_mode() != "ids")
    nl, nr = left.num_rows, right.num_rows

    from .padded import probe_ranges_sortmerge

    if raw:
        # single-column key: raw u64 equality + bucketed hash table —
        # one build-side sort, gather-probe; null build keys excluded
        # via liveness (never sentinel-painted)
        build_order, lo, counts = _hash_probe_ranges(lids, rids, rvalid)
    else:
        # build side = right, sorted by key id (stable -> build-order
        # within key); probe ranges via merged sort-merge (no
        # searchsorted binary-search gathers)
        if rvalid is not None:
            # null-key build rows can never match: paint with an id no
            # probe has (ids are dense int32 — the paint cannot collide)
            rids = jnp.where(rvalid, rids, jnp.iinfo(jnp.int32).max)
        build_order, lo, counts = probe_ranges_sortmerge(
            lids.astype(jnp.int64), rids.astype(jnp.int64))
    counts = counts.astype(jnp.int32)
    if lvalid is not None:
        counts = jnp.where(lvalid, counts, 0)  # null probe keys match nothing
    matched = counts > 0

    if join_type in ("left semi", "left anti"):
        mask = matched if join_type == "left semi" else ~matched
        sel = int(jnp.sum(mask))
        (idx,) = jnp.nonzero(mask, size=sel, fill_value=0)
        return idx.astype(jnp.int64), None, None, None
    if join_type in ("right semi", "right anti"):
        # which build rows have >=1 probe match
        if raw:
            rmatched = _hash_matched(rids, lids, lvalid)
        else:
            if lvalid is not None:
                lids = jnp.where(lvalid, lids, jnp.iinfo(jnp.int32).min)
            probe_sorted = jnp.sort(lids)
            plo = jnp.searchsorted(probe_sorted, rids, side="left")
            phi = jnp.searchsorted(probe_sorted, rids, side="right")
            rmatched = (phi - plo) > 0
        if rvalid is not None:
            rmatched = rmatched & rvalid
        mask = rmatched if join_type == "right semi" else ~rmatched
        sel = int(jnp.sum(mask))
        (idx,) = jnp.nonzero(mask, size=sel, fill_value=0)
        return None, idx.astype(jnp.int64), None, None

    outer_left = join_type in ("left outer", "full outer")
    emit = jnp.maximum(counts, 1) if outer_left else counts
    total = int(jnp.sum(emit))

    # expansion: probe row repeated emit[i] times
    left_idx = jnp.repeat(jnp.arange(nl), emit, total_repeat_length=total)
    offsets = cumsum_blocked(emit) - emit
    within = jnp.arange(total) - offsets[left_idx]
    has_match = matched[left_idx] if nl else jnp.zeros(0, jnp.bool_)
    pos = lo[left_idx] + jnp.minimum(within, jnp.maximum(counts[left_idx] - 1, 0))
    right_idx = build_order[jnp.clip(pos, 0, max(nr - 1, 0))]
    right_valid = has_match if outer_left else None

    if join_type == "full outer":
        # append unmatched build rows
        if raw:
            rmatched = _hash_matched(rids, lids, lvalid)
        else:
            if lvalid is not None:
                lids_eff = jnp.where(lvalid, lids, jnp.iinfo(jnp.int32).min)
            else:
                lids_eff = lids
            probe_sorted = jnp.sort(lids_eff)
            plo = jnp.searchsorted(probe_sorted, rids, side="left")
            phi = jnp.searchsorted(probe_sorted, rids, side="right")
            rmatched = (phi - plo) > 0
        if rvalid is not None:
            rmatched = rmatched & rvalid
        n_un = int(jnp.sum(~rmatched))
        (un,) = jnp.nonzero(~rmatched, size=n_un, fill_value=0)
        left_idx = jnp.concatenate([left_idx, jnp.zeros(n_un, left_idx.dtype)])
        right_idx = jnp.concatenate([right_idx, un])
        left_valid = jnp.concatenate(
            [jnp.ones(total, jnp.bool_), jnp.zeros(n_un, jnp.bool_)])
        right_valid = jnp.concatenate(
            [right_valid, jnp.ones(n_un, jnp.bool_)])
        return left_idx.astype(jnp.int64), right_idx.astype(jnp.int64), \
            left_valid, right_valid

    return left_idx.astype(jnp.int64), right_idx.astype(jnp.int64), \
        None, right_valid


def join(left: RecordBatch, right: RecordBatch, keys,
         right_keys=None, join_type: str = "inner",
         left_suffix: str = "", right_suffix: str = "") -> RecordBatch:
    """Materialized equi-join (API shape: pyarrow Table.join).

    Output columns: join keys (coalesced for outer joins), then left
    non-key columns, then right non-key columns. Row order: probe
    (left) order, matches in build (right) order — deterministic, unlike
    Acero's thread-dependent order.
    """
    # accept Table inputs like pyarrow.Table.join (chunked columns
    # collapse to one device batch first); a foreign object (e.g. a raw
    # pyarrow.Table, whose combine_chunks() returns another
    # pyarrow.Table) gets a clear TypeError instead of failing later
    from ..table import Table as _Table

    def _as_batch(side, which):
        if isinstance(side, RecordBatch):
            return side
        if isinstance(side, _Table):
            return side.combine_chunks()
        raise TypeError(
            f"join: {which} must be an arrow1_tpu RecordBatch or Table, "
            f"got {type(side).__name__} (wrap foreign tables with "
            f"arrow1_tpu.table / arrow1_tpu.record_batch first)")

    left = _as_batch(left, "left")
    right = _as_batch(right, "right")
    if isinstance(keys, str):
        keys = [keys]
    right_keys = list(right_keys or keys)
    keys = list(keys)
    if join_type == "right outer":
        # probe with the right side (left outer, sides swapped), then emit
        # columns in the canonical order with keys taken from the right
        flipped = join(right, left, right_keys, keys, "left outer",
                       right_suffix, left_suffix)
        names = list(keys)
        cols = [flipped.column(rk) for rk in right_keys]
        for n in left.names:
            if n not in set(keys):
                names.append(n + left_suffix)
                cols.append(flipped.column(n + left_suffix))
        for n in right.names:
            if n not in set(right_keys):
                names.append(n + right_suffix)
                cols.append(flipped.column(n + right_suffix))
        return RecordBatch(tuple(cols), tuple(names))
    li, ri, lv, rv = join_indices(left, right, keys, right_keys, join_type)

    from .selection import gather_batch_packed

    if join_type in ("left semi", "left anti"):
        return gather_batch_packed(left, li)
    if join_type in ("right semi", "right anti"):
        return gather_batch_packed(right, ri)

    cols, names = [], []
    lkeyset, rkeyset = set(keys), set(right_keys)
    # key columns: from left, coalesced with right for full outer
    for lk, rk in zip(keys, right_keys):
        kcol = take_column(left.column(lk), li, lv)
        if join_type == "full outer":
            rcol = take_column(right.column(rk), ri, rv)
            from .validity import _fill_null_exec

            if kcol.dictionary is not None and \
                    kcol.dictionary is not rcol.dictionary:
                from .dictionary import unify_dictionaries

                merged, d = unify_dictionaries([kcol, rcol])
                kcol = Column(merged[: kcol.length], kcol.dtype,
                              validity=kcol.validity, dictionary=d)
                rcol = Column(merged[kcol.length:], rcol.dtype,
                              validity=rcol.validity, dictionary=d)
            data = jnp.where(kcol.mask(), kcol.data, rcol.data)
            data2 = None
            if kcol.data2 is not None:
                # decimal128: coalesce the high limb alongside the low
                data2 = jnp.where(kcol.mask(), kcol.data2, rcol.data2)
            validity = kcol.mask() | rcol.mask()
            # a key slot may still be genuinely null (null key in an
            # unmatched row) — validity reflects that correctly
            kcol = Column(data, kcol.dtype,
                          validity=collapse_validity(validity),
                          dictionary=kcol.dictionary, data2=data2)
        names.append(lk)
        cols.append(kcol)
    # payload materialization: ONE packed row gather per side (measured:
    # a row gather moves W words per index for the price of one)
    lpay = [(n, c) for n, c in zip(left.names, left.columns)
            if n not in lkeyset]
    rpay = [(n, c) for n, c in zip(right.names, right.columns)
            if n not in rkeyset]
    if lpay:
        sub = gather_batch_packed(
            RecordBatch(tuple(c for _, c in lpay),
                        tuple(n for n, _ in lpay)), li, lv)
        for (n, _), c in zip(lpay, sub.columns):
            names.append(n + left_suffix)
            cols.append(c)
    if rpay:
        sub = gather_batch_packed(
            RecordBatch(tuple(c for _, c in rpay),
                        tuple(n for n, _ in rpay)), ri, rv)
        for (n, _), c in zip(rpay, sub.columns):
            names.append(n + right_suffix)
            cols.append(c)
    return RecordBatch(tuple(cols), tuple(names))


def join_asof(left: RecordBatch, right: RecordBatch, on: str,
              by=None, tolerance: int = 0) -> RecordBatch:
    """As-of join (API shape: pyarrow Table.join_asof).

    tolerance <= 0: for each left row, the *latest* right row with
    on_r in [on_l + tolerance, on_l] (backward). tolerance > 0: the
    *earliest* right row with on_r in [on_l, on_l + tolerance] (forward
    — implemented as the backward join on negated `on`). Ties at equal
    `on` match. All left rows are kept; unmatched rows get nulls.

    Device shape: one merged stable sort by (by-ids, on) with right rows
    preceding left at equal keys, then a running-max carry of right
    positions — no per-row search loops (reference designed-from-spec:
    Acero's asof_join node).
    """
    by = [by] if isinstance(by, str) else list(by or [])
    n, m = left.num_rows, right.num_rows
    lon = left.column(on).data.astype(jnp.int64)
    ron = right.column(on).data.astype(jnp.int64)
    if tolerance > 0:
        lon, ron = -lon, -ron
        window = jnp.int64(tolerance)
    else:
        window = jnp.int64(-tolerance)
    if by:
        lids, rids, _, _, _ = _key_ids(left, right, by, by)
    else:
        lids = jnp.zeros(n, jnp.int32)
        rids = jnp.zeros(m, jnp.int32)
    # merged order: right rows first so an equal (by, on) right row is
    # visible to the left row that follows it in the stable sort
    gid = jnp.concatenate([rids, lids]).astype(jnp.uint64)
    onv = jnp.concatenate([ron, lon]).astype(jnp.uint64) ^ \
        jnp.uint64(1 << 63)
    from .sort import sort_indices_device

    sort_keys = [gid, onv]
    if tolerance > 0:
        # forward joins take the *earliest* duplicate right row at equal
        # (by, on) — reverse right-row order among ties (left rows keep a
        # high constant so rights still sort before them at equal keys)
        key3 = jnp.concatenate([
            jnp.arange(m - 1, -1, -1, dtype=jnp.uint64),
            jnp.full(n, jnp.uint64(1) << 40, jnp.uint64)])
        sort_keys.append(key3)
    order = sort_indices_device(sort_keys)
    is_right = order < m
    pos = jnp.arange(n + m)
    carry = scan_blocked(
        jnp.maximum, jnp.where(is_right, pos, -1))
    # validity of the carried right row for each sorted slot
    g_sorted = gid[order]
    on_sorted = jnp.concatenate([ron, lon])[order]
    safe_carry = jnp.clip(carry, 0, n + m - 1)
    carried_g = g_sorted[safe_carry]
    carried_on = on_sorted[safe_carry]
    ok = (carry >= 0) & (carried_g == g_sorted) & \
        ((on_sorted - carried_on) <= window)
    carried_row = order[safe_carry]  # right row id (< m) where ok
    # gather per-left-row results back to row order
    inv = jnp.argsort(order, stable=True)
    lslot = inv[m:]
    match = jnp.where(ok[lslot], carried_row[lslot], m)
    has = match < m
    safe = jnp.clip(match, 0, max(m - 1, 0))

    cols, names = list(left.columns), list(left.names)
    skip = set(by) | {on}
    for cn in right.names:
        if cn in skip:
            continue
        got = take_column(right.column(cn), safe)
        v = got.mask() & has
        cols.append(Column(got.data, got.dtype,
                           validity=collapse_validity(v),
                           dictionary=got.dictionary, data2=got.data2))
        names.append(cn)
    return RecordBatch(tuple(cols), tuple(names))
