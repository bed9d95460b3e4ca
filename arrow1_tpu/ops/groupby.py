"""Hash aggregate (group-by).

Reference: cpp/src/arrow/compute/kernels/hash_aggregate.cc — GrouperImpl
row-serializes keys and feeds an unordered_map to assign dense group ids
(:313-404), then GroupedAggregators scatter-update per-group state
(:466-700), driven by the eager GroupBy loop (:890-966).

Device redesign (SURVEY.md §3.2 translation note):
- key encoding -> uint64 key normalization (shared with sort/unique);
  multi-column keys stay a *list* of keys — no row serialization needed
  because grouping_by_keys composes them lexicographically.
- unordered_map -> sort-based dense group ids (eager path, exact
  first-appearance semantics) or sorted-space segments in fused
  pipelines (ops/padded.py).
- GroupedAggregator::Consume -> one fused segment scatter per aggregate
  (`zeros(num_groups).at[group_ids].add/min/max`), which XLA lowers to a
  single HBM pass.

Aggregate functions follow pyarrow TableGroupBy naming: output columns are
"{column}_{fn}" followed by the key columns.

GROUP-BY FORM MAP (one algorithm family, five entry points — who owns
what, so perf work lands in the right place):

  ops/groupby.py (here)      eager host-sync API; aggregation via
                             _grouped_seg = sorted-space scans. The
                             SEMANTICS owner: every other form is
                             oracle-tested against it.
  exec/compiled.py           jit path, static max_groups capacity; same
  `_op_group_by`             sorted-space scans via ops/padded.py
                             group_sort_padded + seg_*_sorted. The
                             single-chip PERF owner (tpch q1 rides it).
  exec/dist_compiled.py      multi-chip jit path: combine-before-shuffle
  `_op_group_by_partial`     partials (G-scale all_to_all volume), final
                             merge via parallel/distributed._grouped_padded
                             scatters on tiny partial tables.
  parallel/distributed.py    eager multi-chip op (one shard_map per op);
  `dist_group_by`            superseded by dist_compiled for pipelines,
                             kept for single-op use + as its oracle.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column
from ..errors import Invalid
from ..table import RecordBatch
from .aggregate import _sum_output_type
from .hash import grouping_by_keys
from .selection import take_column
from .sort import normalize_sort_key

__all__ = ["group_by", "grouped_aggregate"]


def _segment_count(valid, gids, ngroups):
    ones = jnp.ones(gids.shape[0], jnp.int64) if valid is None else \
        valid.astype(jnp.int64)
    return jnp.zeros(ngroups, jnp.int64).at[gids].add(ones)


def _grouped(col: Column, fn: str, gids, ngroups):
    """One grouped aggregate -> list of (suffix, Column)."""
    t = col.dtype
    valid = col.validity
    vcount = _segment_count(valid, gids, ngroups)

    def masked(fill):
        return col.data if valid is None else jnp.where(valid, col.data, fill)

    if fn == "count":
        return [("count", Column(vcount, dt.int64))]
    if fn == "count_all":
        total = jnp.zeros(ngroups, jnp.int64).at[gids].add(1)
        return [("count_all", Column(total, dt.int64))]

    if fn in ("sum", "mean", "product"):
        out_t = _sum_output_type(t) if fn != "mean" else dt.float64
        acc_dt = out_t.physical_dtype() if fn != "mean" else jnp.float64
        if fn == "product":
            acc = jnp.ones(ngroups, acc_dt).at[gids].multiply(
                masked(1).astype(acc_dt))
        else:
            acc = jnp.zeros(ngroups, acc_dt).at[gids].add(
                masked(0).astype(acc_dt))
        if fn == "mean":
            acc = acc / jnp.maximum(vcount, 1)
        gvalid = vcount > 0  # all-null group -> null (hash_aggregate.cc:590)
        gv = collapse_validity(gvalid)
        return [(fn, Column(acc, out_t, validity=gv))]

    if fn in ("min", "max", "min_max"):
        if t.is_binary:
            rank = jnp.asarray(col.dictionary.rank, jnp.int64)
            x = rank[col.data]
            phys = jnp.int64
            big, small = jnp.int64(np.iinfo(np.int64).max), jnp.int64(-1)
        elif t.is_floating:
            x = col.data
            phys = x.dtype
            big, small = jnp.asarray(jnp.inf, phys), jnp.asarray(-jnp.inf, phys)
        else:
            x = col.data
            phys = x.dtype
            info = np.iinfo(np.dtype(phys))
            big, small = jnp.asarray(info.max, phys), jnp.asarray(info.min, phys)
        if valid is not None:
            xm_min, xm_max = jnp.where(valid, x, big), jnp.where(valid, x, small)
        else:
            xm_min = xm_max = x
        if t.is_floating:
            # nan-ignoring min/max (matching scalar min_max)
            nan = jnp.isnan(x)
            xm_min = jnp.where(nan, big, xm_min)
            xm_max = jnp.where(nan, small, xm_max)
        gmin = jnp.full(ngroups, big, phys).at[gids].min(xm_min)
        gmax = jnp.full(ngroups, small, phys).at[gids].max(xm_max)
        gvalid = vcount > 0
        gv = collapse_validity(gvalid)

        def back(vals):
            if t.is_binary:
                inv = jnp.argsort(jnp.asarray(col.dictionary.rank))
                codes = inv[jnp.clip(vals, 0, max(len(col.dictionary) - 1, 0))]
                return Column(codes.astype(col.data.dtype), t, validity=gv,
                              dictionary=col.dictionary)
            return Column(vals, t, validity=gv)

        if fn == "min":
            return [("min", back(gmin))]
        if fn == "max":
            return [("max", back(gmax))]
        return [("min", back(gmin)), ("max", back(gmax))]

    if fn in ("variance", "stddev"):
        x = masked(0).astype(jnp.float64)
        s1 = jnp.zeros(ngroups, jnp.float64).at[gids].add(x)
        s2 = jnp.zeros(ngroups, jnp.float64).at[gids].add(x * x)
        nvalid = vcount.astype(jnp.float64)
        mean = s1 / jnp.maximum(nvalid, 1)
        var = s2 / jnp.maximum(nvalid, 1) - mean * mean
        var = jnp.maximum(var, 0.0)
        out = jnp.sqrt(var) if fn == "stddev" else var
        gvalid = vcount > 0
        gv = collapse_validity(gvalid)
        return [(fn, Column(out, dt.float64, validity=gv))]

    if fn == "any" or fn == "all":
        if not t.is_boolean:
            raise Invalid(f"hash_{fn}: expects boolean")
        if fn == "any":
            acc = jnp.zeros(ngroups, jnp.bool_).at[gids].max(masked(False))
        else:
            acc = jnp.ones(ngroups, jnp.bool_).at[gids].min(masked(True))
        gvalid = vcount > 0
        gv = collapse_validity(gvalid)
        return [(fn, Column(acc, dt.bool_, validity=gv))]

    if fn == "count_distinct":
        # group by (key, value) pairs then count per key-group
        keys2 = [gids.astype(jnp.uint64)] + normalize_sort_key(col)
        gids2, reps2, ng2 = grouping_by_keys(keys2)
        gid_of_pair = gids[reps2]
        valid_pair = (col.validity[reps2] if col.validity is not None
                      else jnp.ones(ng2, jnp.bool_))
        cnt = jnp.zeros(ngroups, jnp.int64).at[gid_of_pair].add(
            valid_pair.astype(jnp.int64))
        return [("count_distinct", Column(cnt, dt.int64))]

    raise Invalid(f"unsupported grouped aggregate {fn!r}")


def grouped_aggregate(batch: RecordBatch, gids, ngroups,
                      aggregates: Sequence[Tuple[str, str]]) -> List:
    """Run aggregates against precomputed group ids. Returns
    [(out_name, Column)]. Factored out so the distributed path can reuse it
    after a shuffle (parallel/shuffle.py)."""
    out = []
    for col_name, fn in aggregates:
        col = batch.column(col_name)
        for suffix, res in _grouped(col, fn, gids, ngroups):
            out.append((f"{col_name}_{suffix}", res))
    return out


def _register_hash_kernels():
    """Register the reference's kernel-level hash-aggregate entry points
    (reference: hash_aggregate.cc:1039-1062 registers hash_count /
    hash_sum / hash_min_max; the eager GroupBy drives them with
    (values, group_ids, num_groups) batches). Exposed with the same names
    so kernel-level callers can consume precomputed group ids."""
    from ..registry import register_function

    def make(fn_name):
        def exec_fn(args, options, ctx):
            values, gids = args
            ngroups = int(jnp.max(gids.data)) + 1 if gids.length else 0
            results = _grouped(values, fn_name, gids.data.astype(jnp.int32),
                               max(ngroups, 1))
            if len(results) == 1:
                return results[0][1]
            return RecordBatch(tuple(c for _, c in results),
                               tuple(s for s, _ in results))

        return exec_fn

    for name, fn in [("hash_count", "count"), ("hash_sum", "sum"),
                     ("hash_min_max", "min_max"), ("hash_mean", "mean"),
                     ("hash_product", "product"), ("hash_min", "min"),
                     ("hash_max", "max"), ("hash_any", "any"),
                     ("hash_all", "all"),
                     ("hash_count_distinct", "count_distinct")]:
        register_function(name, "hash_aggregate", 2)(make(fn))

    def make_seg(fn_name):
        def exec_fn(args, options, ctx):
            from .hash import grouping_from_ids

            values, gids = args
            ngroups = int(jnp.max(gids.data)) + 1 if gids.length else 0
            g = grouping_from_ids(gids.data.astype(jnp.int32),
                                  max(ngroups, 1))
            results = _grouped_seg(values, fn_name, g)
            if len(results) == 1:
                return results[0][1]
            return RecordBatch(tuple(c for _, c in results),
                               tuple(s for s, _ in results))

        return exec_fn

    for name, fn in [("hash_first", "first"), ("hash_last", "last"),
                     ("hash_one", "one"), ("hash_first_last", "first_last"),
                     ("hash_count_all", "count_all"),
                     ("hash_list", "list"), ("hash_distinct", "distinct"),
                     ("hash_skew", "skew"), ("hash_kurtosis", "kurtosis"),
                     ("hash_variance", "variance"),
                     ("hash_stddev", "stddev"),
                     ("hash_approximate_median", "approximate_median")]:
        register_function(name, "hash_aggregate", 2)(make_seg(fn))


_register_hash_kernels()


def _grouped_seg(col: Column, fn: str, g, sorted_planes=None):
    """Sorted-space grouped aggregate (scan + boundary gathers — no
    scatters). Falls back to the scatter form for
    aggregates without a segment formulation.

    `sorted_planes=(data, validity-or-None)` means the column's planes
    already rode the grouping sort as variadic payloads (grouping_full):
    the per-aggregate `x[g.order]` gather disappears entirely."""
    from .hash import segment_count, segment_minmax, segment_sum

    t = col.dtype
    if sorted_planes is not None:
        sdata, valid = sorted_planes
        srt = True
    else:
        sdata, valid = col.data, col.validity
        srt = False
    svalid_full = (jnp.ones(col.length, jnp.bool_) if valid is None
                   else valid)
    vcount = segment_count(svalid_full, g, sorted_=srt)

    def masked(fill):
        return sdata if valid is None else jnp.where(valid, sdata, fill)

    def gv():
        gvalid = vcount > 0
        return collapse_validity(gvalid)

    if t.is_decimal:
        if fn in ("sum", "mean", "min", "max", "min_max"):
            # limb-exact grouped reductions; the generic single-plane
            # branches below would drop/corrupt the high limb
            return _grouped_seg_decimal(col, fn, g, vcount, gv, srt)
        if fn in ("variance", "stddev", "approximate_median"):
            # float-space statistics over the limb-exact conversion
            from .decimal import decimal_to_float

            col = decimal_to_float(col)
            t = col.dtype
            sorted_planes = None
            sdata, valid = col.data, col.validity
            srt = False
        elif fn not in ("count", "count_all", "first", "last", "one",
                        "first_last", "list", "distinct",
                        "count_distinct"):
            raise Invalid(f"group {fn}: unsupported for decimal inputs")
    if fn == "count":
        return [("count", Column(vcount, dt.int64))]
    if fn == "count_all":
        total = segment_sum(jnp.ones(col.length, jnp.int64), g,
                            jnp.int64, sorted_=srt)
        return [("count_all", Column(total, dt.int64))]
    if fn in ("sum", "mean"):
        out_t = _sum_output_type(t) if fn != "mean" else dt.float64
        acc_dt = out_t.physical_dtype() if fn != "mean" else jnp.float64
        acc = segment_sum(masked(0).astype(acc_dt), g, acc_dt,
                          sorted_=srt)
        if fn == "mean":
            acc = acc / jnp.maximum(vcount, 1)
        return [(fn, Column(acc, out_t, validity=gv()))]
    if fn in ("min", "max", "min_max") and not t.is_binary:
        if t.is_floating:
            x = sdata
            big = jnp.asarray(jnp.inf, x.dtype)
            small = jnp.asarray(-jnp.inf, x.dtype)
            nan = jnp.isnan(x)
            xm_min = jnp.where(nan, big, x)
            xm_max = jnp.where(nan, small, x)
        else:
            x = sdata
            info = np.iinfo(np.dtype(x.dtype))
            big = jnp.asarray(info.max, x.dtype)
            small = jnp.asarray(info.min, x.dtype)
            xm_min = xm_max = x
        if valid is not None:
            xm_min = jnp.where(valid, xm_min, big)
            xm_max = jnp.where(valid, xm_max, small)
        out = []
        if fn in ("min", "min_max"):
            out.append(("min", Column(segment_minmax(xm_min, g, True,
                                                     sorted_=srt), t,
                                      validity=gv())))
        if fn in ("max", "min_max"):
            out.append(("max", Column(segment_minmax(xm_max, g, False,
                                                     sorted_=srt), t,
                                      validity=gv())))
        return out
    if fn in ("variance", "stddev"):
        x = masked(0).astype(jnp.float64)
        s1 = segment_sum(x, g, jnp.float64, sorted_=srt)
        s2 = segment_sum(x * x, g, jnp.float64, sorted_=srt)
        nv = jnp.maximum(vcount.astype(jnp.float64), 1)
        mean = s1 / nv
        var = jnp.maximum(s2 / nv - mean * mean, 0.0)
        out = jnp.sqrt(var) if fn == "stddev" else var
        return [(fn, Column(out, dt.float64, validity=gv()))]
    if fn in ("first", "last", "one", "first_last"):
        # first/last valid row per group = segment min/max of row index
        # over valid rows ("one" = any value: first is fine)
        n = col.length
        rowid = (g.order.astype(jnp.int64) if srt
                 else jnp.arange(n, dtype=jnp.int64))
        out = []
        from .selection import take_column

        def pick(is_first):
            fill = jnp.int64(n) if is_first else jnp.int64(-1)
            x = rowid if valid is None else jnp.where(valid, rowid, fill)
            idx = segment_minmax(x, g, is_first, sorted_=srt)
            got = take_column(col, jnp.clip(idx, 0, max(n - 1, 0)))
            return Column(got.data, t, validity=gv(),
                          dictionary=got.dictionary, data2=got.data2)

        if fn in ("first", "one", "first_last"):
            out.append(("first" if fn != "one" else "one", pick(True)))
        if fn in ("last", "first_last"):
            out.append(("last", pick(False)))
        return out
    if fn in ("skew", "kurtosis"):
        x = masked(0).astype(jnp.float64)
        nv = jnp.maximum(vcount.astype(jnp.float64), 1)
        s1 = segment_sum(x, g, jnp.float64, sorted_=srt)
        s2 = segment_sum(x * x, g, jnp.float64, sorted_=srt)
        s3 = segment_sum(x * x * x, g, jnp.float64, sorted_=srt)
        mean = s1 / nv
        m2 = jnp.maximum(s2 / nv - mean * mean, 0.0)
        if fn == "skew":
            m3 = s3 / nv - 3 * mean * s2 / nv + 2 * mean ** 3
            out = m3 / jnp.maximum(m2, 1e-300) ** 1.5
            need = 2
        else:
            s4 = segment_sum(x ** 4, g, jnp.float64, sorted_=srt)
            m4 = (s4 / nv - 4 * mean * s3 / nv + 6 * mean * mean * s2 / nv
                  - 3 * mean ** 4)
            out = m4 / jnp.maximum(m2 * m2, 1e-300) - 3.0
            need = 2
        gvalid = vcount >= need
        return [(fn, Column(out, dt.float64,
                            validity=collapse_validity(gvalid)))]
    if fn == "approximate_median":
        return [("approximate_median", _grouped_median(col, g))]
    if fn in ("list", "distinct"):
        return [(fn, _grouped_list(col, g, distinct=(fn == "distinct")))]
    # binary min/max, any/all, count_distinct, product: scatter form
    from .hash import group_ids_of

    return _grouped(col, fn, group_ids_of(g), g.num_groups)


def _grouped_seg_decimal(col: Column, fn: str, g, vcount, gv, srt):
    """N-limb decimal grouped reductions (exact; 128 AND 256 bit).

    sum: per-limb 32-bit-half segment sums (each < 2^63 for n < 2^31
    rows), then base-2^32 digit reconstruction with carry propagation —
    exact wide sums with no wide arithmetic inside the scans. min/max:
    lexicographic multi-pass from the sign-flipped top limb down, low
    limbs refined among ties (reference: hash_aggregate.cc:642)."""
    from .decimal256 import limbs256, pack256
    from .hash import group_ids_of, segment_minmax, segment_sum

    t = col.dtype
    if t.kind == "decimal128":
        limbs = [col.data.astype(jnp.uint64),
                 col.data2.astype(jnp.uint64)]
    else:
        limbs = limbs256(col)
    N = len(limbs)
    valid = col.validity

    def pack(out_limbs, out_t):
        if N == 2:
            return Column(out_limbs[0].astype(jnp.int64), out_t,
                          validity=gv(),
                          data2=out_limbs[1].astype(jnp.int64))
        return pack256(out_limbs, out_t, gv())

    if fn in ("sum", "mean"):
        m32 = jnp.uint64(0xFFFFFFFF)
        digits = []   # base-2^32 digit sums, i64, exact
        for li in limbs:
            lm = li if valid is None else \
                jnp.where(valid, li, jnp.uint64(0))
            digits.append(segment_sum(
                (lm & m32).astype(jnp.int64), g, jnp.int64))
            digits.append(segment_sum(
                (lm >> jnp.uint64(32)).astype(jnp.int64), g, jnp.int64))
        carry = jnp.zeros_like(digits[0])
        norm = []
        for d in digits:
            tot = d + carry
            norm.append(tot & 0xFFFFFFFF)
            carry = tot >> 32
        out_limbs = [
            (norm[2 * i].astype(jnp.uint64)
             | (norm[2 * i + 1].astype(jnp.uint64) << jnp.uint64(32)))
            for i in range(N)]
        out_t = (dt.decimal128(38, t.scale) if N == 2
                 else dt.decimal256(76, t.scale))
        if fn == "sum":
            return [("sum", pack(out_limbs, out_t))]
        # mean: exact |sum| / count, round-half-away-from-zero, sign
        # reapplied (matches the pyarrow grouped decimal mean)
        from .decimal256 import _add_ripple as _rip
        from .decimal256 import _neg4 as _n4

        neg = out_limbs[-1].astype(jnp.int64) < 0
        if N == 2:
            sign = (out_limbs[1].astype(jnp.int64)
                    >> jnp.int64(63)).astype(jnp.uint64)
            limbs4 = [out_limbs[0], out_limbs[1], sign, sign]
        else:
            limbs4 = list(out_limbs)
        mag = _n4(limbs4)
        mag = [jnp.where(neg, m, o) for m, o in zip(mag, limbs4)]
        cnt = jnp.maximum(vcount, 1).astype(jnp.uint64)
        czero = jnp.zeros_like(cnt)
        from .decimal256 import _div4, _mul4

        divisor = [cnt, czero, czero, czero]
        q = _div4(mag, divisor)
        prod = _mul4(q, divisor)
        # remainder = mag - q*cnt  (< cnt <= 2^63: lives in limb 0)
        rem = mag[0] - prod[0]
        inc = ((rem << jnp.uint64(1)) >= cnt) & (rem != 0) | (
            (rem << jnp.uint64(1)) == cnt)
        qi = list(q)
        _rip(qi, 0, inc.astype(jnp.uint64))
        qs = _n4(qi)
        qs = [jnp.where(neg, a, b) for a, b in zip(qs, qi)]
        if N == 2:
            mean_col = Column(qs[0].astype(jnp.int64), out_t,
                              validity=gv(),
                              data2=qs[1].astype(jnp.int64))
        else:
            mean_col = pack(qs, out_t)
        return [("mean", mean_col)]

    flip = jnp.uint64(1) << jnp.uint64(63)
    maxu = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    gids = group_ids_of(g).astype(jnp.int64)
    norm_limbs = limbs[:-1] + [limbs[-1] ^ flip]
    out = []

    def extreme(is_min):
        bound = maxu if is_min else jnp.uint64(0)
        tie = (jnp.ones(col.length, jnp.bool_) if valid is None
               else valid)
        ext = [None] * N
        for i in range(N - 1, -1, -1):
            x = jnp.where(tie, norm_limbs[i], bound)
            ext[i] = segment_minmax(x, g, is_min)
            tie = tie & (norm_limbs[i] == ext[i][gids])
        ext[-1] = ext[-1] ^ flip
        return pack(ext, t)

    if fn in ("min", "min_max"):
        out.append(("min", extreme(True)))
    if fn in ("max", "min_max"):
        out.append(("max", extreme(False)))
    return out


def _grouped_median(col: Column, g):
    """Exact per-group median (the reference's approximate_median is
    t-digest backed; exact is within the approximation contract)."""
    from .hash import group_ids_of
    from .sort import normalize_sort_key, sort_indices_device

    n = col.length
    gids0 = group_ids_of(g)
    ord2 = sort_indices_device(
        [gids0.astype(jnp.int64)] + normalize_sort_key(col))
    gid2 = gids0[ord2]
    # valid rows sort before nulls within a group (null class key), so
    # the valid prefix of each segment is contiguous
    bounds = jnp.searchsorted(gid2, jnp.arange(g.num_groups + 1))
    vcount = segment_count(col.mask(), g) if False else None
    from .hash import segment_count as _sc

    nv = _sc(col.mask(), g)
    data2 = col.data[ord2].astype(jnp.float64)
    lo_b = bounds[:-1]
    mid_pos = lo_b.astype(jnp.float64) + (nv.astype(jnp.float64) - 1) / 2.0
    lo_i = jnp.clip(jnp.floor(mid_pos).astype(jnp.int64), 0, max(n - 1, 0))
    hi_i = jnp.clip(jnp.ceil(mid_pos).astype(jnp.int64), 0, max(n - 1, 0))
    med = (data2[lo_i] + data2[hi_i]) / 2.0
    gvalid = nv > 0
    return Column(med, dt.float64,
                  validity=collapse_validity(gvalid))


def _grouped_list(col: Column, g, distinct: bool):
    """Per-group value lists (reference: hash_list / hash_distinct) as a
    ListColumn: rows regrouped into appearance-ordered segments."""
    from ..column import ListColumn
    from .selection import take_column
    from .sort import normalize_sort_key, sort_indices_device

    from .hash import group_ids_of

    n = col.length
    gids = group_ids_of(g).astype(jnp.int64)
    if distinct:
        # dedupe (group, value) in value order, then restore appearance
        # order within each group
        ord2 = sort_indices_device([gids] + normalize_sort_key(col))
        gid2 = gids[ord2]
        first2 = jnp.ones(n, jnp.bool_)
        if n > 1:
            same = gid2[1:] == gid2[:-1]
            for k in normalize_sort_key(col):
                ks = k[ord2]
                same = same & (ks[1:] == ks[:-1])
            first2 = first2.at[1:].set(~same)
        keep = first2 & col.mask()[ord2]
        rows_kept = ord2[jnp.where(keep)[0]]
        ord3 = sort_indices_device([gids[rows_kept], rows_kept])
        rows_final = rows_kept[ord3]
    else:
        rows_final = sort_indices_device(
            [gids, jnp.arange(n, dtype=jnp.int64)])
    gid_final = gids[rows_final]
    offsets = jnp.searchsorted(
        gid_final, jnp.arange(g.num_groups + 1)).astype(jnp.int64)
    child = take_column(col, rows_final)
    return ListColumn(offsets, child, dt.list_(col.dtype))


def group_by(batch: RecordBatch, keys: Sequence[str],
             aggregates: Sequence[Tuple[str, str]]) -> RecordBatch:
    """Eager group-by (reference: internal::GroupBy hash_aggregate.cc:890;
    API shape: pyarrow TableGroupBy.aggregate).

    Output: aggregate columns named "{col}_{fn}", then key columns, groups
    in first-appearance order (GrouperImpl insertion order semantics).
    Aggregation runs in sorted space (scan + boundary gathers) — see
    _grouped_seg.
    """
    from .hash import grouping_full

    if not keys:
        raise Invalid("group_by requires at least one key")
    norm: List = []
    for k in keys:
        norm.extend(normalize_sort_key(batch.column(k)))
    # flat aggregate inputs ride the grouping sort as variadic payloads:
    # zero per-aggregate gathers (hash.grouping_full docstring)
    plain = []
    for col_name, _ in aggregates:
        c = batch.column(col_name)
        if (col_name not in plain and isinstance(c, Column)
                and c.data2 is None and c.dictionary is None):
            plain.append(col_name)
    payloads = []
    for col_name in plain:
        c = batch.column(col_name)
        payloads.append(c.data)
        if c.validity is not None:
            payloads.append(c.validity)
    g, sorted_payloads = grouping_full(norm, tuple(payloads))
    planes = {}
    i = 0
    for col_name in plain:
        c = batch.column(col_name)
        data_s = sorted_payloads[i]
        i += 1
        valid_s = None
        if c.validity is not None:
            valid_s = sorted_payloads[i]
            i += 1
        planes[col_name] = (data_s, valid_s)
    cols, names = [], []
    for col_name, fn in aggregates:
        col = batch.column(col_name)
        for suffix, res in _grouped_seg(col, fn, g,
                                        sorted_planes=planes.get(col_name)):
            names.append(f"{col_name}_{suffix}")
            cols.append(res)
    for k in keys:
        names.append(k)
        cols.append(take_column(batch.column(k), g.rep_rows))
    return RecordBatch(tuple(cols), tuple(names))


from ..registry import register_function


@dataclasses.dataclass
class PivotWiderOptions:
    key_names: tuple = ()
    unexpected_key_behavior: str = "ignore"


def _pivot_pairs(keys_col: Column, values_col: Column, key_names,
                 gids, ngroups):
    """One output column per key name: value where keys==name, per group
    (at most one non-null per (group, key) — reference pivot semantics)."""
    out = []
    for name in key_names:
        if keys_col.dictionary is None:
            raise Invalid("pivot_wider: keys must be strings")
        code = keys_col.dictionary.index.get(name, -1)
        hit = (keys_col.data == code) & keys_col.mask() & values_col.mask()
        dup = jnp.zeros(ngroups, jnp.int32).at[gids].add(
            hit.astype(jnp.int32))
        if bool(jnp.any(dup > 1)):
            raise Invalid("Encountered more than one non-null value for "
                          "the same pivot key")
        safe = jnp.where(hit, gids, ngroups)
        data = jnp.zeros(ngroups, values_col.data.dtype).at[safe].set(
            values_col.data, mode="drop")
        filled = dup > 0
        out.append((name, Column(
            data, values_col.dtype,
            validity=collapse_validity(filled),
            dictionary=values_col.dictionary)))
    return out


def _pivot_wider_exec(args, options: PivotWiderOptions, ctx):
    keys_col, values_col = args
    if options is None or not options.key_names:
        raise Invalid("pivot_wider requires key_names")
    gids = jnp.zeros(keys_col.length, jnp.int32)
    cols = _pivot_pairs(keys_col, values_col, options.key_names, gids, 1)
    return RecordBatch(tuple(c for _, c in cols),
                       tuple(n for n, _ in cols))


register_function("pivot_wider", "scalar", 2, PivotWiderOptions)(
    _pivot_wider_exec)


def _hash_pivot_wider_exec(args, options: PivotWiderOptions, ctx):
    keys_col, values_col, gids = args
    if options is None or not options.key_names:
        raise Invalid("hash_pivot_wider requires key_names")
    ngroups = int(jnp.max(gids.data)) + 1 if gids.length else 0
    cols = _pivot_pairs(keys_col, values_col, options.key_names,
                        gids.data.astype(jnp.int32), max(ngroups, 1))
    return RecordBatch(tuple(c for _, c in cols),
                       tuple(n for n, _ in cols))


register_function("hash_pivot_wider", "hash_aggregate", 3,
                  PivotWiderOptions)(_hash_pivot_wider_exec)


@dataclasses.dataclass
class TDigestOptions:
    q: tuple = (0.5,)
    delta: int = 100
    buffer_size: int = 500
    skip_nulls: bool = True
    min_count: int = 0


def _hash_tdigest_exec(args, options: TDigestOptions, ctx):
    """Per-group quantiles as a list column (reference: hash_tdigest —
    t-digest approximate; exact per-group quantiles here)."""
    from ..column import ListColumn
    from .hash import grouping_from_ids
    from .sort import normalize_sort_key, sort_indices_device

    values, gids = args
    options = options or TDigestOptions()
    qs = list(options.q) if not isinstance(options.q, float) else [options.q]
    ngroups = int(jnp.max(gids.data)) + 1 if gids.length else 0
    ngroups = max(ngroups, 1)
    g = grouping_from_ids(gids.data.astype(jnp.int32), ngroups)
    gl = gids.data.astype(jnp.int64)
    ord2 = sort_indices_device([gl] + normalize_sort_key(values))
    gid2 = gl[ord2]
    bounds = jnp.searchsorted(gid2, jnp.arange(ngroups + 1))
    from .hash import segment_count

    nv = segment_count(values.mask(), g)
    data2 = values.data[ord2].astype(jnp.float64)
    outs = []
    n = values.length
    for q in qs:
        pos = bounds[:-1].astype(jnp.float64) + \
            (nv.astype(jnp.float64) - 1) * q
        lo_i = jnp.clip(jnp.floor(pos).astype(jnp.int64), 0, max(n - 1, 0))
        hi_i = jnp.clip(jnp.ceil(pos).astype(jnp.int64), 0, max(n - 1, 0))
        frac = pos - jnp.floor(pos)
        outs.append(data2[lo_i] * (1 - frac) + data2[hi_i] * frac)
    child = jnp.stack(outs, axis=1).reshape(-1)  # [G, Q] row-major
    offsets = jnp.arange(ngroups + 1, dtype=jnp.int64) * len(qs)
    return ListColumn(offsets, Column(child, dt.float64),
                      dt.list_(dt.float64))


register_function("hash_tdigest", "hash_aggregate", 2, TDigestOptions)(
    _hash_tdigest_exec)
