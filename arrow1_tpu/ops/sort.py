"""Sort kernels: array_sort_indices / sort_indices / partition_nth_indices.

Reference: cpp/src/arrow/compute/kernels/vector_sort.cc. The reference uses
std::stable_sort with a counting-sort fast path (:408,484) and per-column
recursion for multi-key (:955); comparator-based sorting is hostile to a
data-parallel device (data-dependent branches), so the redesign is:

1. *Key normalization*: every sortable type maps to order-preserving
   uint64 "radix keys": sign-bit flip for signed ints, the IEEE-754
   total-order trick for floats, host rank tables for dict-strings.
   Ordering semantics (stable; nulls last; NaN after values, before null —
   vector_sort.cc:1556-1563) are exact over the full 64-bit domain: when a
   column can contain NaN or null, a separate *class key*
   (value=0 < NaN=1 < null=2) precedes the value key, so no value bits are
   sacrificed for sentinels. Descending inverts the value key only — class
   placement (nulls at end) is order-independent, matching the reference's
   null_placement=AtEnd default.
2. *Stable argsort* per key (XLA's parallel sort).
3. *Lexicographic composition*: LSD passes — stable-argsort the least
   significant key first, re-permute by each more significant key in turn;
   stability composes the multi-key order (replacing the reference's
   MultipleKeyComparator, vector_sort.cc:1050).

These XLA forms are the semantics reference. The sort entry points ride
kernels/radix.py: minimal-width key normalization + uint64 word packing
(fewest sort passes; value-sort with embedded row id when bits fit) —
the radix idea kept as key bits, not as scatter passes (see
kernels/radix.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["SortOptions", "ArraySortOptions", "PartitionNthOptions",
           "normalize_sort_key", "sort_indices_device"]

SIGN64 = np.uint64(0x8000000000000000)  # np: no backend init at import


@dataclasses.dataclass
class ArraySortOptions:
    """Reference: api_vector.h:85."""

    order: str = "ascending"


@dataclasses.dataclass
class SortOptions:
    """Reference: api_vector.h:99 (SortKey list)."""

    sort_keys: Sequence[Tuple[str, str]] = ()


@dataclasses.dataclass
class PartitionNthOptions:
    """Reference: api_vector.h:112."""

    pivot: int = 0


def _float_orderable_bits(x) -> jnp.ndarray:
    """IEEE-754 -> total-order uint64 (ascending); NaN handled via class key."""
    width = np.dtype(x.dtype).itemsize
    if width == 8:
        # f64->u64 through two u32 halves rather than one direct
        # bitcast (the form the engine's first target could lower)
        halves = jax.lax.bitcast_convert_type(x, jnp.uint32)
        bits = (halves[..., 1].astype(jnp.uint64) << jnp.uint64(32)) | \
            halves[..., 0].astype(jnp.uint64)
        sign = jnp.uint64(0x8000000000000000)
        shift = 0
    else:
        if width == 2:
            x = x.astype(jnp.float32)
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        sign = jnp.uint32(0x80000000)
        shift = 32
    flipped = jnp.where((bits & sign) != 0, ~bits, bits | sign)
    return flipped.astype(jnp.uint64) << shift


def normalize_sort_key(col: Column, order: str = "ascending") -> List[jnp.ndarray]:
    """Map a column to 1-2 uint keys, most-significant first, whose
    lexicographic unsigned order == the required row order."""
    t = col.dtype
    has_nan = False
    if t.is_binary:
        assert col.dictionary is not None
        if len(col.dictionary):
            rank = jnp.asarray(col.dictionary.rank, dtype=jnp.uint64)
            key = rank[jnp.clip(col.data, 0, len(col.dictionary) - 1)]
        else:
            key = jnp.zeros_like(col.data, dtype=jnp.uint64)
    elif t.is_floating:
        key = _float_orderable_bits(col.data)
        has_nan = True
    elif t.is_unsigned_integer or t.is_boolean:
        key = col.data.astype(jnp.uint64)
    elif t.is_signed_integer or t.is_temporal:
        key = col.data.astype(jnp.int64).astype(jnp.uint64) ^ SIGN64
    elif t.is_decimal:
        # multi-limb two's-complement order: sign-flipped top limb, then
        # lower limbs as plain unsigned, most-significant first
        if t.kind == "decimal256":
            top = col.data2[:, 2].astype(jnp.int64).astype(
                jnp.uint64) ^ SIGN64
            limbs = [top,
                     col.data2[:, 1].astype(jnp.uint64),
                     col.data2[:, 0].astype(jnp.uint64),
                     col.data.astype(jnp.uint64)]
        else:
            limbs = [col.data2.astype(jnp.int64).astype(jnp.uint64)
                     ^ SIGN64,
                     col.data.astype(jnp.uint64)]
        if order == "descending":
            limbs = [~x for x in limbs]
        elif order != "ascending":
            raise Invalid(f"bad sort order {order!r}")
        if col.validity is None:
            return limbs
        cls = jnp.where(col.validity, jnp.uint8(0), jnp.uint8(2))
        limbs = [jnp.where(col.validity, x, jnp.uint64(0)) for x in limbs]
        return [cls] + limbs
    else:
        raise Invalid(f"sort: unsupported type {t}")

    if order == "descending":
        key = ~key
    elif order != "ascending":
        raise Invalid(f"bad sort order {order!r}")

    needs_class = has_nan or col.validity is not None
    if not needs_class:
        return [key]
    cls = jnp.zeros(col.length, dtype=jnp.uint8)
    if has_nan:
        nan = jnp.isnan(col.data)
        cls = jnp.where(nan, jnp.uint8(1), cls)
        key = jnp.where(nan, jnp.uint64(0), key)  # all NaN equal (stable ties)
    if col.validity is not None:
        cls = jnp.where(col.validity, cls, jnp.uint8(2))
        key = jnp.where(col.validity, key, jnp.uint64(0))
    return [cls, key]


def sort_indices_device(keys: List[jnp.ndarray]) -> jnp.ndarray:
    """Stable lexicographic argsort over normalized keys (most-significant
    first). LSD composition: sort by the least significant key, then
    re-permute stably by each more significant key."""
    assert keys
    perm = jnp.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        perm = perm[jnp.argsort(key[perm], stable=True)]
    return perm


def _normalize_all(values: RecordBatch, sort_keys) -> List[jnp.ndarray]:
    keys: List[jnp.ndarray] = []
    for name, order in sort_keys:
        keys.extend(normalize_sort_key(values.column(name), order))
    return keys


def _radix_perm(cols_orders) -> jnp.ndarray:
    """Minimal-width packed sort (kernels/radix.py): fewest uint64
    words, value-sort with embedded row id when the bits fit."""
    from ..kernels.radix import minimal_sort_keys, radix_sort_indices

    pairs = []
    for col, order in cols_orders:
        pairs.extend(minimal_sort_keys(col, order))
    return radix_sort_indices(pairs)


def _as_indices(perm) -> Column:
    return Column(perm.astype(jnp.uint64), dt.uint64)


def materialize_sorted(batch: RecordBatch, sort_keys):
    """Return the batch's rows in sorted order (RecordBatch.sort_by fast
    path): every flat column plane rides XLA's variadic sort network as
    a payload — one fused sort, no argsort + per-column gathers (7.2x
    measured; kernels/radix.py docstring). Columns that ARE sort keys
    don't ride as payloads at all when invertible: their values are
    DECODED back out of the sorted packed key words (decode_packed_key),
    cutting sort operands — lax.sort run AND compile cost scale with
    operand count, while the decode is a couple of elementwise passes.
    Returns None when a column is nested (List/Struct/Union) — the
    caller falls back to sort_indices + take."""
    from ..kernels.radix import (decode_packed_key, minimal_sort_keys,
                                 sort_key_decodable, sort_rows_with_keys)

    for c in batch.columns:
        if not isinstance(c, Column):
            return None
    pairs = []
    decode_from_keys = {}   # column name -> (pair_start, npairs, order)
    for name, order in sort_keys:
        col = batch.column(name)
        p = minimal_sort_keys(col, order)
        if name not in decode_from_keys and sort_key_decodable(col):
            decode_from_keys[name] = (len(pairs), len(p), order)
        pairs.extend(p)
    payloads = []
    layout = []
    for name, c in zip(batch.names, batch.columns):
        if name in decode_from_keys:
            layout.append(None)
            continue
        # f64 columns with a bits plane ride as bits ONLY: the data
        # plane rebuilds via i64->f64 bitcast after the sort. One fewer
        # sort operand per f64 column (compile AND run scale with
        # operand count).
        from_bits = c.bits is not None and c.dtype.kind == "float64"
        planes = [c.bits if from_bits else c.data]
        if c.validity is not None:
            planes.append(c.validity)
        if c.data2 is not None:
            planes.append(c.data2)
        payloads.extend(planes)
        layout.append((c.validity is not None, c.data2 is not None,
                       from_bits))
    sorted_, pair_vals = sort_rows_with_keys(pairs, payloads)
    cols = []
    i = 0
    for name, c, lay in zip(batch.names, batch.columns, layout):
        if lay is None:
            start, np_, order = decode_from_keys[name]
            data, validity = decode_packed_key(
                c, pair_vals[start:start + np_], order)
            cols.append(Column(data, c.dtype, validity=validity,
                               dictionary=c.dictionary))
            continue
        has_v, has_d2, from_bits = lay
        data = sorted_[i]
        i += 1
        validity = data2 = bits = None
        if from_bits:
            bits = data
            data = jax.lax.bitcast_convert_type(bits, jnp.float64)
        if has_v:
            validity = sorted_[i]
            i += 1
        if has_d2:
            data2 = sorted_[i]
            i += 1
        cols.append(Column(data, c.dtype, validity=validity, data2=data2,
                           bits=bits, dictionary=c.dictionary))
    return RecordBatch(tuple(cols), batch.names)


def _array_sort_indices_exec(args, options: ArraySortOptions, ctx):
    (col,) = args
    if not isinstance(col, Column):
        raise Invalid("array_sort_indices expects an array")
    options = options or ArraySortOptions()
    return _as_indices(_radix_perm([(col, options.order)]))


register_function("array_sort_indices", "vector", 1, ArraySortOptions)(
    _array_sort_indices_exec)


def _sort_indices_exec(args, options: SortOptions, ctx):
    (values,) = args
    if isinstance(values, Column):
        order = "ascending"
        if options and options.sort_keys:
            order = options.sort_keys[0][1]
        return _array_sort_indices_exec([values], ArraySortOptions(order), ctx)
    assert isinstance(values, RecordBatch)
    if not options or not options.sort_keys:
        raise Invalid("sort_indices: sort_keys required for record batches")
    perm = _radix_perm([(values.column(name), order)
                        for name, order in options.sort_keys])
    return _as_indices(perm)


register_function("sort_indices", "vector", 1, SortOptions)(_sort_indices_exec)


def _partition_nth_exec(args, options: PartitionNthOptions, ctx):
    """partition_nth_indices: indices such that positions < pivot hold the
    pivot-smallest elements (reference: vector_sort.cc:322 via
    std::nth_element). A full key-normalized sort satisfies the same
    postcondition, so the "partial" variant shares the sort kernel."""
    (col,) = args
    if options is None:
        raise Invalid("partition_nth_indices requires options.pivot")
    return _as_indices(_radix_perm([(col, "ascending")]))


register_function("partition_nth_indices", "vector", 1, PartitionNthOptions)(
    _partition_nth_exec)


@dataclasses.dataclass
class RankOptions:
    """Reference: api_vector.h RankOptions (sort order, null placement,
    tiebreaker in {min, max, first, dense})."""
    sort_keys: object = "ascending"
    null_placement: str = "at_end"
    tiebreaker: str = "first"


@dataclasses.dataclass
class RankQuantileOptions:
    sort_keys: object = "ascending"
    null_placement: str = "at_end"


def _rank_order(sort_keys):
    """RankOptions.sort_keys is either an order string or a list of
    (name, order) sort keys; arrays use the first key's order."""
    if isinstance(sort_keys, str):
        return sort_keys
    if sort_keys:
        first = sort_keys[0]
        return first[1] if isinstance(first, (tuple, list)) else \
            getattr(first, "order", "ascending")
    return "ascending"


def _sorted_runs(col, order, null_placement):
    """Stable sort permutation + equal-run boundaries in sorted space:
    (perm, first, run_start, run_end, n). Nulls/NaN form their own runs
    (vector_rank.cc: null placement participates in the rank)."""
    from ..kernels.radix import minimal_sort_keys, pack_operands, \
        radix_sort_indices

    pairs = minimal_sort_keys(col, order, null_placement=null_placement)
    perm = radix_sort_indices(pairs)
    n = col.length
    keys, _ = pack_operands(pairs)
    first = jnp.ones(n, jnp.bool_)
    if n > 1:
        same = jnp.ones(n - 1, jnp.bool_)
        for k in keys:
            ks = k[perm]
            same = same & (ks[1:] == ks[:-1])
        first = first.at[1:].set(~same)
    pos = jnp.arange(n, dtype=jnp.float64)
    run_start = scan_blocked(jnp.maximum,
                                         jnp.where(first, pos, 0.0))
    last = jnp.ones(n, jnp.bool_)
    if n > 1:
        last = last.at[:-1].set(first[1:])
    run_end = scan_blocked(jnp.minimum,
                                       jnp.where(last, pos, jnp.float64(n)),
                                       reverse=True)
    return perm, first, run_start, run_end, n


def _rank_exec(args, options: RankOptions, ctx):
    """rank: 1-based rank with min/max/first/dense tiebreakers
    (reference: vector_rank.cc Ranker specializations)."""
    (col,) = args
    options = options or RankOptions()
    order = _rank_order(options.sort_keys)
    tb = options.tiebreaker
    if tb == "first":
        from ..kernels.radix import minimal_sort_keys, radix_sort_indices

        perm = radix_sort_indices(minimal_sort_keys(
            col, order, null_placement=options.null_placement))
        n = col.length
        ranks = jnp.empty(n, dtype=jnp.uint64)
        ranks = ranks.at[perm].set(jnp.arange(1, n + 1, dtype=jnp.uint64))
        return Column(ranks, dt.uint64)
    perm, first, run_start, run_end, n = _sorted_runs(
        col, order, options.null_placement)
    if tb == "min":
        sorted_rank = run_start + 1.0
    elif tb == "max":
        sorted_rank = run_end + 1.0  # run_end is the inclusive last index
    elif tb == "dense":
        sorted_rank = cumsum_blocked(first.astype(jnp.float64))
    else:
        raise Invalid(f"rank: unknown tiebreaker {tb!r}")
    inv = jnp.argsort(perm, stable=True)
    return Column(sorted_rank[inv].astype(jnp.uint64), dt.uint64)


register_function("rank", "vector", 1, RankOptions)(_rank_exec)


def _avg_tied_rank(col, order="ascending", null_placement="at_end"):
    """Average rank per row, ties averaged
    (reference: vector_rank.cc RankQuantile's underlying rank)."""
    perm, first, run_start, run_end, n = _sorted_runs(col, order,
                                                      null_placement)
    avg_sorted = (run_start + run_end) / 2.0 + 1.0  # 1-based average rank
    inv = jnp.argsort(perm, stable=True)
    return avg_sorted[inv], n


def _rank_quantile_exec(args, options: RankQuantileOptions, ctx):
    """rank_quantile: (2*avg_rank - 1) / (2*n) (reference:
    vector_rank.cc RankQuantile)."""
    (col,) = args
    options = options or RankQuantileOptions()
    avg, n = _avg_tied_rank(col, _rank_order(options.sort_keys),
                            options.null_placement)
    q = (2.0 * avg - 1.0) / (2.0 * max(n, 1))
    return Column(q, dt.float64)


register_function("rank_quantile", "vector", 1, RankQuantileOptions)(
    _rank_quantile_exec)


def _rank_normal_exec(args, options: RankQuantileOptions, ctx):
    """rank_normal: inverse normal CDF of the quantile rank."""
    from jax.scipy.special import ndtri

    (col,) = args
    options = options or RankQuantileOptions()
    avg, n = _avg_tied_rank(col, _rank_order(options.sort_keys),
                            options.null_placement)
    q = (2.0 * avg - 1.0) / (2.0 * max(n, 1))
    return Column(ndtri(q), dt.float64)


register_function("rank_normal", "vector", 1, RankQuantileOptions)(
    _rank_normal_exec)


@dataclasses.dataclass
class SelectKOptions:
    k: int = 0
    sort_keys: tuple = ()


def _select_k_exec(args, options: SelectKOptions, ctx):
    """select_k_unstable: indices of the top/bottom k rows (reference:
    vector_select_k.cc) through a full sort."""
    (col,) = args
    if options is None or not options.sort_keys:
        raise Invalid("select_k_unstable requires sort_keys")
    order = options.sort_keys[0][1]
    perm = _radix_perm([(col, order)])
    k = max(0, min(int(options.k), col.length))
    return Column(perm[:k].astype(jnp.uint64), dt.uint64)


register_function("select_k_unstable", "vector", 1, SelectKOptions)(
    _select_k_exec)
