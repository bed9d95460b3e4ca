"""Vector "hash" kernels: unique, value_counts, dictionary_encode.

Reference: cpp/src/arrow/compute/kernels/vector_hash.cc — MemoTable-driven
actions (:44-230) assigning dense ids in first-appearance order. A serial
memo table is the wrong shape for a data-parallel device; the redesign
computes the same
first-appearance semantics from sort-based grouping:

  stable variadic sort on packed normalized keys -> adjacent-difference
  group flags -> group representatives (stability makes each group's
  first sorted element its first *occurrence*) -> re-sort representatives
  by original position to recover first-appearance order.

Everything is O(n log n) XLA sort + elementwise scans — fully parallel,
no data-dependent loops, and SCATTER-FREE: inverse permutations ride a
second variadic sort, segment boundaries come from `searchsorted` on the
already-sorted ids, and aggregate inputs ride the grouping sort as
variadic payloads (kernels/radix.py sort_rows rationale). Output sizes
(distinct counts) host-sync at the eager boundary like the reference's
two-phase kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch
from .selection import take_column
from .sort import normalize_sort_key, sort_indices_device

__all__ = ["DictionaryEncodeOptions", "grouping_by_keys",
           "Grouping", "grouping_full", "segment_sum",
           "segment_count", "segment_minmax"]


@dataclasses.dataclass
class DictionaryEncodeOptions:
    """Reference: api_vector.h:67."""

    null_encoding: str = "mask"  # "mask" | "encode"


def grouping_by_keys(keys: List[jnp.ndarray]):
    """Core grouping primitive over normalized uint keys.

    Returns (group_ids, rep_rows, num_groups):
      group_ids : int32[n], dense id per row, ids ordered by first appearance
      rep_rows  : int32[num_groups], row index of each group's first
                  occurrence, in first-appearance order
      num_groups: python int (host-synced)

    This replaces GrouperImpl's encode+unordered_map (reference:
    hash_aggregate.cc:313-404) in eager contexts; fused pipelines group
    through ops/padded.py group_sort_padded.
    """
    group_ids, rep_rows, num_groups = _group_core(keys, ())[:3]
    return group_ids, rep_rows, num_groups


def _pack_norm_keys(keys: List[jnp.ndarray]) -> List[jnp.ndarray]:
    """Pack normalized key arrays (uint8 class planes = 2 bits, uint64
    value planes = 64) into as few uint64 sort words as fit."""
    from ..kernels.radix import pack_words

    pairs = [(k.astype(jnp.uint64), 2 if k.dtype == jnp.uint8 else 64)
             for k in keys]
    return pack_words(pairs)


def _inverse_permute(perm: jnp.ndarray, *values: jnp.ndarray):
    """values[i][perm^-1] for each i, scatter-free: one variadic sort
    keyed on the permutation carries the values back to row order."""
    out = jax.lax.sort((perm,) + values, num_keys=1, is_stable=True)
    return out[1:]


def _group_core(keys: List[jnp.ndarray], payloads: Tuple[jnp.ndarray, ...],
                need_ids: bool = True):
    """Shared grouping pipeline. Returns (group_ids, rep_rows, num_groups,
    order, seg_bounds, first, appearance, rank, sorted_payloads).

    need_ids=False skips the per-row appearance-id materialization (an
    n-sized table gather + a FULL second variadic sort — ~135 ms of a
    ~250 ms 10M-row grouping): the sorted-space aggregation path never
    reads per-row ids. group_ids_of() recovers them on demand."""
    n = keys[0].shape[0]
    words = _pack_norm_keys(keys)
    iota = jnp.arange(n, dtype=jnp.int64)
    res = jax.lax.sort(tuple(words) + (iota,) + tuple(payloads),
                       num_keys=len(words), is_stable=True)
    sw = res[:len(words)]
    order = res[len(words)]
    sorted_payloads = list(res[len(words) + 1:])
    first = jnp.ones(n, dtype=jnp.bool_)
    if n > 1:
        same = jnp.ones(n - 1, dtype=jnp.bool_)
        for w in sw:
            same = same & (w[1:] == w[:-1])
        first = jnp.concatenate([first[:1], ~same])
    # dense group ids in *sorted* order
    gid_sorted = (cumsum_blocked(first) - 1).astype(jnp.int64)
    num_groups = int(gid_sorted[-1]) + 1 if n > 0 else 0
    if num_groups > 65536:
        # segment starts, scatter-free at scale: searchsorted's G binary
        # searches are ~G*log(n) dependent gathers; one narrow stable
        # sort keyed on the start flag streams instead.
        _, pos = jax.lax.sort(
            ((~first).astype(jnp.int32), iota), num_keys=1, is_stable=True)
        first_pos = pos[:num_groups]
    else:
        first_pos = jnp.searchsorted(
            gid_sorted,
            jnp.arange(num_groups, dtype=jnp.int64)).astype(jnp.int64)
    rep_sorted = order[first_pos]  # row of first occurrence per sorted group
    # first-appearance order: sort groups by their representative row
    appearance = jnp.argsort(rep_sorted, stable=True)
    rep_rows = rep_sorted[appearance].astype(jnp.int32)
    # remap sorted-group-id -> appearance-rank (inverse of appearance)
    (rank,) = _inverse_permute(
        appearance, jnp.arange(num_groups, dtype=jnp.int64))
    if need_ids:
        # appearance ids per sorted row (monotone G-table gather), then
        # back to row order via a second variadic sort (scatter-free
        # inverse)
        aid_sorted = rank[gid_sorted]
        (group_ids,) = _inverse_permute(order, aid_sorted)
        group_ids = group_ids.astype(jnp.int32)
    else:
        group_ids = None
    seg_bounds = jnp.concatenate(
        [first_pos.astype(jnp.int32), jnp.asarray([n], jnp.int32)])
    return (group_ids, rep_rows, num_groups, order, seg_bounds, first,
            appearance.astype(jnp.int32), rank.astype(jnp.int32),
            sorted_payloads)


def _unique_exec(args, options, ctx):
    (col,) = args
    if not isinstance(col, Column):
        raise Invalid("unique expects an array")
    keys = normalize_sort_key(col)
    _, rep_rows, _ = grouping_by_keys(keys)
    return take_column(col, rep_rows)


register_function("unique", "vector", 1)(_unique_exec)


def _value_counts_exec(args, options, ctx):
    """Returns a RecordBatch{values, counts} (the reference returns a
    StructArray, hash_aggregate-style; a two-column batch is the same data
    and composes better downstream)."""
    (col,) = args
    keys = normalize_sort_key(col)
    group_ids, rep_rows, num_groups = grouping_by_keys(keys)
    counts = jnp.zeros(num_groups, dtype=jnp.int64)
    counts = counts.at[group_ids].add(1)
    values = take_column(col, rep_rows)
    return RecordBatch((values, Column(counts, dt.int64)), ("values", "counts"))


register_function("value_counts", "vector", 1)(_value_counts_exec)


def _dictionary_encode_exec(args, options: DictionaryEncodeOptions, ctx):
    """Returns a dictionary-typed Column (codes on device + host value pool),
    the engine's DictionaryArray equivalent."""
    from ..column import Dictionary

    (col,) = args
    options = options or DictionaryEncodeOptions()
    keys = normalize_sort_key(col)
    group_ids, rep_rows, num_groups = grouping_by_keys(keys)
    out_type = dt.dictionary(dt.int32, col.dtype)
    if col.validity is not None and options.null_encoding == "mask":
        # nulls form a group; strip it from the dictionary and null the codes
        rep_valid = col.validity[rep_rows]
        nvalid = int(jnp.sum(rep_valid))
        (keep,) = jnp.nonzero(rep_valid, size=nvalid, fill_value=0)
        code_of_group = jnp.full(num_groups, 0, dtype=jnp.int32)
        code_of_group = code_of_group.at[keep].set(
            jnp.arange(nvalid, dtype=jnp.int32))
        codes = code_of_group[group_ids]
        values = take_column(col, rep_rows[keep])
        validity = col.validity
    else:
        values = take_column(col, rep_rows)
        codes = group_ids.astype(jnp.int32)
        validity = None
    if col.dtype.is_decimal:
        # exact python Decimals (to_numpy would hand back raw low limbs)
        host_values = np.asarray(values.to_pylist(), dtype=object)
    else:
        host_values = np.asarray(values.to_numpy())
    return Column(codes, out_type, validity=validity,
                  dictionary=Dictionary(host_values))


register_function("dictionary_encode", "vector", 1, DictionaryEncodeOptions)(
    _dictionary_encode_exec)


class Grouping(NamedTuple):
    """Rich grouping result for sorted-space aggregation.

    With rows sorted by key, every aggregate becomes a cumulative scan
    + boundary gathers, in place of a full-length scatter per aggregate.
    Fields:

      group_ids       int32[n]  appearance-ranked dense id per row
      rep_rows        int32[G]  first-occurrence row per appearance group
      num_groups      int
      order           int[n]    row indices in sorted-key order
      seg_bounds      int32[G+1] segment boundaries in sorted space
                                 (sorted-group order)
      appearance_rank int32[G]  sorted-group -> appearance id
      seg_starts      bool[n]   segment-start flags in sorted space
                                (None on legacy constructors: derived
                                from seg_bounds by scatter)
      appearance      int32[G]  appearance id -> sorted-group index
                                (inverse of appearance_rank; lets
                                _to_appearance gather instead of scatter)
    """

    group_ids: jnp.ndarray
    rep_rows: jnp.ndarray
    num_groups: int
    order: jnp.ndarray
    seg_bounds: jnp.ndarray
    appearance_rank: jnp.ndarray
    seg_starts: jnp.ndarray = None
    appearance: jnp.ndarray = None


def grouping_full(keys: List[jnp.ndarray], payloads: Tuple = ()
                  ) -> Tuple[Grouping, List[jnp.ndarray]]:
    """grouping_by_keys + the sorted-space segment structure.

    `payloads` arrays ride the grouping sort as variadic operands and
    come back in sorted-key order — aggregate inputs thus reach sorted
    space with ZERO extra gathers (vs one hardware gather per aggregate,
    ~75 ms per 10M rows measured). Returns (Grouping, sorted_payloads).
    """
    (group_ids, rep_rows, num_groups, order, seg_bounds, first,
     appearance, rank, sorted_payloads) = _group_core(
        keys, tuple(payloads), need_ids=False)
    g = Grouping(group_ids, rep_rows, num_groups, order, seg_bounds,
                 rank, seg_starts=first, appearance=appearance)
    return g, sorted_payloads


def group_ids_of(g: Grouping) -> jnp.ndarray:
    """Per-row appearance-ranked group ids, materialized on demand (the
    sorted-space path skips them; only scatter-form fallback aggregates
    pay this: one G-table gather + one variadic inverse sort)."""
    if g.group_ids is not None:
        return g.group_ids
    first = g.seg_starts
    gid_sorted = (cumsum_blocked(first) - 1).astype(jnp.int64)
    aid_sorted = g.appearance_rank.astype(jnp.int64)[gid_sorted]
    (ids,) = _inverse_permute(g.order, aid_sorted)
    return ids.astype(jnp.int32)


def _to_appearance(totals_sorted, g: Grouping):
    """Reorder per-sorted-group values into appearance order (gather by
    the appearance index when available; legacy scatter otherwise)."""
    if g.appearance is not None:
        return totals_sorted[g.appearance]
    out = jnp.empty_like(totals_sorted)
    return out.at[g.appearance_rank].set(totals_sorted)


def _seg_starts(g: Grouping, n: int):
    if g.seg_starts is not None:
        return g.seg_starts
    return jnp.zeros(n, jnp.bool_).at[g.seg_bounds[:-1]].set(
        True, mode="drop")


def segment_sum(x, g: Grouping, acc_dtype, sorted_: bool = False):
    """Per-group sum (appearance order) in sorted space, no scatters.
    `sorted_=True` means x is already in g.order (rode the grouping sort
    as a payload).

    Integers: cumsum-diff (exact, wrapping like the reference). Floats:
    a segmented scan that restarts at each group, because a cumsum-diff
    leaves a small group's sum with the rounding error of the running
    total of every row before it."""
    xs = (x if sorted_ else x[g.order]).astype(acc_dtype)
    if jnp.issubdtype(xs.dtype, jnp.floating):
        starts = _seg_starts(g, xs.shape[0])

        def combine(a, b):
            av, af = a
            bv, bf = b
            return jnp.where(bf, bv, av + bv), af | bf

        c, _ = scan_blocked(combine, (xs, starts))
        return _to_appearance(c[g.seg_bounds[1:] - 1], g)
    c = cumsum_blocked(xs)
    hi = c[g.seg_bounds[1:] - 1]
    lo = jnp.where(g.seg_bounds[:-1] > 0,
                   c[jnp.maximum(g.seg_bounds[:-1] - 1, 0)], 0)
    return _to_appearance(hi - lo, g)


def segment_count(live, g: Grouping, sorted_: bool = False):
    return segment_sum(live.astype(jnp.int64), g, jnp.int64, sorted_=sorted_)


def segment_minmax(x, g: Grouping, is_min: bool, sorted_: bool = False):
    """Segmented min/max via a flagged associative scan in sorted space."""
    xs = x if sorted_ else x[g.order]
    n = xs.shape[0]
    starts = _seg_starts(g, n)

    def combine(a, b):
        av, af = a
        bv, bf = b
        v = jnp.where(bf, bv,
                      jnp.minimum(av, bv) if is_min else jnp.maximum(av, bv))
        return v, af | bf

    vals, _ = scan_blocked(combine, (xs, starts))
    return _to_appearance(vals[g.seg_bounds[1:] - 1], g)


def grouping_from_ids(gids: jnp.ndarray, num_groups: int) -> Grouping:
    """Build the sorted-space Grouping structure from precomputed dense
    appearance-ordered group ids (kernel-level hash_* entry points)."""
    n = gids.shape[0]
    sorted_ = jax.lax.sort(
        (gids.astype(jnp.int64), jnp.arange(n, dtype=jnp.int64)),
        num_keys=1, is_stable=True)
    gs, order = sorted_
    first = jnp.ones(n, jnp.bool_)
    if n > 1:
        first = jnp.concatenate([first[:1], gs[1:] != gs[:-1]])
    first_pos = jnp.searchsorted(
        gs, jnp.arange(num_groups, dtype=jnp.int64)).astype(jnp.int64)
    seg_bounds = jnp.concatenate([first_pos.astype(jnp.int32),
                                  jnp.asarray([n], jnp.int32)])
    rep_rows = order[first_pos].astype(jnp.int32)
    # group ids are already appearance-ordered: sorted-group k IS
    # appearance id gs[first_pos[k]], and that mapping is the identity
    # permutation in both directions
    rank = gs[first_pos].astype(jnp.int32)
    return Grouping(gids.astype(jnp.int32), rep_rows, num_groups, order,
                    seg_bounds, rank, seg_starts=first, appearance=rank)
