"""Selection kernels: filter and take.

Reference: cpp/src/arrow/compute/kernels/vector_selection.cc. The reference
filter walks the selection bitmap with a BitBlockCounter and memcpys
all-set runs (:611-760); the device redesign is a single XLA compaction:
``indices = nonzero(mask)`` (a fused cumsum+scatter on device) followed by
one gather per column. All per-type specializations of the reference's
registration table (:2130-2191) collapse to {fixed-width gather,
dict-codes gather} because ingest normalizes layouts (SURVEY.md §2.5).

Two-phase output sizing (reference: GetFilterOutputSize :61): the eager API
host-syncs the selected count, then runs a statically-shaped gather. The
jit-composable forms (`filter_indices_padded`) keep everything on device
with padded indices + a count scalar, for fused pipelines.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column
from ..datum import Scalar
from ..errors import IndexError_, Invalid
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["FilterOptions", "TakeOptions", "filter_indices_padded",
           "take_column"]


@dataclasses.dataclass
class FilterOptions:
    """Reference: api_vector.h:35."""

    null_selection_behavior: str = "drop"  # "drop" | "emit_null"


@dataclasses.dataclass
class TakeOptions:
    """Reference: api_vector.h:52."""

    boundscheck: bool = True


# ---- take ----

def take_column(values: Column, indices, out_validity=None) -> Column:
    """Typed gather (reference: vector_selection.cc:273-530 Take paths).

    ``indices`` is a device int array; ``out_validity`` an optional extra
    mask ANDed into the result (used by filter emit_null and by null
    indices)."""
    from ..column import ListColumn
    from ..table import RecordBatch as _RB

    if isinstance(values, ListColumn):
        return _take_list(values, indices, out_validity)
    if isinstance(values, _RB):
        # struct child (e.g. a map's key/value pair batch): gather rowwise
        return _RB(tuple(take_column(c, indices, out_validity)
                         for c in values.columns), values.names)
    from ..column import StructColumn

    if isinstance(values, StructColumn):
        kids = tuple(take_column(c, indices) for c in values.children)
        validity = None
        if values.validity is not None:
            validity = values.validity[indices]
        if out_validity is not None:
            validity = out_validity if validity is None else \
                (validity & out_validity)
        return StructColumn(kids, values.names, values.dtype,
                            validity=validity)
    data = values.data[indices]
    data2 = values.data2[indices] if values.data2 is not None else None
    validity = None
    if values.validity is not None:
        validity = values.validity[indices]
    if out_validity is not None:
        validity = out_validity if validity is None else (validity & out_validity)
    return Column(data, values.dtype, validity=validity,
                  dictionary=values.dictionary, data2=data2)


def _take_list(values, indices, out_validity=None):
    """List-column gather (reference: ListImpl vector_selection.cc:1608 —
    child indices composed from parent ranges). Eager (host-syncs the new
    value count, like the two-phase selection kernels)."""
    from ..column import ListColumn

    starts = values.offsets[:-1][indices]
    lengths = values.value_lengths()[indices]
    new_offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int64), cumsum_blocked(lengths)])
    total = int(new_offsets[-1])
    n_out = int(lengths.shape[0])
    # child gather indices: for output slot i, range(starts[i], +lengths[i])
    parent = jnp.repeat(jnp.arange(n_out), lengths,
                        total_repeat_length=total)
    within = jnp.arange(total, dtype=jnp.int64) - new_offsets[parent]
    child_idx = starts[parent] + within
    child = take_column(values.values, child_idx)
    validity = None
    if values.validity is not None:
        validity = values.validity[indices]
    if out_validity is not None:
        validity = out_validity if validity is None else (validity & out_validity)
    return ListColumn(new_offsets, child, values.dtype, validity=validity)


def _check_bounds(idx_data, idx_validity, length: int):
    """Reference: boundschecking via int_util.h:101 — raises on OOB."""
    bad = (idx_data < 0) | (idx_data >= length)
    if idx_validity is not None:
        bad = bad & idx_validity
    if bool(jnp.any(bad)):
        raise IndexError_(f"take index out of bounds (length {length})")


def _take_exec(args, options: TakeOptions, ctx):
    values, indices = args
    if isinstance(indices, Scalar):
        raise Invalid("take: indices must be an array")
    assert isinstance(indices, Column)
    if not indices.dtype.is_integer:
        raise Invalid(f"take: indices must be integer, got {indices.dtype}")
    idx = indices.data
    if options is None:
        options = TakeOptions()
    if isinstance(values, RecordBatch):
        n = values.num_rows
    else:
        n = values.length
    if options.boundscheck:
        _check_bounds(idx, indices.validity, n)
    # null indices produce null rows; clamp them to 0 for the gather
    extra_validity = indices.validity
    if extra_validity is not None:
        idx = jnp.where(extra_validity, idx, 0)
    idx = jnp.clip(idx, 0, max(n - 1, 0))
    if isinstance(values, RecordBatch):
        return gather_batch_packed(values, idx, extra_validity)
    return take_column(values, idx, extra_validity)


register_function("take", "vector", 2, TakeOptions, aliases=["array_take"])(
    _take_exec)


# ---- packed row gather ----
#
# A multi-column take packs all fixed-width planes into one [n, W] i32
# matrix, gathers rows once, and unpacks: a random gather is bound by
# access latency more than by bytes, so one W-word row gather replaces W
# one-word gathers. Pack/unpack are sequential streams. Whether this
# beats per-column gathers on the GPU is not measured yet.

def _word_planes(x):
    """[n] / [n, m] array -> ([n, w] i32 plane, decoder) or None.

    Split by bit width; 64-bit via bitcast i64->i32x2. f64 columns pass
    their ingest bit view (``Column.bits``)."""
    if x.ndim == 1:
        x2 = x[:, None]
    else:
        x2 = x
    dt_ = x2.dtype
    n, m = x2.shape

    if dt_ in (jnp.int64, jnp.uint64):
        plane = jax.lax.bitcast_convert_type(x2, jnp.int32)  # [n, m, 2]
        plane = plane.reshape(n, 2 * m)

        def dec(slab, d=dt_, m=m, nd=x.ndim):
            out = jax.lax.bitcast_convert_type(
                slab.reshape(slab.shape[0], m, 2), d)
            return out[:, 0] if nd == 1 else out
        return plane, dec
    if dt_ in (jnp.int32, jnp.uint32, jnp.float32):
        plane = jax.lax.bitcast_convert_type(x2, jnp.int32).reshape(n, m)

        def dec(slab, d=dt_, m=m, nd=x.ndim):
            out = jax.lax.bitcast_convert_type(slab.reshape(
                slab.shape[0], m), d)
            return out[:, 0] if nd == 1 else out
        return plane, dec
    if dt_ in (jnp.int8, jnp.uint8, jnp.int16, jnp.uint16, jnp.bool_):
        plane = x2.astype(jnp.int32)

        def dec(slab, d=dt_, nd=x.ndim):
            out = slab.astype(d)
            return out[:, 0] if nd == 1 else out
        return plane, dec
    return None


def gather_batch_packed(batch: RecordBatch, idx, extra_validity=None
                        ) -> RecordBatch:
    """RecordBatch row gather through ONE packed [n, W] i32 matrix."""
    from ..column import ListColumn, StructColumn

    planes = []      # [n, w] i32 planes to concatenate
    widths = []
    builders = []    # (name, plan) where plan rebuilds the column

    def enc(x):
        r = _word_planes(x)
        if r is None:
            return None
        plane, dec = r
        planes.append(plane)
        widths.append(plane.shape[1])
        return len(planes) - 1, dec

    fallback = {}
    for pos, c in enumerate(batch.columns):
        if (not isinstance(c, Column)
                or (c.dtype.kind == "float64" and c.bits is None)):
            # nested columns, and f64 without an ingest bit view
            fallback[pos] = take_column(c, idx, extra_validity)
            continue
        src = c.bits if c.dtype.kind == "float64" else c.data
        data_slot = enc(src)
        if data_slot is None:
            fallback[pos] = take_column(c, idx, extra_validity)
            continue
        parts = {"data": data_slot}
        if c.data2 is not None:
            parts["data2"] = enc(c.data2)
        if c.validity is not None:
            parts["validity"] = enc(c.validity)
        builders.append((pos, c, parts))

    if len(planes) <= 1:   # nothing to amortize — direct gathers
        cols = tuple(take_column(c, idx, extra_validity)
                     for c in batch.columns)
        return RecordBatch(cols, batch.names)

    packed = jnp.concatenate(planes, axis=1)
    slab = packed[idx, :]
    offs = np.concatenate([[0], np.cumsum(widths)])

    def take_slab(slot):
        i, dec = slot
        return dec(slab[:, offs[i]:offs[i + 1]])

    out = {}
    for pos, c, parts in builders:
        raw = take_slab(parts["data"])
        if c.dtype.kind == "float64":
            data = jax.lax.bitcast_convert_type(raw, jnp.float64)
            bits = raw
        else:
            data = raw
            bits = None
        data2 = take_slab(parts["data2"]) if "data2" in parts else None
        validity = take_slab(parts["validity"]) if "validity" in parts \
            else None
        if extra_validity is not None:
            validity = extra_validity if validity is None else \
                (validity & extra_validity)
        out[pos] = Column(data, c.dtype, validity=validity,
                          dictionary=c.dictionary, data2=data2,
                          bits=bits)
    cols = tuple(out.get(i, fallback.get(i))
                 for i in range(len(batch.columns)))
    return RecordBatch(cols, batch.names)


# ---- filter ----

def _effective_mask(mask: Column, null_selection: str):
    """Combine mask data+validity per FilterOptions semantics.

    DROP: null mask slot removes the row. EMIT_NULL: null mask slot emits a
    null row (the row is *selected* but output validity is cleared)."""
    if mask.validity is None:
        return mask.data, None
    if null_selection == "drop":
        return mask.data & mask.validity, None
    elif null_selection == "emit_null":
        selected = mask.data | ~mask.validity
        return selected, mask.validity
    raise Invalid(f"bad null_selection_behavior {null_selection!r}")


def filter_indices_padded(selected: jnp.ndarray):
    """Jit-composable compaction: returns (indices, count) where indices is
    input-length, the first `count` entries are the selected positions in
    order, and the tail is padded with `n` (an OOB sentinel the caller
    never reads past count).

    This is the mask -> prefix-sum -> scatter design from SURVEY.md §7
    expressed as plain XLA ops (cumsum, scatter)."""
    n = selected.shape[0]
    count = jnp.sum(selected, dtype=jnp.int32)
    positions = cumsum_blocked(selected, dtype=jnp.int32) - 1
    rows = jnp.arange(n, dtype=jnp.int32)
    scatter_to = jnp.where(selected, positions, n)
    indices = jnp.full(n, n, dtype=jnp.int32)
    indices = indices.at[scatter_to].set(rows, mode="drop")
    return indices, count


def _filter_exec(args, options: FilterOptions, ctx):
    values, mask = args
    if not isinstance(mask, Column) or not mask.dtype.is_boolean:
        raise Invalid("filter: mask must be a boolean array")
    if options is None:
        options = FilterOptions()
    if isinstance(values, Scalar):
        raise Invalid("filter: values must be an array or record batch")
    if isinstance(values, Column) and values.length != mask.length:
        raise Invalid(f"filter: length mismatch {values.length} vs {mask.length}")
    selected, mask_validity = _effective_mask(mask, options.null_selection_behavior)

    # two-phase: host-sync the count, then statically-shaped compaction
    count = int(jnp.sum(selected))
    (idx,) = jnp.nonzero(selected, size=count, fill_value=0)
    idx = idx.astype(jnp.int32)
    extra_validity = None
    if mask_validity is not None:
        extra_validity = mask_validity[idx]
    if isinstance(values, RecordBatch):
        return gather_batch_packed(values, idx, extra_validity)
    return take_column(values, idx, extra_validity)


register_function("filter", "vector", 2, FilterOptions,
                  aliases=["array_filter"])(_filter_exec)


# ---- indices_nonzero (reference: GetTakeIndices vector_selection.cc:223) ----

def _indices_nonzero_exec(args, options, ctx):
    """Indices of non-zero valid values; NaN counts as non-zero and
    decimals test the full multi-limb value (GetTakeIndices semantics
    extended to numerics like the reference kernel)."""
    (mask,) = args
    nz = mask.data != 0
    if mask.data2 is not None:
        d2 = mask.data2
        nz = nz | ((d2 != 0).any(axis=1) if d2.ndim > 1 else (d2 != 0))
    selected = nz if mask.validity is None else (nz & mask.validity)
    count = int(jnp.sum(selected))
    (idx,) = jnp.nonzero(selected, size=count, fill_value=0)
    return Column(idx.astype(jnp.uint64), dt.uint64)


register_function("indices_nonzero", "vector", 1)(_indices_nonzero_exec)


# ---- drop_null (reference: DropNull meta in later arrow; trivial here) ----

def _drop_null_exec(args, options, ctx):
    (values,) = args
    if isinstance(values, RecordBatch):
        m = None
        for c in values.columns:
            if c.validity is not None:
                m = c.validity if m is None else (m & c.validity)
        if m is None:
            return values
        mask = Column(m, dt.bool_)
        return _filter_exec([values, mask], FilterOptions(), ctx)
    if values.validity is None:
        return values
    return _filter_exec([values, Column(values.validity, dt.bool_)],
                        FilterOptions(), ctx)


register_function("drop_null", "vector", 1)(_drop_null_exec)


def _array_take_exec(args, options, ctx):
    from ..registry import call_function

    return call_function("take", list(args),
                         **({} if options is None else
                            {"boundscheck": getattr(options, "boundscheck",
                                                    True)}))


def _array_filter_exec(args, options, ctx):
    from ..registry import call_function

    kw = {}
    if options is not None and getattr(options, "null_selection_behavior",
                                       None):
        kw["null_selection_behavior"] = options.null_selection_behavior
    return call_function("filter", list(args), **kw)


register_function("array_take", "vector", 2, TakeOptions)(_array_take_exec)
register_function("array_filter", "vector", 2, FilterOptions)(
    _array_filter_exec)


@dataclasses.dataclass
class ScatterOptions:
    max_index: int = 0


def _scatter_exec(args, options: ScatterOptions, ctx):
    """out[indices[i]] = values[i]; unset slots null (reference:
    vector_swizzle.cc Scatter)."""
    values, indices = args
    if options is None:
        raise Invalid("scatter requires max_index")
    size = int(options.max_index) + 1
    idx = indices.data.astype(jnp.int64)
    live = indices.mask() & values.mask()
    safe = jnp.where(live, idx, size)
    data = jnp.zeros(size, values.data.dtype).at[safe].set(
        values.data, mode="drop")
    filled = jnp.zeros(size, jnp.bool_).at[safe].set(live, mode="drop")
    data2 = None
    if values.data2 is not None:
        data2 = jnp.zeros(size, values.data2.dtype).at[safe].set(
            values.data2, mode="drop")
    return Column(data, values.dtype,
                  validity=collapse_validity(filled),
                  dictionary=values.dictionary, data2=data2)


register_function("scatter", "vector", 2, ScatterOptions)(_scatter_exec)
