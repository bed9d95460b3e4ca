"""Nested kernels: list_value_length, list_flatten, list_parent_indices,
make_struct.

Reference: cpp/src/arrow/compute/kernels/scalar_nested.cc (+
vector_nested.cc). List columns are offsets+child (column.py ListColumn);
the exploded "parent indices" view is the device-friendly alignment for
per-value work (SURVEY.md §2.5: nested-offsets normalization).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column, ListColumn
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch


def _require_list(col, name):
    if not isinstance(col, ListColumn):
        raise Invalid(f"{name}: expected a list column")


def _list_value_length_exec(args, options, ctx):
    (col,) = args
    _require_list(col, "list_value_length")
    return Column(col.value_lengths().astype(jnp.int32), dt.int32,
                  validity=col.validity)


register_function("list_value_length", "scalar", 1)(_list_value_length_exec)


@dataclasses.dataclass
class ListFlattenOptions:
    """Reference: api_vector.h ListFlattenOptions (recursive)."""
    recursive: bool = False


def _flatten_once(col):
    if col.validity is not None and col.dtype.kind == "fixed_size_list":
        # fixed-size layout keeps child slots under null parents
        # (affine offsets) — flatten must drop them, like the reference.
        from .selection import take_column

        idx = jnp.where(col.validity[_parent_of(col)])[0]
        return take_column(col.values, idx)
    return col.values


def _list_flatten_exec(args, options: ListFlattenOptions, ctx):
    """Concatenated child values of non-null slots (reference:
    vector_nested.cc ListFlatten — null parents contribute nothing);
    recursive=True flattens nested list levels down to the leaf values."""
    (col,) = args
    _require_list(col, "list_flatten")
    out = _flatten_once(col)
    if options is not None and options.recursive:
        while isinstance(out, ListColumn):
            out = _flatten_once(out)
    return out


register_function("list_flatten", "vector", 1, ListFlattenOptions)(
    _list_flatten_exec)


def _parent_of(col) -> jnp.ndarray:
    lengths = col.value_lengths()
    total = int(col.offsets[-1])
    return jnp.repeat(jnp.arange(col.length, dtype=jnp.int64), lengths,
                      total_repeat_length=total)


def _list_parent_indices_exec(args, options, ctx):
    """For each child value, the row index of its parent list
    (reference: vector_nested.cc ListParentIndices)."""
    (col,) = args
    _require_list(col, "list_parent_indices")
    parent = _parent_of(col)
    if col.validity is not None and col.dtype.kind == "fixed_size_list":
        parent = parent[col.validity[parent]]
    return Column(parent, dt.int64)


register_function("list_parent_indices", "vector", 1)(
    _list_parent_indices_exec)



@dataclasses.dataclass
class MakeStructOptions:
    """Reference: ProjectOptions api_scalar.h:139 (field names)."""

    field_names: tuple = ()


def _make_struct_exec(args, options: MakeStructOptions, ctx):
    """Assemble columns into a struct (reference: scalar_nested.cc
    "make_struct" / ProjectOptions api_scalar.h:139). Structs are
    represented as a RecordBatch (column-per-field — the device layout is
    identical to a struct array's children)."""
    field_names = list(options.field_names) if options and \
        options.field_names else [str(i) for i in range(len(args))]
    return RecordBatch(tuple(args), tuple(field_names))


register_function("make_struct", "scalar", -1, MakeStructOptions,
                  aliases=["project"])(_make_struct_exec)


def _struct_field_exec(args, options, ctx):
    """struct_field(struct, name-or-index): structs are RecordBatches
    (column-per-field), so field access is column selection
    (reference: scalar_nested.cc StructField)."""
    (s,) = args
    field = options.field if options and hasattr(options, "field") else None
    if field is None:
        raise Invalid("struct_field requires a field name/index")
    from ..column import StructColumn

    if isinstance(s, StructColumn):
        got = s.field(field)
        if s.validity is not None:
            v = got.mask() & s.validity
            got = Column(got.data, got.dtype,
                         validity=collapse_validity(v),
                         dictionary=got.dictionary, data2=got.data2)
        return got
    if not isinstance(s, RecordBatch):
        raise Invalid("struct_field expects a struct (RecordBatch)")
    return s.column(field)


@dataclasses.dataclass
class StructFieldOptions:
    field: object = None


register_function("struct_field", "scalar", 1, StructFieldOptions)(
    _struct_field_exec)


@dataclasses.dataclass
class ListElementOptions:
    index: int = 0


def _list_element_exec(args, options, ctx):
    """list_element(lists, i): the i-th child value of each slot; null for
    null slots, error when a non-null list is shorter than i+1 (matching
    pyarrow's out-of-bounds behavior)."""
    (col,) = args
    _require_list(col, "list_element")
    i = options.index if options else 0
    lengths = col.value_lengths()
    too_short = lengths <= i
    if col.validity is not None:
        too_short = too_short & col.validity
    if bool(jnp.any(too_short)):
        raise Invalid(f"Index {i} is out of bounds for some list slots")
    valid = lengths > i
    if col.validity is not None:
        valid = valid & col.validity
    starts = col.offsets[:-1]
    idx = jnp.clip(starts + i, 0, max(int(col.offsets[-1]) - 1, 0))
    from .selection import take_column

    child = take_column(col.values, idx)
    validity = valid if child.validity is None else (child.validity & valid)
    from ..column import Column as _C

    return _C(child.data, child.dtype,
              validity=collapse_validity(validity),
              dictionary=child.dictionary)


register_function("list_element", "scalar", 1, ListElementOptions)(
    _list_element_exec)


@dataclasses.dataclass
class ListSliceOptions:
    start: int = 0
    stop: object = None
    step: int = 1
    return_fixed_size_list: object = None


def _list_slice_exec(args, options: ListSliceOptions, ctx):
    """Slice every list slot (reference: scalar_nested.cc ListSlice)."""
    (col,) = args
    _require_list(col, "list_slice")
    options = options or ListSliceOptions()
    start, stop, step = options.start, options.stop, options.step
    if step < 1:
        raise Invalid("list_slice: step must be >= 1")
    lengths = col.value_lengths()
    eff_stop = lengths if stop is None else jnp.minimum(lengths, stop)
    new_len = jnp.maximum((eff_stop - start + step - 1) // step, 0)
    total = int(jnp.sum(new_len))
    n = col.length
    new_off = jnp.concatenate([jnp.zeros(1, jnp.int64),
                               cumsum_blocked(new_len)])
    parent = jnp.repeat(jnp.arange(n, dtype=jnp.int64), new_len,
                        total_repeat_length=total)
    within = jnp.arange(total, dtype=jnp.int64) - new_off[parent]
    child_idx = col.offsets[:-1][parent] + start + within * step
    from .selection import take_column

    child = take_column(col.values, child_idx)
    out_t = dt.list_(col.dtype.fields[0][1]) \
        if col.dtype.kind == "fixed_size_list" else col.dtype
    return ListColumn(new_off, child, out_t, validity=col.validity)


register_function("list_slice", "scalar", 1, ListSliceOptions)(
    _list_slice_exec)


@dataclasses.dataclass
class MapLookupOptions:
    query_key: object = None
    occurrence: str = "first"


def _map_lookup_exec(args, options: MapLookupOptions, ctx):
    """map_lookup(map, query_key, occurrence=first|last|all)
    (reference: scalar_nested.cc MapLookup). Maps are ListColumns with a
    {key, value} RecordBatch child."""
    (col,) = args
    if not isinstance(col, ListColumn) or col.dtype.kind != "map":
        raise Invalid("map_lookup: expects a map column")
    if options is None or options.query_key is None:
        raise Invalid("map_lookup requires query_key")
    keys = col.values.column("key")
    items = col.values.column("value")
    q = options.query_key
    if keys.dictionary is not None:
        code = keys.dictionary.index.get(q, -1)
        hit = (keys.data == code) & keys.mask()
    else:
        hit = (keys.data == q) & keys.mask()
    total = int(col.offsets[-1])
    n = col.length
    parent = _parent_of(col)
    pos = jnp.arange(total, dtype=jnp.int64)
    occ = options.occurrence
    from .selection import take_column

    if occ == "all":
        idx = jnp.where(hit)[0]
        sub_parent = parent[idx]
        # per-row hit counts -> offsets (idx is parent-sorted already)
        offsets = jnp.searchsorted(sub_parent, jnp.arange(n + 1)) \
            .astype(jnp.int64)
        child = take_column(items, idx)
        counts = offsets[1:] - offsets[:-1]
        validity = counts > 0
        if col.validity is not None:
            validity = validity & col.validity
        return ListColumn(offsets, child,
                          dt.list_(items.dtype),
                          validity=collapse_validity(validity))
    if occ == "first":
        cand = jnp.where(hit, pos, total)
        best = jnp.full(n, total, jnp.int64).at[parent].min(cand)
        has = best < total
    elif occ == "last":
        cand = jnp.where(hit, pos, -1)
        best = jnp.full(n, -1, jnp.int64).at[parent].max(cand)
        has = best >= 0
    else:
        raise Invalid(f"map_lookup: bad occurrence {occ!r}")
    got = take_column(items, jnp.clip(best, 0, max(total - 1, 0)))
    validity = has & got.mask()
    if col.validity is not None:
        validity = validity & col.validity
    return Column(got.data, items.dtype,
                  validity=collapse_validity(validity),
                  dictionary=got.dictionary, data2=got.data2)


register_function("map_lookup", "scalar", 1, MapLookupOptions)(
    _map_lookup_exec)
