"""Host-boundary interop: pyarrow <-> device columns.

The ingest stance from SURVEY.md §3.4a: reuse Arrow host libraries for
stage-1 decode (CSV/Parquet/IPC); the device pipeline starts at "RecordBatch
of fixed-width/dict columns". This module is that boundary: it normalizes
arbitrary Arrow arrays into the engine's device-friendly physical forms
(fixed-width data + bool masks + dictionary codes) and back.

Normalizations applied at ingest (cf. SURVEY.md §2.5 closing note):
- string/binary         -> dictionary-encode -> int32 codes + host Dictionary
- dictionary<any>       -> codes preserved, values kept host-side
- chunked arrays        -> concatenated (device tiles are offset-free)
- sliced arrays         -> materialized (no offset bookkeeping on device)
- validity bitmaps      -> unpacked bool mask arrays (None if no nulls)
- decimal128            -> two int64 limb arrays
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import dtypes as dt
from .column import Column, Dictionary

__all__ = [
    "column_from_arrow",
    "column_to_arrow",
    "record_batch_from_arrow",
    "record_batch_to_arrow",
]


# extension name -> pyarrow ExtensionType seen at ingest (export re-wrap)
_EXT_TYPES = {}


def _validity_from_arrow(arr) -> Optional[jnp.ndarray]:
    if arr.null_count == 0:
        return None
    # pyarrow: is_valid returns a BooleanArray; to numpy unpacked bools
    import pyarrow.compute as pc

    valid = np.asarray(pc.is_valid(arr))
    return jnp.asarray(valid)


def column_from_arrow(arr) -> Column:
    """Convert a pyarrow Array/ChunkedArray to a device Column."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if isinstance(arr, pa.ChunkedArray):  # combine may still return chunked
        arr = pa.concat_arrays(arr.chunks) if arr.num_chunks else pa.array([], arr.type)

    t = arr.type

    # strings/binary: dictionary-encode on host, ship codes
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)):
        dict_arr = pc.dictionary_encode(arr)
        return _from_dictionary_array(dict_arr, logical=dt.from_arrow(t))

    if pa.types.is_dictionary(t):
        return _from_dictionary_array(arr, logical=dt.from_arrow(t.value_type))

    if pa.types.is_boolean(t):
        data = np.asarray(arr.cast(pa.uint8())).astype(np.bool_)
        return Column(jnp.asarray(data), dt.bool_, validity=_validity_from_arrow(arr))

    if pa.types.is_struct(t):
        from .column import StructColumn

        validity = _validity_from_arrow(arr)
        kids = [column_from_arrow(arr.field(i))
                for i in range(t.num_fields)]
        names = [t.field(i).name for i in range(t.num_fields)]
        return StructColumn(kids, names, dt.from_arrow(t),
                            validity=validity)

    if pa.types.is_map(t):
        from .column import ListColumn
        from .table import RecordBatch as _RB

        validity = _validity_from_arrow(arr)
        off = np.asarray(arr.offsets, dtype=np.int64)
        off = off - off[0]  # rebase slice offset
        keys = column_from_arrow(arr.keys)
        items = column_from_arrow(arr.items)
        child = _RB((keys, items), ("key", "value"))
        return ListColumn(jnp.asarray(off), child, dt.from_arrow(t),
                          validity=validity)

    if pa.types.is_union(t):
        from .column import UnionColumn

        dtype = dt.from_arrow(t)
        type_ids = jnp.asarray(np.asarray(arr.type_codes, dtype=np.int8))
        kids = [column_from_arrow(arr.field(i))
                for i in range(t.num_fields)]
        if t.mode == "dense":
            offsets = jnp.asarray(np.asarray(arr.offsets, dtype=np.int32))
            return UnionColumn(type_ids, kids, dtype, offsets=offsets)
        return UnionColumn(type_ids, kids, dtype)

    if pa.types.is_fixed_size_list(t):
        from .column import ListColumn

        k = t.list_size
        # .values ignores the slice offset and keeps null slots — both are
        # exactly what the affine layout wants (child length == n*k).
        child = column_from_arrow(arr.values.slice(arr.offset * k,
                                                   len(arr) * k))
        offsets = jnp.arange(len(arr) + 1, dtype=jnp.int64) * k
        return ListColumn(offsets, child, dt.from_arrow(t),
                          validity=_validity_from_arrow(arr))

    if pa.types.is_list(t) or pa.types.is_large_list(t):
        from .column import ListColumn

        validity = _validity_from_arrow(arr)
        # null slots get zero-length via offset diff of the compacted array
        lengths = np.asarray(
            arr.value_lengths().fill_null(0), dtype=np.int64)
        offsets = np.zeros(len(arr) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        child = column_from_arrow(arr.flatten())
        return ListColumn(jnp.asarray(offsets), child, dt.from_arrow(t),
                          validity=validity)

    if pa.types.is_decimal(t):
        from decimal import Context

        ctx = Context(prec=80)  # default 28-digit context would round
        pyvals = [v.as_py() for v in arr]
        ints = [None if v is None else int(v.scaleb(t.scale, ctx))
                for v in pyvals]
        M = 0xFFFFFFFFFFFFFFFF
        lo = np.array([0 if v is None else v & M for v in ints],
                      dtype=np.uint64).astype(np.int64)
        if pa.types.is_decimal256(t):
            # four little-endian limbs (util/basic_decimal.h Decimal256):
            # limb0 in data, limbs 1..3 in data2[n,3]
            logical = dt.decimal256(t.precision, t.scale)
            his = np.zeros((len(arr), 3), dtype=np.int64)
            for j in range(3):
                his[:, j] = np.array(
                    [0 if v is None else ((v >> (64 * (j + 1))) & M)
                     for v in ints], dtype=np.uint64).astype(np.int64)
            # top limb keeps the sign: arithmetic shift semantics
            his[:, 2] = np.array(
                [0 if v is None else (v >> 192) for v in ints],
                dtype=np.int64)
            return Column(jnp.asarray(lo), logical,
                          validity=_validity_from_arrow(arr),
                          data2=jnp.asarray(his))
        logical = dt.decimal128(t.precision, t.scale)
        hi = np.array([0 if v is None else v >> 64 for v in ints],
                      dtype=np.int64)
        return Column(jnp.asarray(lo), logical,
                      validity=_validity_from_arrow(arr),
                      data2=jnp.asarray(hi))

    if t == pa.month_day_nano_interval():
        # 16-byte entries: (months i32, days i32, nanoseconds i64) —
        # months|days packed into data (i64), nanos in data2
        rec = np.frombuffer(
            arr.buffers()[1], dtype=[("m", "<i4"), ("d", "<i4"),
                                     ("n", "<i8")],
            count=len(arr) + arr.offset)[arr.offset:]
        data = (rec["m"].astype(np.int64) << 32) | (
            rec["d"].astype(np.int64) & 0xFFFFFFFF)
        return Column(jnp.asarray(data), dt.month_day_nano_interval(),
                      validity=_validity_from_arrow(arr),
                      data2=jnp.asarray(rec["n"].copy()))

    if isinstance(t, pa.ExtensionType):
        # storage-unwrap hook (ref: vector_selection.cc:1178): operate on
        # the storage column; remember the pa type for faithful re-wrap
        storage = column_from_arrow(arr.storage)
        logical = dt.extension(t.extension_name, storage.dtype)
        _EXT_TYPES[t.extension_name] = t
        return Column(storage.data, logical, validity=storage.validity,
                      dictionary=storage.dictionary, data2=storage.data2,
                      bits=storage.bits)

    logical = dt.from_arrow(t)
    if logical.is_temporal:
        storage = np.asarray(arr.view(pa.int32() if logical.byte_width == 4
                                      else pa.int64()).fill_null(0))
        return Column(jnp.asarray(storage), logical,
                      validity=_validity_from_arrow(arr))
    if pa.types.is_null(t):
        return Column(jnp.zeros(len(arr), jnp.int8), dt.null,
                      validity=jnp.zeros(len(arr), jnp.bool_))

    # numeric: zero-copy-ish numpy view; nulls filled with 0 in data
    np_arr = arr.to_numpy(zero_copy_only=False)
    if arr.null_count:
        # to_numpy gives float+NaN for nullable ints — rebuild from buffers
        np_arr = np.asarray(
            arr.fill_null(0).to_numpy(zero_copy_only=False)
        ).astype(np.dtype(np.dtype(logical.physical_dtype().dtype
                                   if hasattr(logical.physical_dtype(), "dtype")
                                   else logical.physical_dtype())))
    np_arr = np.ascontiguousarray(
        np_arr.astype(np.dtype(logical.physical_dtype()), copy=False))
    bits = None
    if logical.kind == "float64":
        # host-side int64 bit view (free); see Column.bits
        bits = jnp.asarray(np_arr.view(np.int64))
    return Column(jnp.asarray(np_arr), logical,
                  validity=_validity_from_arrow(arr), bits=bits)


def _from_dictionary_array(dict_arr, logical: dt.DataType) -> Column:
    import pyarrow as pa

    if isinstance(dict_arr, pa.ChunkedArray):
        dict_arr = dict_arr.combine_chunks()
    indices = dict_arr.indices
    codes = np.asarray(indices.fill_null(0)).astype(np.int32)
    values = dict_arr.dictionary.to_numpy(zero_copy_only=False)
    validity = _validity_from_arrow(dict_arr)
    return Column(jnp.asarray(codes), logical, validity=validity,
                  dictionary=Dictionary(values))


def column_to_arrow(col: Column):
    return col.to_arrow()


def record_batch_from_arrow(batch):
    """pyarrow RecordBatch/Table -> engine RecordBatch."""
    import pyarrow as pa

    from .table import RecordBatch

    if isinstance(batch, pa.Table):
        batch = batch.combine_chunks()
        cols = [column_from_arrow(batch.column(i)) for i in range(batch.num_columns)]
    else:
        cols = [column_from_arrow(batch.column(i)) for i in range(batch.num_columns)]
    names = tuple(batch.schema.names)
    md = batch.schema.metadata
    metadata = tuple(md.items()) if md else None  # order-preserving
    return RecordBatch(tuple(cols), names, metadata=metadata)


def record_batch_to_arrow(rb):
    import pyarrow as pa

    arrays = [c.to_arrow() for c in rb.columns]
    out = pa.record_batch(arrays, names=list(rb.names))
    md = getattr(rb, "metadata", None)
    if md:
        out = out.replace_schema_metadata(dict(md))
    return out
