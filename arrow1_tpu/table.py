"""Tabular containers: RecordBatch (one batch) and Table (chunk sequence).

Reference: cpp/src/arrow/record_batch.h:38 (immutable schema + equal-length
arrays) and table.h:42 (columns are chunked). The device design keeps
RecordBatch as *the* unit of device execution — a pytree of Columns that
flows through jit — and Table as a thin host-side sequence of RecordBatches
(the ChunkedArray axis of the reference collapses to "list of batches",
which is what the streaming executor iterates anyway, cf. ExecBatchIterator
compute/exec.cc:158).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as dt
from .column import Column, column
from .errors import Invalid

__all__ = ["RecordBatch", "Table", "ChunkedColumn", "record_batch", "table",
           "concat_batches", "concat_columns"]


class ChunkedColumn:
    """A sequence of same-type Columns (reference: chunked_array.h:67).

    Host-side container: device kernels run per chunk (or on the
    combined column); mirrors ChunkedArray's combine/slice/iterate API.
    """

    __slots__ = ("chunks",)

    def __init__(self, chunks):
        assert chunks, "ChunkedColumn requires at least one chunk"
        t = chunks[0].dtype
        for c in chunks:
            assert c.dtype == t, "all chunks must share a type"
        self.chunks = list(chunks)

    @property
    def dtype(self):
        return self.chunks[0].dtype

    @property
    def num_chunks(self):
        return len(self.chunks)

    @property
    def length(self):
        return sum(c.length for c in self.chunks)

    def __len__(self):
        return self.length

    @property
    def null_count(self):
        return sum(c.null_count for c in self.chunks)

    def chunk(self, i):
        return self.chunks[i]

    def combine_chunks(self):
        return concat_columns(self.chunks)

    def to_numpy(self):
        return self.combine_chunks().to_numpy()

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def slice(self, offset, length=None):
        end = self.length if length is None else offset + length
        out, pos = [], 0
        for c in self.chunks:
            lo, hi = max(offset - pos, 0), min(end - pos, c.length)
            if lo < hi:
                out.append(c.slice(lo, hi - lo))
            pos += c.length
        return ChunkedColumn(out or [self.chunks[0].slice(0, 0)])

    def to_arrow(self):
        import pyarrow as pa

        return pa.chunked_array([c.to_arrow() for c in self.chunks])

    # ---- pyarrow.ChunkedArray method-level parity: kernels run on the
    # combined device column (reference: python/pyarrow/table.pxi;
    # MetaFunctions iterate chunks, here one HBM batch is the natural
    # execution unit) ----
    @property
    def type(self):
        return self.dtype

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return False

    @property
    def data(self):  # pyarrow's deprecated self-alias
        return self

    def iterchunks(self):
        return iter(self.chunks)

    def _combined(self, fn, *args, **kwargs):
        from .registry import call_function

        return call_function(fn, [self.combine_chunks(), *args], **kwargs)

    def cast(self, target_type, safe: bool = True):
        from .ops.cast import cast as _cast

        return _cast(self.combine_chunks(), target_type, safe=safe)

    def filter(self, mask):
        return self._combined("filter", mask)

    def take(self, indices):
        return self._combined("take", indices)

    def drop_null(self):
        return self._combined("drop_null")

    def unique(self):
        return self._combined("unique")

    def value_counts(self):
        return self._combined("value_counts")

    def dictionary_encode(self):
        return self._combined("dictionary_encode")

    def sort(self, order: str = "ascending"):
        return self.combine_chunks().sort(order)

    def fill_null(self, fill_value):
        return self._combined("fill_null", fill_value)

    def is_null(self, nan_is_null: bool = False):
        return self._combined("is_null", nan_is_null=nan_is_null)

    def is_valid(self):
        return self._combined("is_valid")

    def is_nan(self):
        return self._combined("is_nan")

    def index(self, value):
        return self._combined("index", value=value)

    def flatten(self):
        return self.combine_chunks()

    def unify_dictionaries(self):
        return ChunkedColumn([self.combine_chunks()])

    def equals(self, other) -> bool:
        return self.to_pylist() == (other.to_pylist()
                                    if hasattr(other, "to_pylist")
                                    else list(other))

    def validate(self, full: bool = False):
        from .validate import validate_column

        for c in self.chunks:
            validate_column(c)

    def to_pandas(self, **kwargs):
        # through arrow so null slots become NaN/None for every type
        return self.to_arrow().to_pandas()

    def to_string(self) -> str:
        return repr(self)

    format = to_string

    def __repr__(self):
        return f"ChunkedColumn<{self.dtype!r}>[{self.length} rows, " \
               f"{self.num_chunks} chunks]"


def concat_columns(cols):
    """Concatenate same-type Columns (reference: array/concatenate.cc)."""
    import jax.numpy as jnp

    if len(cols) == 1:
        return cols[0]
    from .column import ListColumn, StructColumn, UnionColumn

    if isinstance(cols[0], ListColumn):
        return _concat_list_columns(cols)
    if isinstance(cols[0], RecordBatch):
        # struct child batch (map columns): concat per field
        return RecordBatch(
            tuple(concat_columns([c.columns[i] for c in cols])
                  for i in range(len(cols[0].columns))), cols[0].names)
    if isinstance(cols[0], StructColumn):
        kids = tuple(concat_columns([c.children[i] for c in cols])
                     for i in range(len(cols[0].children)))
        validity = None
        if any(c.validity is not None for c in cols):
            validity = jnp.concatenate([c.mask() for c in cols])
        return StructColumn(kids, cols[0].names, cols[0].dtype,
                            validity=validity)
    if isinstance(cols[0], UnionColumn):
        type_ids = jnp.concatenate([c.type_ids for c in cols])
        if cols[0].is_dense:
            kids = tuple(concat_columns([c.children[i] for c in cols])
                         for i in range(len(cols[0].children)))
            # rebase each batch's offsets by its children's running bases,
            # selected per row through a type-code LUT
            bases = [0] * len(cols[0].children)
            off_parts = []
            for c in cols:
                code_to_pos = {code: k for k, code in
                               enumerate(c.dtype.type_codes)}
                base_lut = jnp.asarray(
                    [bases[code_to_pos[tc]] if tc in code_to_pos else 0
                     for tc in range(128)], jnp.int32)
                off_parts.append(
                    c.offsets + base_lut[c.type_ids.astype(jnp.int32)])
                for k, ch in enumerate(c.children):
                    bases[k] += ch.length
            offsets = jnp.concatenate(off_parts)
            return UnionColumn(type_ids, kids, cols[0].dtype,
                               offsets=offsets)
        kids = tuple(concat_columns([c.children[i] for c in cols])
                     for i in range(len(cols[0].children)))
        return UnionColumn(type_ids, kids, cols[0].dtype)
    data = jnp.concatenate([c.data for c in cols])
    data2 = (jnp.concatenate([c.data2 for c in cols])
             if cols[0].data2 is not None else None)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = jnp.concatenate([c.mask() for c in cols])
    dictionary = cols[0].dictionary
    if dictionary is not None and any(c.dictionary is not dictionary
                                      for c in cols):
        from .ops.dictionary import unify_dictionaries

        data, dictionary = unify_dictionaries(cols)
    return Column(data, cols[0].dtype, validity=validity,
                  dictionary=dictionary, data2=data2)


@jax.tree_util.register_pytree_node_class
class RecordBatch:
    """Schema + equal-length device Columns (reference: record_batch.h:38)."""

    __slots__ = ("columns", "names", "metadata")

    def __init__(self, columns: Tuple[Column, ...], names: Tuple[str, ...],
                 metadata=None):
        assert len(columns) == len(names)
        if columns:
            n = columns[0].length
            for c in columns:
                assert c.length == n, "all columns must have equal length"
        self.columns = tuple(columns)
        self.names = tuple(names)
        # schema-level metadata: tuple of (bytes, bytes) pairs or None
        self.metadata = metadata

    # ---- pytree ----
    def tree_flatten(self):
        return self.columns, (self.names, self.metadata)

    @classmethod
    def tree_unflatten(cls, aux, columns):
        names, metadata = aux
        return cls(tuple(columns), names, metadata)

    # ---- accessors ----
    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def schema(self) -> dt.Schema:
        return dt.Schema(tuple(
            dt.Field(n, c.dtype, getattr(c, "validity", None) is not None)
            for n, c in zip(self.names, self.columns)
        ), self.metadata)

    def replace_schema_metadata(self, metadata=None) -> "RecordBatch":
        items = None
        if metadata:
            # order-preserving: Arrow schema metadata is a list, not a map
            items = tuple(
                (k.encode() if isinstance(k, str) else k,
                 v.encode() if isinstance(v, str) else v)
                for k, v in dict(metadata).items())
        return RecordBatch(self.columns, self.names, metadata=items)

    def column(self, key) -> Column:
        if isinstance(key, int):
            return self.columns[key]
        return self.columns[self.column_index(key)]

    def __getitem__(self, key):
        return self.column(key)

    def column_index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"no column {name!r} in batch (columns: {list(self.names)})"
            ) from None

    def select(self, names: Sequence[str]) -> "RecordBatch":
        return RecordBatch(tuple(self.column(n) for n in names), tuple(names))

    def set_column(self, name: str, col: Column) -> "RecordBatch":
        if name in self.names:
            i = self.names.index(name)
            cols = list(self.columns)
            cols[i] = col
            return RecordBatch(tuple(cols), self.names)
        return RecordBatch(self.columns + (col,), self.names + (name,))

    def drop(self, names: Sequence[str]) -> "RecordBatch":
        keep = [(n, c) for n, c in zip(self.names, self.columns) if n not in names]
        return RecordBatch(tuple(c for _, c in keep), tuple(n for n, _ in keep))

    def rename(self, mapping: dict) -> "RecordBatch":
        return RecordBatch(self.columns,
                           tuple(mapping.get(n, n) for n in self.names))

    def slice(self, offset: int, length: Optional[int] = None) -> "RecordBatch":
        return RecordBatch(tuple(c.slice(offset, length) for c in self.columns),
                           self.names)

    # ---- host conversion ----
    def to_arrow(self):
        from .interop import record_batch_to_arrow

        return record_batch_to_arrow(self)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_pydict(self):
        return {n: c.to_numpy().tolist() for n, c in zip(self.names, self.columns)}

    # ---- pyarrow-compatible conveniences (reference: record_batch.h /
    # pyarrow RecordBatch surface) ----
    @property
    def column_names(self):
        return list(self.names)

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self.columns:
            for leaf in jax.tree_util.tree_leaves(c):
                total += leaf.size * leaf.dtype.itemsize
        return total

    def field(self, key):
        i = key if isinstance(key, int) else self.column_index(key)
        return self.schema.fields[i]

    def add_column(self, i: int, name: str, col) -> "RecordBatch":
        cols, names = list(self.columns), list(self.names)
        cols.insert(i, column(col) if not hasattr(col, "dtype") else col)
        names.insert(i, name)
        return RecordBatch(tuple(cols), tuple(names))

    def append_column(self, name: str, col) -> "RecordBatch":
        return self.add_column(self.num_columns, name, col)

    def remove_column(self, i: int) -> "RecordBatch":
        cols = list(self.columns)
        names = list(self.names)
        del cols[i], names[i]
        return RecordBatch(tuple(cols), tuple(names))

    def drop_columns(self, names) -> "RecordBatch":
        if isinstance(names, str):
            names = [names]
        return self.drop(names)

    def rename_columns(self, names) -> "RecordBatch":
        if isinstance(names, dict):
            return self.rename(names)
        assert len(names) == self.num_columns
        return RecordBatch(self.columns, tuple(names))

    def itercolumns(self):
        return iter(self.columns)

    def equals(self, other) -> bool:
        if self.names != other.names or self.num_rows != other.num_rows:
            return False
        return self.to_arrow().equals(other.to_arrow())

    def filter(self, mask, null_selection_behavior: str = "drop"):
        from .registry import call_function

        return call_function(
            "filter", [self, mask if hasattr(mask, "dtype")
                       else column(mask)],
            null_selection_behavior=null_selection_behavior)

    def take(self, indices):
        from .registry import call_function

        return call_function("take", [self, indices
                                      if hasattr(indices, "dtype")
                                      else column(indices)])

    def sort_by(self, sorting) -> "RecordBatch":
        from .registry import call_function

        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        from .ops.sort import materialize_sorted

        fast = materialize_sorted(self, list(sorting))
        if fast is not None:
            return fast
        idx = call_function("sort_indices", [self], sort_keys=list(sorting))
        return self.take(idx.with_data(idx.data.astype(jnp.int64),
                                       dt.int64))

    def drop_null(self) -> "RecordBatch":
        keep = jnp.ones(self.num_rows, jnp.bool_)
        for c in self.columns:
            keep = keep & c.mask()
        return self.filter(Column(keep, dt.bool_))

    def cast(self, target_schema) -> "RecordBatch":
        from .registry import call_function

        fields = target_schema.fields if hasattr(target_schema, "fields") \
            else list(target_schema)
        cols = tuple(call_function("cast", [c], target_type=f.type
                                   if hasattr(f, "type") else f)
                     for c, f in zip(self.columns, fields))
        return RecordBatch(cols, self.names)

    def to_struct_array(self):
        from .column import StructColumn

        return StructColumn(self.columns, self.names,
                            dt.struct((n, c.dtype) for n, c in
                                      zip(self.names, self.columns)))

    @classmethod
    def from_struct_array(cls, struct_col) -> "RecordBatch":
        return cls(struct_col.children, struct_col.names)

    @classmethod
    def from_pydict(cls, mapping) -> "RecordBatch":
        return record_batch(dict(mapping))

    @classmethod
    def from_pylist(cls, rows) -> "RecordBatch":
        import pyarrow as pa

        from .interop import record_batch_from_arrow

        return record_batch_from_arrow(pa.RecordBatch.from_pylist(rows))

    @classmethod
    def from_arrays(cls, arrays, names) -> "RecordBatch":
        return cls(tuple(column(a) for a in arrays), tuple(names))

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def to_string(self) -> str:
        return self.to_arrow().to_string()

    def to_tensor(self):
        """[rows, cols] device array for all-numeric batches (reference:
        RecordBatch::ToTensor)."""
        from .tensor import Tensor

        for c in self.columns:
            if not c.dtype.is_numeric:
                raise Invalid("to_tensor: all columns must be numeric")
        return Tensor(jnp.stack([c.data.astype(jnp.float64)
                                 for c in self.columns], axis=1))

    def validate(self, full: bool = False):
        from .validate import validate_batch

        validate_batch(self, full=full)

    # ---- pyarrow.RecordBatch parity tail ----
    @classmethod
    def from_pandas(cls, df, preserve_index=None) -> "RecordBatch":
        import pyarrow as pa

        from .interop import record_batch_from_arrow

        return record_batch_from_arrow(pa.RecordBatch.from_pandas(
            df, preserve_index=preserve_index))

    def get_total_buffer_size(self) -> int:
        return sum(c.nbytes if hasattr(c, "nbytes") else 0
                   for c in self.columns)

    @property
    def nbytes(self) -> int:
        return self.get_total_buffer_size()

    @property
    def is_cpu(self) -> bool:
        return False  # batches live in device HBM

    def serialize(self) -> bytes:
        """Batch as IPC stream bytes (pyarrow.RecordBatch.serialize)."""
        import io as _io

        from .io import ipc_native

        buf = _io.BytesIO()
        ipc_native.write_stream(buf, [self])
        return buf.getvalue()

    def __repr__(self):
        inner = ", ".join(f"{n}: {c.dtype!r}" for n, c in zip(self.names, self.columns))
        return f"RecordBatch[{self.num_rows} rows]({inner})"


class Table:
    """A sequence of same-schema RecordBatches (reference: table.h:42).

    Host-side container only — device execution is per-batch. The streaming
    executor iterates batches like the reference's ExecBatchIterator
    (compute/exec.cc:158-230) iterates 64Ki chunks.
    """

    __slots__ = ("batches", "names")

    def __init__(self, batches: List[RecordBatch]):
        assert batches, "Table requires at least one batch (possibly empty)"
        self.batches = list(batches)
        self.names = batches[0].names

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def num_columns(self) -> int:
        return len(self.names)

    @property
    def schema(self) -> dt.Schema:
        return self.batches[0].schema

    def combine_chunks(self) -> RecordBatch:
        return concat_batches(self.batches)

    def to_arrow(self):
        import pyarrow as pa

        return pa.Table.from_batches([b.to_arrow() for b in self.batches])

    # ---- pyarrow-compatible conveniences (reference: table.h surface) ----
    @property
    def column_names(self):
        return list(self.names)

    @property
    def columns(self):
        return [self.column(i) for i in range(self.num_columns)]

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.batches)

    def column(self, key) -> "ChunkedColumn":
        return ChunkedColumn([b.column(key) for b in self.batches])

    def __getitem__(self, key):
        return self.column(key)

    def field(self, key):
        return self.batches[0].field(key)

    def itercolumns(self):
        return iter(self.columns)

    def select(self, names) -> "Table":
        return Table([b.select(names) for b in self.batches])

    def slice(self, offset: int, length: Optional[int] = None) -> "Table":
        return Table([self.combine_chunks().slice(offset, length)])

    def add_column(self, i, name, col) -> "Table":
        return Table([self.combine_chunks().add_column(i, name, col)])

    def append_column(self, name, col) -> "Table":
        return Table([self.combine_chunks().append_column(name, col)])

    def remove_column(self, i) -> "Table":
        return Table([b.remove_column(i) for b in self.batches])

    def set_column(self, name, col) -> "Table":
        return Table([self.combine_chunks().set_column(name, col)])

    def drop(self, names) -> "Table":
        if isinstance(names, str):
            names = [names]
        return Table([b.drop(names) for b in self.batches])

    drop_columns = drop

    def rename_columns(self, names) -> "Table":
        return Table([b.rename_columns(names) for b in self.batches])

    def filter(self, mask, null_selection_behavior: str = "drop") -> "Table":
        return Table([self.combine_chunks().filter(
            mask, null_selection_behavior=null_selection_behavior)])

    def take(self, indices) -> "Table":
        return Table([self.combine_chunks().take(indices)])

    def sort_by(self, sorting) -> "Table":
        return Table([self.combine_chunks().sort_by(sorting)])

    def drop_null(self) -> "Table":
        return Table([self.combine_chunks().drop_null()])

    def cast(self, target_schema) -> "Table":
        return Table([b.cast(target_schema) for b in self.batches])

    def group_by(self, keys, use_threads: bool = True):
        """pyarrow TableGroupBy shape: .group_by(keys).aggregate([...])."""
        if isinstance(keys, str):
            keys = [keys]

        table_self = self

        class _GroupBy:
            def aggregate(self, aggregations):
                from .ops.groupby import group_by as _gb

                return Table([_gb(table_self.combine_chunks(), list(keys),
                                  [(c, f) for c, f in aggregations])])

        return _GroupBy()

    def join(self, right, keys, right_keys=None,
             join_type: str = "left outer", **kw) -> "Table":
        from .ops.join import join as _join

        rb = right.combine_chunks() if isinstance(right, Table) else right
        return Table([_join(self.combine_chunks(), rb,
                            keys=[keys] if isinstance(keys, str) else
                            list(keys),
                            right_keys=None if right_keys is None else
                            ([right_keys] if isinstance(right_keys, str)
                             else list(right_keys)),
                            join_type=join_type, **kw)])

    def join_asof(self, right, on, by=None, tolerance: int = 0) -> "Table":
        from .ops.join import join_asof as _asof

        rb = right.combine_chunks() if isinstance(right, Table) else right
        return Table([_asof(self.combine_chunks(), rb, on=on, by=by,
                            tolerance=tolerance)])

    def to_batches(self):
        return list(self.batches)

    @classmethod
    def from_batches(cls, batches) -> "Table":
        return cls(list(batches))

    @classmethod
    def from_pydict(cls, mapping) -> "Table":
        return cls([record_batch(dict(mapping))])

    @classmethod
    def from_arrays(cls, arrays, names) -> "Table":
        return cls([RecordBatch.from_arrays(arrays, names)])

    @classmethod
    def from_pandas(cls, df) -> "Table":
        import pyarrow as pa

        from .interop import record_batch_from_arrow

        return cls([record_batch_from_arrow(pa.Table.from_pandas(df))])

    @classmethod
    def from_pylist(cls, rows) -> "Table":
        return cls([RecordBatch.from_pylist(rows)])

    @classmethod
    def from_struct_array(cls, struct_col) -> "Table":
        return cls([RecordBatch.from_struct_array(struct_col)])

    def to_struct_array(self):
        return self.combine_chunks().to_struct_array()

    def to_tensor(self):
        return self.combine_chunks().to_tensor()

    def to_reader(self, max_chunksize=None):
        """Iterator of batches (pyarrow.Table.to_reader shape)."""
        if max_chunksize is None:
            return iter(self.batches)
        combined = self.combine_chunks()
        n = combined.num_rows

        def gen():
            for lo in range(0, max(n, 1), max_chunksize):
                if lo >= n:
                    break
                yield combined.slice(lo, min(max_chunksize, n - lo))

        return gen()

    def flatten(self) -> "Table":
        """Flatten struct columns into top-level columns
        (pyarrow.Table.flatten shape)."""
        from .column import StructColumn

        batch = self.combine_chunks()
        cols, names = [], []
        for n, c in zip(batch.names, batch.columns):
            if isinstance(c, StructColumn):
                for cn, cc in zip(c.names, c.children):
                    if c.validity is not None and hasattr(cc, "mask"):
                        # null parents null their children (pyarrow ANDs
                        # the parent bitmap into each flattened child)
                        cc = cc.with_validity(cc.mask() & c.validity) \
                            if hasattr(cc, "with_validity") else cc
                    cols.append(cc)
                    names.append(f"{n}.{cn}")
            else:
                cols.append(c)
                names.append(n)
        return Table([RecordBatch(tuple(cols), tuple(names))])

    def get_total_buffer_size(self) -> int:
        return sum(b.get_total_buffer_size() for b in self.batches)

    @property
    def nbytes(self) -> int:
        return self.get_total_buffer_size()

    @property
    def is_cpu(self) -> bool:
        return False

    def replace_schema_metadata(self, metadata=None) -> "Table":
        return Table([b.replace_schema_metadata(metadata)
                      for b in self.batches])

    def to_pydict(self):
        return self.to_arrow().to_pydict()

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_string(self) -> str:
        return self.to_arrow().to_string()

    def equals(self, other) -> bool:
        return self.to_arrow().equals(other.to_arrow()
                                      if isinstance(other, Table)
                                      else other)

    def unify_dictionaries(self) -> "Table":
        return Table([self.combine_chunks()])

    def validate(self, full: bool = False):
        for b in self.batches:
            b.validate(full=full)

    def __repr__(self):
        return f"Table[{self.num_rows} rows, {len(self.batches)} batches]"


def record_batch(data, names: Optional[Sequence[str]] = None) -> RecordBatch:
    """Build a RecordBatch from a dict of name->values (numpy / jax /
    Column / pyarrow values) or a pyarrow RecordBatch/Table. pyarrow is
    imported only when a pyarrow object is passed."""
    if type(data).__module__.startswith("pyarrow"):
        from .interop import record_batch_from_arrow

        return record_batch_from_arrow(data)
    if isinstance(data, dict):
        cols = tuple(column(v) for v in data.values())
        return RecordBatch(cols, tuple(data.keys()))
    if names is not None:
        return RecordBatch(tuple(column(v) for v in data), tuple(names))
    raise TypeError(f"cannot build RecordBatch from {type(data)}")


def table(data) -> Table:
    """Build a single-batch Table."""
    return Table([record_batch(data)])


def concat_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """Concatenate same-schema batches (reference: array/concatenate.cc,
    Table::CombineChunks). Validity masks are materialized if any batch has
    one."""
    from .column import ListColumn

    assert batches
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names
    out_cols = []
    for i in range(len(names)):
        cols = [b.columns[i] for b in batches]
        from .column import StructColumn, UnionColumn

        if isinstance(cols[0], (ListColumn, StructColumn, UnionColumn,
                                RecordBatch)):
            out_cols.append(concat_columns(cols))
            continue
        data = jnp.concatenate([c.data for c in cols])
        data2 = (jnp.concatenate([c.data2 for c in cols])
                 if cols[0].data2 is not None else None)
        if any(c.validity is not None for c in cols):
            validity = jnp.concatenate([c.mask() for c in cols])
        else:
            validity = None
        dictionary = cols[0].dictionary
        if dictionary is not None:
            # dictionaries must be unified before concat; ingest produces
            # per-batch dictionaries, so re-encode against a merged pool.
            dicts = {id(c.dictionary) for c in cols}
            if len(dicts) > 1:
                from .ops.dictionary import unify_dictionaries

                data, dictionary = unify_dictionaries(cols)
        out_cols.append(Column(data, cols[0].dtype, validity=validity,
                               dictionary=dictionary, data2=data2))
    return RecordBatch(tuple(out_cols), names)


def _concat_list_columns(cols):
    """Concatenate ListColumns: rebase offsets, concat children
    (reference: array/concatenate.cc list handling)."""
    from .column import ListColumn

    child = concat_columns([c.values for c in cols]) \
        if len({id(c.values) for c in cols}) > 1 or len(cols) > 1 \
        else cols[0].values
    parts = []
    base = 0
    for c in cols:
        parts.append(c.offsets[:-1] + base)
        base += int(c.offsets[-1])
    parts.append(jnp.asarray([base], dtype=cols[0].offsets.dtype))
    offsets = jnp.concatenate(parts)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = jnp.concatenate([c.mask() for c in cols])
    return ListColumn(offsets, child, cols[0].dtype, validity=validity)
