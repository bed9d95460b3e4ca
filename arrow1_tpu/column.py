"""Column: the device-resident columnar array.

Device-native redesign of the reference's ArrayData/Array
(reference: cpp/src/arrow/array/data.h:73, array/array_base.h:53):

- ``data``: one fixed-width jnp array. For string/binary columns this holds
  int32 *dictionary codes*; the unique values live host-side in a
  ``Dictionary``. (SURVEY.md §7: dictionary-encode at ingest, operate on ids.)
- ``validity``: unpacked bool mask, or None when all-valid — mirroring the
  reference's "bitmap may be omitted when null_count==0"
  (docs/source/format/Columnar.rst:187-208), but as a lane-friendly mask
  array instead of an LSB-packed bitmap.
- No ``offset``: the reference's zero-copy bit-offset slicing
  (array/data.h, compute/kernel.h:563 can_write_into_slices) is a recurring
  complexity source; here slices materialize (cheap device copy under XLA)
  and keep every kernel offset-free.
- decimal128 carries a second limb array (``data2``) — two int64 limbs
  replace the reference's __int128 storage (util/basic_decimal.h).

Column is a registered pytree: ``data``/``validity``/``data2`` are leaves,
everything else (dtype, dictionary) is static aux data, so Columns flow
through ``jax.jit`` boundaries with the logical type resolved at trace time
— the moral equivalent of the reference's kernel dispatch on ValueDescr
(compute/kernel.h:368) happening at trace time instead of call time.
"""

from __future__ import annotations

import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as dt

__all__ = ["Column", "Dictionary", "ListColumn", "column", "nulls"]


class Dictionary:
    """Host-side unique-value store for dictionary-encoded columns.

    Hash/eq are by identity: a Dictionary is an immutable value pool created
    at ingest; identity equality makes it usable as jit-static metadata
    without hashing the values themselves. ``rank`` is the lazily computed
    code->sort-rank table that lets order-sensitive kernels (sort, min/max,
    comparisons) treat dict-string columns as fixed-width integers
    (SURVEY.md §7 design correspondences).
    """

    __slots__ = ("values", "_rank", "_lock", "_index", "_byte_matrix")

    def __init__(self, values: np.ndarray):
        # values: numpy object/str array of unique values (position = code)
        self.values = np.asarray(values)
        self._byte_matrix = None  # ops/strings_device.py memo
        self._rank = None
        self._index = None
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.values)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    @property
    def rank(self) -> np.ndarray:
        """int32 array: rank[code] = position of values[code] in sorted order."""
        if self._rank is None:
            with self._lock:
                if self._rank is None:
                    order = np.argsort(self.values, kind="stable")
                    rank = np.empty(len(self.values), dtype=np.int32)
                    rank[order] = np.arange(len(self.values), dtype=np.int32)
                    self._rank = rank
        return self._rank

    @property
    def rank_is_identity(self) -> bool:
        """True when the value pool is already in sorted order (codes ==
        ranks). Host-static metadata: sort kernels use it to skip the
        per-row rank gather (a random gather is the slowest primitive on
        this stack — kernels/radix.py)."""
        r = self.rank
        return bool(np.array_equal(r, np.arange(len(r), dtype=r.dtype)))

    @property
    def index(self) -> dict:
        """value -> code lookup (host-side MemoTable analogue,
        reference: cpp/src/arrow/util/hashing.h:374 ScalarMemoTable)."""
        if self._index is None:
            with self._lock:
                if self._index is None:
                    self._index = {v: i for i, v in enumerate(self.values.tolist())}
        return self._index

    def __repr__(self):
        return f"Dictionary({len(self.values)} values)"


@jax.tree_util.register_pytree_node_class
class Column:
    """One typed device array + optional validity mask (+ dictionary).

    The device analogue of the reference Array (array/array_base.h:53).
    """

    __slots__ = ("data", "validity", "data2", "dtype", "dictionary", "bits")

    def __init__(
        self,
        data,
        dtype: dt.DataType,
        validity=None,
        dictionary: Optional[Dictionary] = None,
        data2=None,
        bits=None,
    ):
        self.data = data
        self.validity = validity
        self.data2 = data2  # decimal128 high limb
        self.dtype = dtype
        self.dictionary = dictionary
        # float64 only: int64 bit view created at pyarrow ingest, which
        # packed gathers and sorts carry in place of the f64 plane (the
        # engine's first target could not bitcast f64 on device; ROADMAP
        # Design 2). None for computed columns (plain gather paths).
        self.bits = bits

    # ---- pytree protocol ----
    def tree_flatten(self):
        return (self.data, self.validity, self.data2, self.bits), \
            (self.dtype, self.dictionary)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, validity, data2, bits = children
        dtype, dictionary = aux
        return cls(data, dtype, validity=validity, dictionary=dictionary,
                   data2=data2, bits=bits)

    # ---- basics ----
    def __len__(self):
        return int(self.data.shape[0])

    @property
    def length(self) -> int:
        return int(self.data.shape[0])

    @property
    def null_count(self) -> int:
        """Host-syncing null count (reference: ArrayData.null_count)."""
        if self.validity is None:
            return 0
        return int(jnp.sum(~self.validity))

    @property
    def has_validity(self) -> bool:
        return self.validity is not None

    def mask(self) -> jnp.ndarray:
        """The validity mask as a concrete bool array (all-True if None)."""
        if self.validity is None:
            return jnp.ones(self.data.shape[0], dtype=jnp.bool_)
        return self.validity

    def with_validity(self, validity) -> "Column":
        return Column(self.data, self.dtype, validity=validity,
                      dictionary=self.dictionary, data2=self.data2)

    def with_data(self, data, dtype=None) -> "Column":
        return Column(data, dtype or self.dtype, validity=self.validity,
                      dictionary=self.dictionary, data2=self.data2)

    def slice(self, offset: int, length: Optional[int] = None) -> "Column":
        """Materializing slice (no offset bookkeeping — see module docstring)."""
        end = self.length if length is None else min(offset + length, self.length)
        return Column(
            self.data[offset:end],
            self.dtype,
            validity=None if self.validity is None else self.validity[offset:end],
            dictionary=self.dictionary,
            data2=None if self.data2 is None else self.data2[offset:end],
        )

    # ---- pyarrow.Array method-level parity (each delegates to the
    # registered compute kernel; reference: python/pyarrow/array.pxi) ----
    @property
    def type(self) -> dt.DataType:
        return self.dtype

    @property
    def nbytes(self) -> int:
        n = self.data.size * self.data.dtype.itemsize
        if self.validity is not None:
            n += self.validity.size
        if self.data2 is not None:
            n += self.data2.size * self.data2.dtype.itemsize
        return int(n)

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return False  # columns live in device HBM

    def _call(self, fn, *args, **kwargs):
        from .registry import call_function

        return call_function(fn, [self, *args], **kwargs)

    def cast(self, target_type, safe: bool = True):
        from .ops.cast import cast as _cast

        return _cast(self, target_type, safe=safe)

    def filter(self, mask):
        return self._call("filter", mask)

    def take(self, indices):
        return self._call("take", indices)

    def drop_null(self):
        return self._call("drop_null")

    def unique(self):
        return self._call("unique")

    def value_counts(self):
        return self._call("value_counts")

    def dictionary_encode(self):
        return self._call("dictionary_encode")

    def sort(self, order: str = "ascending"):
        idx = self._call("array_sort_indices", order=order)
        return self.take(idx)

    def fill_null(self, fill_value):
        return self._call("fill_null", fill_value)

    def is_null(self, nan_is_null: bool = False):
        return self._call("is_null", nan_is_null=nan_is_null)

    def is_valid(self):
        return self._call("is_valid")

    def is_nan(self):
        return self._call("is_nan")

    def index(self, value):
        return self._call("index", value=value)

    def sum(self, **kwargs):
        return self._call("sum", **kwargs)

    def equals(self, other) -> bool:
        if not isinstance(other, Column) or self.dtype != other.dtype or \
                self.length != other.length:
            return False
        return self.to_pylist() == other.to_pylist()

    def validate(self, full: bool = False):
        from .validate import validate_column

        validate_column(self)

    def tolist(self):
        return self.to_pylist()

    def to_string(self) -> str:
        return repr(self) + " " + str(self.to_pylist()[:20])

    def to_pandas(self, **kwargs):
        # through arrow so null slots become NaN/None for every type
        # (to_numpy only NaN-fills floats)
        return self.to_arrow().to_pandas()

    # ---- host conversion ----
    def to_pylist(self):
        """Rows as python objects, nulls as None (pyarrow parity)."""
        return self.to_arrow().to_pylist()

    def to_numpy(self, zero_copy_only: bool = False) -> np.ndarray:
        """Materialize to host. Nulls become NaN for floats; error for ints
        with nulls unless the caller handles the mask separately."""
        data = np.asarray(self.data)
        if (self.dtype.is_string or self.dtype.kind in ("binary", "large_binary")
                or self.dtype.is_dictionary):
            assert self.dictionary is not None
            out = self.dictionary.values[np.asarray(self.data)]
            if self.validity is not None:
                out = out.astype(object)
                out[~np.asarray(self.validity)] = None
            return out
        if self.validity is not None and self.dtype.is_floating:
            data = data.copy()
            data[~np.asarray(self.validity)] = np.nan
        return data

    def to_arrow(self):
        """Convert to a pyarrow Array (host boundary / parity checks)."""
        import pyarrow as pa

        mask = None
        if self.validity is not None:
            mask = ~np.asarray(self.validity)
            if not mask.any():
                mask = None
        if self.dtype.kind == "null":
            return pa.nulls(self.length)
        if self.dtype.is_dictionary:
            codes = np.asarray(self.data)
            if mask is not None:
                codes = np.ma.masked_array(codes, mask)
            return pa.DictionaryArray.from_arrays(
                pa.array(codes, type=dt.to_arrow(self.dtype.index_type)),
                pa.array(self.dictionary.values.tolist(),
                         type=dt.to_arrow(self.dtype.value_type)))
        if self.dtype.is_string or self.dtype.kind in ("binary", "large_binary"):
            assert self.dictionary is not None
            codes = np.asarray(self.data)
            vals = self.dictionary.values[codes]
            arr = pa.array(
                vals.tolist(), type=dt.to_arrow(self.dtype),
                mask=mask if mask is not None else None,
            )
            return arr
        if self.dtype.kind in ("decimal128", "decimal256"):
            # assemble the 16/32-byte little-endian two's-complement layout
            # (reference: util/basic_decimal.h storage) straight from the
            # limbs — avoids python Decimal contexts and pa precision
            # inference entirely
            n = self.length
            nlimb = 2 if self.dtype.kind == "decimal128" else 4
            lo = np.ascontiguousarray(np.asarray(self.data)).view(np.uint64)
            hi = np.ascontiguousarray(np.asarray(self.data2)).view(np.uint64)
            words = np.empty((n, nlimb), dtype="<u8")
            words[:, 0] = lo
            if nlimb == 2:
                words[:, 1] = hi
            else:
                words[:, 1:] = hi.reshape(n, 3)
            bufs = [None, pa.py_buffer(words.tobytes())]
            if mask is not None:
                bufs[0] = pa.py_buffer(
                    np.packbits(~mask, bitorder="little").tobytes())
            return pa.Array.from_buffers(dt.to_arrow(self.dtype), n, bufs)
        if self.dtype.kind == "month_day_nano_interval":
            n = self.length
            packed = np.asarray(self.data)
            rec = np.empty(n, dtype=[("m", "<i4"), ("d", "<i4"),
                                     ("n", "<i8")])
            rec["m"] = (packed >> 32).astype(np.int32)
            rec["d"] = (packed & 0xFFFFFFFF).astype(np.uint32).astype(
                np.int32)
            rec["n"] = np.asarray(self.data2)
            bufs = [None, pa.py_buffer(rec.tobytes())]
            if mask is not None:
                bufs[0] = pa.py_buffer(
                    np.packbits(~mask, bitorder="little").tobytes())
            return pa.Array.from_buffers(dt.to_arrow(self.dtype), n, bufs)
        if self.dtype.kind == "extension":
            from .interop import _EXT_TYPES

            storage = Column(self.data, self.dtype.value_type,
                             validity=self.validity,
                             dictionary=self.dictionary, data2=self.data2,
                             bits=self.bits).to_arrow()
            ext_t = _EXT_TYPES.get(self.dtype.unit)
            if ext_t is None:
                return storage  # unknown extension: storage-only export
            return pa.ExtensionArray.from_storage(ext_t, storage)
        data = np.asarray(self.data)
        pa_type = dt.to_arrow(self.dtype)
        if self.dtype.is_temporal:
            return pa.array(data, type=pa_type, mask=mask)
        return pa.array(data, type=pa_type, mask=mask)

    def __repr__(self):
        return (
            f"Column<{self.dtype!r}>[{self.length}]"
            + ("" if self.validity is None else " +mask")
            + ("" if self.dictionary is None else f" dict={len(self.dictionary)}")
        )


@jax.tree_util.register_pytree_node_class
class ListColumn:
    """Variable-length list column: offsets + flattened child values.

    Reference layout: variable list = [validity, offsets] + child
    (docs/source/format/Columnar.rst:104-121). On device this is exactly
    an int64 offsets array (length n+1) plus a child Column — the
    reference's layout, minus bitmap packing. Fixed-shape kernels that
    need per-row alignment use the exploded (parent_indices) view instead
    (ops/nested.py list_parent_indices).
    """

    __slots__ = ("offsets", "values", "validity", "dtype")

    def __init__(self, offsets, values: "Column", dtype: dt.DataType,
                 validity=None):
        self.offsets = offsets  # int64[n+1]
        self.values = values    # child Column (flattened)
        self.validity = validity
        self.dtype = dtype      # list_(child_type)

    def tree_flatten(self):
        return (self.offsets, self.values, self.validity), (self.dtype,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, values, validity = children
        return cls(offsets, values, aux[0], validity)

    @property
    def length(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def __len__(self):
        return self.length

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(jnp.sum(~self.validity))

    def mask(self):
        if self.validity is None:
            return jnp.ones(self.length, dtype=jnp.bool_)
        return self.validity

    def value_lengths(self) -> jnp.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    def slice(self, offset: int, length=None) -> "ListColumn":
        end = self.length if length is None else min(offset + length,
                                                     self.length)
        lo = int(self.offsets[offset])
        hi = int(self.offsets[end])
        return ListColumn(
            self.offsets[offset:end + 1] - lo,
            self.values.slice(lo, hi - lo),
            self.dtype,
            validity=None if self.validity is None
            else self.validity[offset:end])

    def mask_array(self):
        return self.mask()

    def to_2d(self):
        """[n, k] device view of a fixed_size_list column — the device-native
        form (static shape, no offsets; reference layout
        docs/source/format/Columnar.rst:124-137 minus child indirection)."""
        if self.dtype.kind != "fixed_size_list":
            raise TypeError(f"to_2d requires fixed_size_list, got {self.dtype!r}")
        if isinstance(self.values, ListColumn):
            raise TypeError("to_2d requires a fixed-width child")
        k = self.dtype.list_size
        return self.values.data.reshape(self.length, k)

    def to_arrow(self):
        import pyarrow as pa

        if self.dtype.kind == "map":
            keys = self.values.column("key").to_arrow()
            items = self.values.column("value").to_arrow()
            offsets = np.asarray(self.offsets).astype(np.int32)
            if self.validity is not None:
                mask_np = ~np.asarray(self.validity)
                offsets_arr = pa.array(
                    [None if (i < len(mask_np) and mask_np[i]) else int(o)
                     for i, o in enumerate(offsets)], type=pa.int32())
            else:
                offsets_arr = pa.array(offsets.tolist(), type=pa.int32())
            return pa.MapArray.from_arrays(offsets_arr, keys, items)

        if self.dtype.kind == "fixed_size_list":
            k = self.dtype.list_size
            child = self.values.to_arrow()
            offs = np.asarray(self.offsets)
            idx = (offs[:-1, None] + np.arange(k)[None, :]).ravel()
            taken = child.take(pa.array(idx, type=pa.int64()))
            if self.validity is not None:
                mask = pa.array(~np.asarray(self.validity))
                return pa.FixedSizeListArray.from_arrays(taken, k, mask=mask)
            return pa.FixedSizeListArray.from_arrays(taken, k)

        child = self.values.to_arrow()
        offsets = np.asarray(self.offsets).astype(np.int32)
        if self.validity is not None:
            # arrow encodes null lists via a masked offsets array
            off = pa.array(offsets.tolist(), type=pa.int32())
            mask_np = ~np.asarray(self.validity)
            mask = pa.array(np.concatenate([mask_np, [False]]).tolist())
            offsets_arr = pa.array(
                [None if m else int(o) for o, m in
                 zip(offsets, np.concatenate([mask_np, [False]]))],
                type=pa.int32())
            return pa.ListArray.from_arrays(offsets_arr, child)
        return pa.ListArray.from_arrays(
            pa.array(offsets.tolist(), type=pa.int32()), child)

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return (f"ListColumn<{self.dtype!r}>[{self.length}]"
                + ("" if self.validity is None else " +mask"))


def column(values, type: Optional[dt.DataType] = None,
           dictionary=None) -> Column:
    """Construct a Column from host data (list / numpy / jax / pyarrow).

    numpy and jax arrays go straight to the device; numpy string arrays
    are dictionary-encoded on the host. With ``dictionary`` (the host
    value pool), ``values`` are int codes into it and the column is a
    dictionary-string column. Python sequences go through pyarrow for
    type inference and null detection, the only case that imports it.
    """
    if isinstance(values, Column):
        return values
    if dictionary is not None:
        pool = dictionary if isinstance(dictionary, Dictionary) \
            else Dictionary(np.asarray(dictionary, dtype=object))
        return Column(jnp.asarray(values, dtype=jnp.int32),
                      type or dt.string, dictionary=pool)
    if isinstance(values, (np.ndarray, jax.Array)) and type is None:
        if values.ndim == 2:
            return fixed_size_list_column(values)
        if isinstance(values, jax.Array):
            return Column(values, dt.from_numpy_dtype(np.dtype(values.dtype)))
        if values.dtype.kind in "biufm":
            # NaN is a *value* in arrow semantics, not a null — keep as data.
            return Column(jnp.asarray(values),
                          dt.from_numpy_dtype(values.dtype))
        if values.dtype.kind in "US":
            uniq, codes = np.unique(values, return_inverse=True)
            return Column(jnp.asarray(codes.astype(np.int32)),
                          dt.string if values.dtype.kind == "U"
                          else dt.binary,
                          dictionary=Dictionary(uniq.astype(object)))
    import pyarrow as pa

    from . import interop

    if isinstance(values, (pa.Array, pa.ChunkedArray)):
        return interop.column_from_arrow(values)
    arr = pa.array(values, type=None if type is None else dt.to_arrow(type))
    return interop.column_from_arrow(arr)


def fixed_size_list_column(values_2d, validity=None) -> "ListColumn":
    """Fixed-size-list column from an [n, k] array — the device-idiomatic
    nested type (static shapes; every row exactly k elements). Stored as a
    ListColumn with affine offsets so every list kernel works unchanged;
    kernels that want the dense form use ``.to_2d()``.
    """
    arr = jnp.asarray(values_2d)
    if arr.ndim != 2:
        raise ValueError(f"expected [n, k] array, got shape {arr.shape}")
    n, k = arr.shape
    child = Column(arr.reshape(n * k), dt.from_numpy_dtype(np.dtype(arr.dtype)))
    offsets = jnp.arange(n + 1, dtype=jnp.int64) * k
    return ListColumn(offsets, child, dt.fixed_size_list(child.dtype, k),
                      validity=None if validity is None
                      else jnp.asarray(validity))


def nulls(length: int, type: dt.DataType) -> Column:
    """All-null column of the given length/type (reference: MakeArrayOfNull)."""
    data = jnp.zeros(length, dtype=type.physical_dtype())
    validity = jnp.zeros(length, dtype=jnp.bool_)
    dictionary = Dictionary(np.array([], dtype=object)) if type.is_binary else None
    return Column(data, type, validity=validity, dictionary=dictionary)


@jax.tree_util.register_pytree_node_class
class UnionColumn:
    """Union column: per-row type codes + child columns (reference layout:
    docs/source/format/Columnar.rst union section; type.h UnionType).

    - sparse: every child has full length; row i reads child[code_of(i)][i]
    - dense: children are compact; ``offsets[i]`` indexes into the child

    The device-native reading of a union is a *tagged select*: type_ids is a
    device int8 array, and elementwise kernels over a sparse union are a
    ``jnp.select`` over the children. Unions never carry a top-level
    validity mask (nulls live in the children), matching the reference.
    """

    __slots__ = ("type_ids", "offsets", "children", "dtype")

    def __init__(self, type_ids, children, dtype, offsets=None):
        self.type_ids = type_ids          # int8[n] device
        self.offsets = offsets            # int32[n] device (dense) | None
        self.children = tuple(children)   # child Columns
        self.dtype = dtype                # sparse_union / dense_union

    def tree_flatten(self):
        return (self.type_ids, self.offsets, self.children), (self.dtype,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        type_ids, offsets, kids = children
        return cls(type_ids, kids, aux[0], offsets=offsets)

    @property
    def length(self) -> int:
        return int(self.type_ids.shape[0])

    def __len__(self):
        return self.length

    @property
    def is_dense(self) -> bool:
        return self.dtype.kind == "dense_union"

    @property
    def null_count(self) -> int:
        """0 — unions carry no top-level validity (reference:
        array_union.cc; pyarrow UnionArray.null_count is always 0)."""
        return 0

    @property
    def logical_null_count(self) -> int:
        # a row is logically null iff its selected child value is null
        return int(jnp.sum(~self.mask()))

    def mask(self):
        codes = np.asarray(self.type_ids)
        valid = np.ones(self.length, dtype=bool)
        offs = (np.asarray(self.offsets) if self.offsets is not None
                else np.arange(self.length))
        for code, child in zip(self.dtype.type_codes, self.children):
            rows = codes == code
            if child.validity is not None and rows.any():
                child_mask = np.asarray(child.mask())
                valid[rows] = child_mask[offs[rows]]
        return jnp.asarray(valid)

    def child_of(self, code: int):
        return self.children[list(self.dtype.type_codes).index(code)]

    def slice(self, offset: int, length=None) -> "UnionColumn":
        end = self.length if length is None else min(offset + length,
                                                     self.length)
        return UnionColumn(
            self.type_ids[offset:end], self.children, self.dtype,
            offsets=None if self.offsets is None
            else self.offsets[offset:end])

    def take(self, indices) -> "UnionColumn":
        """Row gather: codes/offsets gather; dense children stay compact
        (shared), sparse children gather rowwise."""
        idx = jnp.asarray(indices)
        if self.is_dense:
            return UnionColumn(self.type_ids[idx], self.children,
                               self.dtype, offsets=self.offsets[idx])
        from .ops.selection import take_column

        kids = tuple(take_column(c, idx) for c in self.children)
        return UnionColumn(self.type_ids[idx], kids, self.dtype)

    def to_arrow(self):
        import pyarrow as pa

        names = [n for n, _ in self.dtype.fields]
        codes = list(self.dtype.type_codes)
        types = pa.array(np.asarray(self.type_ids), type=pa.int8())
        kids = [c.to_arrow() for c in self.children]
        if self.is_dense:
            offs = pa.array(np.asarray(self.offsets, dtype=np.int32),
                            type=pa.int32())
            return pa.UnionArray.from_dense(types, offs, kids, names, codes)
        return pa.UnionArray.from_sparse(types, kids, names, codes)

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return f"UnionColumn<{self.dtype!r}>[{self.length}]"


@jax.tree_util.register_pytree_node_class
class StructColumn:
    """Struct column: named child columns + optional top-level validity
    (reference layout: docs/source/format/Columnar.rst struct section —
    children + validity bitmap; no data buffer of its own).

    Anonymous structs built by kernels (make_struct) surface as
    RecordBatches; StructColumn is the *column* form so struct-typed
    fields ride batches, ingest and IPC like any other column.
    """

    __slots__ = ("children", "names", "validity", "dtype")

    def __init__(self, children, names, dtype, validity=None):
        self.children = tuple(children)
        self.names = tuple(names)
        self.validity = validity
        self.dtype = dtype

    def tree_flatten(self):
        return (self.children, self.validity), (self.names, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kids, validity = children
        return cls(kids, aux[0], aux[1], validity=validity)

    @property
    def length(self) -> int:
        return self.children[0].length if self.children else 0

    def __len__(self):
        return self.length

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(jnp.sum(~self.validity))

    def mask(self):
        if self.validity is None:
            return jnp.ones(self.length, dtype=jnp.bool_)
        return self.validity

    def field(self, key):
        if isinstance(key, int):
            return self.children[key]
        return self.children[self.names.index(key)]

    def __getitem__(self, key):
        return self.field(key)

    def slice(self, offset: int, length=None) -> "StructColumn":
        end = self.length if length is None else min(offset + length,
                                                     self.length)
        return StructColumn(
            tuple(c.slice(offset, end - offset) for c in self.children),
            self.names, self.dtype,
            validity=None if self.validity is None
            else self.validity[offset:end])

    def to_arrow(self):
        import pyarrow as pa

        arrays = [c.to_arrow() for c in self.children]
        if self.validity is not None:
            mask = pa.array(~np.asarray(self.validity))
            return pa.StructArray.from_arrays(arrays, list(self.names),
                                              mask=mask)
        return pa.StructArray.from_arrays(arrays, list(self.names))

    def to_pylist(self):
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return f"StructColumn<{self.dtype!r}>[{self.length}]"
