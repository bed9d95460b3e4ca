"""Incremental array builders: host-side append, one device transfer.

Reference: cpp/src/arrow/array/builder_base.h:49 (ArrayBuilder:
Append/AppendNull/AppendValues/Finish/Reset/Reserve) and the typed
builders (builder_primitive.h, builder_binary.h, builder_nested.h,
builder_dict.h).

Device-first stance: device arrays are immutable, so incremental building is
host work by definition. Builders accumulate into amortized-doubling
numpy buffers and `finish()` performs ONE H2D transfer — the reference's
builder->Array finalize, with the device boundary in the same place its
mutable-buffer -> immutable-Array boundary sits. Strings finish into the
engine's dictionary-encoded representation (SURVEY.md §7: encode at
ingest, operate on codes).
"""

from __future__ import annotations

from decimal import Decimal
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from . import dtypes as dt
from .column import Column, Dictionary, ListColumn, StructColumn
from .errors import Invalid

__all__ = [
    "ArrayBuilder", "BooleanBuilder", "Int8Builder", "Int16Builder",
    "Int32Builder", "Int64Builder", "UInt8Builder", "UInt16Builder",
    "UInt32Builder", "UInt64Builder", "Float32Builder", "Float64Builder",
    "StringBuilder", "BinaryBuilder", "Decimal128Builder",
    "Decimal256Builder", "ListBuilder",
    "StructBuilder", "DictionaryBuilder", "builder_for",
]

_MIN_CAP = 32


class ArrayBuilder:
    """Common surface (builder_base.h:49)."""

    def __len__(self) -> int:
        return self._length

    @property
    def null_count(self) -> int:
        return self._null_count

    def append(self, value) -> "ArrayBuilder":
        raise NotImplementedError

    def append_null(self) -> "ArrayBuilder":
        raise NotImplementedError

    def append_values(self, values, valid=None) -> "ArrayBuilder":
        """Bulk append; `valid` is an optional bool sequence."""
        if valid is None:
            for v in values:
                self.append_null() if v is None else self.append(v)
        else:
            for v, ok in zip(values, valid):
                self.append(v) if ok else self.append_null()
        return self

    def extend(self, values):
        return self.append_values(values)

    def finish(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class _PrimitiveBuilder(ArrayBuilder):
    """Doubling numpy buffer + lazily allocated validity buffer."""

    _np_dtype: np.dtype
    _dtype: dt.DataType

    def __init__(self):
        self.reset()

    def reset(self):
        if getattr(self, "_pool", None) is None:
            # pin ONE pool for this builder's lifetime: frees always land
            # where the allocates were counted
            from .memory import default_memory_pool

            self._pool = default_memory_pool()
        if getattr(self, "_buf", None) is not None:
            self._pool.free(self._buf.nbytes)
        self._buf = np.empty(_MIN_CAP, dtype=self._np_dtype)
        self._pool.allocate(self._buf.nbytes)
        self._valid: Optional[np.ndarray] = None
        self._length = 0
        self._null_count = 0

    def __del__(self):
        buf = getattr(self, "_buf", None)
        pool = getattr(self, "_pool", None)
        if buf is not None and pool is not None:
            pool.free(buf.nbytes)

    def reserve(self, n: int):
        need = self._length + n
        if need > len(self._buf):
            cap = max(len(self._buf) * 2, need)
            old = self._buf.nbytes
            self._buf = np.resize(self._buf, cap)
            self._pool.allocate(self._buf.nbytes - old)
            if self._valid is not None:
                v = np.ones(cap, dtype=bool)
                v[:self._length] = self._valid[:self._length]
                self._valid = v
        return self

    def _ensure(self, n: int = 1):
        if self._length + n > len(self._buf):
            self.reserve(max(n, len(self._buf)))

    def append(self, value):
        self._ensure()
        self._buf[self._length] = value
        if self._valid is not None:
            self._valid[self._length] = True
        self._length += 1
        return self

    def append_null(self):
        self._ensure()
        if self._valid is None:
            self._valid = np.ones(len(self._buf), dtype=bool)
        self._buf[self._length] = self._null_sentinel()
        self._valid[self._length] = False
        self._length += 1
        self._null_count += 1
        return self

    def _null_sentinel(self):
        return 0

    def append_values(self, values, valid=None):
        if valid is None and isinstance(values, np.ndarray):
            n = len(values)
            self._ensure(n)
            self._buf[self._length:self._length + n] = values
            if self._valid is not None:
                self._valid[self._length:self._length + n] = True
            self._length += n
            return self
        return super().append_values(values, valid)

    def finish(self) -> Column:
        data = np.ascontiguousarray(self._buf[:self._length])
        validity = (jnp.asarray(self._valid[:self._length])
                    if self._null_count else None)
        bits = (jnp.asarray(data.view(np.int64))
                if data.dtype == np.float64 else None)
        col = Column(jnp.asarray(data), self._dtype, validity=validity,
                     bits=bits)
        self.reset()
        return col


def _make_primitive(name, np_dtype, a1t_dtype, sentinel=0):
    cls = type(name, (_PrimitiveBuilder,), {
        "_np_dtype": np.dtype(np_dtype),
        "_dtype": a1t_dtype,
        "_null_sentinel": lambda self: sentinel,
    })
    return cls


BooleanBuilder = _make_primitive("BooleanBuilder", np.bool_, dt.bool_,
                                 False)
Int8Builder = _make_primitive("Int8Builder", np.int8, dt.int8)
Int16Builder = _make_primitive("Int16Builder", np.int16, dt.int16)
Int32Builder = _make_primitive("Int32Builder", np.int32, dt.int32)
Int64Builder = _make_primitive("Int64Builder", np.int64, dt.int64)
UInt8Builder = _make_primitive("UInt8Builder", np.uint8, dt.uint8)
UInt16Builder = _make_primitive("UInt16Builder", np.uint16, dt.uint16)
UInt32Builder = _make_primitive("UInt32Builder", np.uint32, dt.uint32)
UInt64Builder = _make_primitive("UInt64Builder", np.uint64, dt.uint64)
Float32Builder = _make_primitive("Float32Builder", np.float32,
                                 dt.float32, 0.0)
Float64Builder = _make_primitive("Float64Builder", np.float64,
                                 dt.float64, 0.0)


class StringBuilder(ArrayBuilder):
    """builder_binary.h StringBuilder — finishes into the engine's
    dictionary-encoded string Column (codes on device, uniques host-side)."""

    _coerce = staticmethod(str)
    _dtype = dt.string

    def __init__(self):
        self.reset()

    def reset(self):
        self._values: List[object] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        self._values.append(self._coerce(value))
        self._length += 1
        return self

    def append_null(self):
        self._values.append(None)
        self._length += 1
        self._null_count += 1
        return self

    def finish(self) -> Column:
        arr = np.array([v if v is not None else "" for v in self._values],
                       dtype=object)
        uniques, codes = np.unique(arr.astype(str), return_inverse=True)
        validity = None
        if self._null_count:
            validity = jnp.asarray(
                np.array([v is not None for v in self._values]))
        col = Column(jnp.asarray(codes.astype(np.int32)), self._dtype,
                     validity=validity,
                     dictionary=Dictionary(uniques.astype(object)))
        self.reset()
        return col


class BinaryBuilder(StringBuilder):
    _coerce = staticmethod(bytes)
    _dtype = dt.binary

    def finish(self) -> Column:
        vals = self._values
        uniq = sorted({v for v in vals if v is not None})
        index = {v: i for i, v in enumerate(uniq)}
        codes = np.array([index.get(v, 0) for v in vals], dtype=np.int32)
        validity = None
        if self._null_count:
            validity = jnp.asarray(np.array([v is not None for v in vals]))
        col = Column(jnp.asarray(codes), self._dtype, validity=validity,
                     dictionary=Dictionary(np.array(uniq or [b""],
                                                    dtype=object)))
        self.reset()
        return col


class Decimal128Builder(ArrayBuilder):
    """builder_decimal.h — two int64 limbs (low in data, high in data2)."""

    def __init__(self, dtype: dt.DataType):
        if dtype.kind != "decimal128":
            raise Invalid(f"Decimal128Builder needs a decimal128 dtype, "
                          f"got {dtype}")
        self._dtype = dtype
        self.reset()

    def reset(self):
        self._lo: List[int] = []
        self._hi: List[int] = []
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        if isinstance(value, Decimal):
            # default 28-digit context truncates large unscaled values
            from decimal import Context

            ctx = Context(prec=40)
            unscaled = int(value.scaleb(self._dtype.scale, context=ctx)
                           .to_integral_exact(context=ctx))
        else:
            unscaled = int(value)
        lo = unscaled & ((1 << 64) - 1)
        hi = unscaled >> 64
        self._lo.append(lo - (1 << 64) if lo >= 1 << 63 else lo)
        self._hi.append(hi)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._lo.append(0)
        self._hi.append(0)
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def finish(self) -> Column:
        validity = (jnp.asarray(np.array(self._valid))
                    if self._null_count else None)
        col = Column(jnp.asarray(np.array(self._lo, dtype=np.int64)),
                     self._dtype, validity=validity,
                     data2=jnp.asarray(np.array(self._hi, dtype=np.int64)))
        self.reset()
        return col


class Decimal256Builder(ArrayBuilder):
    """Four int64 limbs: limb0 in data, limbs 1..3 in data2[n, 3]
    (the decimal256 storage layout, interop.py)."""

    def __init__(self, dtype: dt.DataType):
        if dtype.kind != "decimal256":
            raise Invalid(f"Decimal256Builder needs a decimal256 dtype, "
                          f"got {dtype}")
        self._dtype = dtype
        self.reset()

    def reset(self):
        self._limbs: List[List[int]] = [[], [], [], []]
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def _push(self, unscaled: int):
        for j in range(4):
            limb = (unscaled >> (64 * j)) & ((1 << 64) - 1)
            self._limbs[j].append(
                limb - (1 << 64) if limb >= 1 << 63 else limb)

    def append(self, value):
        if isinstance(value, Decimal):
            from decimal import Context

            ctx = Context(prec=80)
            unscaled = int(value.scaleb(self._dtype.scale, context=ctx)
                           .to_integral_exact(context=ctx))
        else:
            unscaled = int(value)
        self._push(unscaled)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._push(0)
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def finish(self) -> Column:
        validity = (jnp.asarray(np.array(self._valid))
                    if self._null_count else None)
        data = jnp.asarray(np.array(self._limbs[0], dtype=np.int64))
        data2 = jnp.asarray(np.stack(
            [np.array(l, dtype=np.int64) for l in self._limbs[1:]],
            axis=-1)) if self._length else \
            jnp.zeros((0, 3), jnp.int64)
        col = Column(data, self._dtype, validity=validity, data2=data2)
        self.reset()
        return col


class ListBuilder(ArrayBuilder):
    """builder_nested.h ListBuilder: offsets + child builder."""

    def __init__(self, value_builder: ArrayBuilder):
        self._child = value_builder
        self.reset()

    def reset(self):
        self._offsets = [0]
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        """append(list) appends a whole row. For the C++ Append() +
        child->Append pattern, feed `values` directly then close_row()."""
        for v in value:
            if v is None:
                self._child.append_null()
            else:
                self._child.append(v)
        self._offsets.append(len(self._child))
        self._valid.append(True)
        self._length += 1
        return self

    @property
    def values(self) -> ArrayBuilder:
        return self._child

    def close_row(self):
        """Seal the current row after feeding `values` directly."""
        self._offsets.append(len(self._child))
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._offsets.append(len(self._child))
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def finish(self) -> ListColumn:
        child = self._child.finish()
        # rows sealed via append(list)/append_null record offsets eagerly;
        # close_row() uses the child length at seal time — both agree
        offsets = jnp.asarray(np.array(self._offsets, dtype=np.int64))
        validity = (jnp.asarray(np.array(self._valid))
                    if self._null_count else None)
        col = ListColumn(offsets, child, dt.list_(child.dtype),
                         validity=validity)
        self.reset()
        return col


class StructBuilder(ArrayBuilder):
    """builder_nested.h StructBuilder: one child builder per field."""

    def __init__(self, names: List[str], builders: List[ArrayBuilder]):
        if len(names) != len(builders):
            raise Invalid("StructBuilder: names/builders length mismatch")
        self._names = list(names)
        self._children = list(builders)
        self.reset()

    def reset(self):
        for b in getattr(self, "_children", ()):
            b.reset()
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value: dict):
        for name, b in zip(self._names, self._children):
            v = value.get(name)
            b.append_null() if v is None else b.append(v)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        for b in self._children:
            b.append_null()
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def finish(self) -> StructColumn:
        children = [b.finish() for b in self._children]
        validity = (jnp.asarray(np.array(self._valid))
                    if self._null_count else None)
        fields = [(n, c.dtype) for n, c in zip(self._names, children)]
        col = StructColumn(children, self._names, dt.struct(fields),
                           validity=validity)
        self.reset()
        return col


class DictionaryBuilder(ArrayBuilder):
    """builder_dict.h: explicit memoizing builder — append values, get a
    dictionary-encoded column with first-appearance code order."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._index = {}
        self._uniques: List[object] = []
        self._codes: List[int] = []
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        code = self._index.get(value)
        if code is None:
            code = self._index[value] = len(self._uniques)
            self._uniques.append(value)
        self._codes.append(code)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._codes.append(0)
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    @property
    def dictionary_length(self) -> int:
        return len(self._uniques)

    def finish(self) -> Column:
        validity = (jnp.asarray(np.array(self._valid))
                    if self._null_count else None)
        # dtype from the appended values (the reference's builder is
        # typed per value type); bytes -> binary, else string
        is_bytes = any(isinstance(u, (bytes, bytearray))
                       for u in self._uniques)
        if self._uniques and not all(
                isinstance(u, (str, bytes, bytearray))
                for u in self._uniques):
            raise Invalid("DictionaryBuilder: values must be str or "
                          "bytes")
        col = Column(
            jnp.asarray(np.array(self._codes, dtype=np.int32)),
            dt.binary if is_bytes else dt.string,
            validity=validity,
            dictionary=Dictionary(np.array(self._uniques or [""],
                                           dtype=object)))
        self.reset()
        return col


_BY_DTYPE = {
    dt.bool_: BooleanBuilder, dt.int8: Int8Builder, dt.int16: Int16Builder,
    dt.int32: Int32Builder, dt.int64: Int64Builder, dt.uint8: UInt8Builder,
    dt.uint16: UInt16Builder, dt.uint32: UInt32Builder,
    dt.uint64: UInt64Builder, dt.float32: Float32Builder,
    dt.float64: Float64Builder, dt.string: StringBuilder,
    dt.binary: BinaryBuilder,
}


def builder_for(dtype: dt.DataType) -> ArrayBuilder:
    """MakeBuilder analogue (builder_base.cc): a builder for `dtype`."""
    if dtype.kind == "decimal128":
        return Decimal128Builder(dtype)
    if dtype.kind == "decimal256":
        return Decimal256Builder(dtype)
    if dtype.kind == "list":
        return ListBuilder(builder_for(dtype.fields[0][1]))
    b = _BY_DTYPE.get(dtype)
    if b is None:
        raise Invalid(f"no builder for dtype {dtype}")
    return b()
